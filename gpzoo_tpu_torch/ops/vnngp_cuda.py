"""VNNGP's per-point K×K conditioning on Hopper: kernel 5 of the port.

Ports ``gpzoo_tpu/ops/vnngp_pallas.py`` ``block_conditional``. For each
point n, with blocks = kzz_n + jitter·I,

    w = blocks⁻¹ kxz_n,   mean = w·μ_n,   cov = kxx_n + w (s_n − blocks) wᵀ.

kzz arrives without the block jitter and the jitter is added twice, to
the diagonal that is factored and to the one that is subtracted: the
callers' kzz already carries the Kzz jitter, so the blocks condition on
Kzz + 2·jitter·I while cov subtracts the same jittered blocks (the JAX
package replicates this from its reference).

:func:`block_conditional_fwd` launches ``csrc/vnngp.cu``
``block_conditional_f32`` for CUDA tensors (its ``launches`` counts
them) and takes :func:`block_conditional_plain`, the batched Cholesky
form of ``vnngp_pallas._xla_reference``, for CPU tensors.
:class:`BlockConditional` adds the backward of ``vnngp_pallas._bwd`` (the
vjp of ``_xla_reference``) in closed form: :func:`block_conditional_bwd`
launches ``block_conditional_bwd_f32`` for CUDA tensors (its own
``launches``) and takes :func:`block_conditional_bwd_plain` for CPU
tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gpzoo_tpu_torch.ops import _build
from gpzoo_tpu_torch.ops.linalg import add_jitter

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_float, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_longlong, ctypes.c_int,
                                          ctypes.c_float, ctypes.c_void_p])
MAX_K = 16  # neighbour counts the kernel is instantiated for


def block_conditional_plain(kzz, s, kxz, mu, kxx, jitter):
    """(mean, cov) of the per-point conditioning: kzz, s (..., n, K, K);
    kxz, mu (..., n, K); kxx (..., n)."""
    blocks = add_jitter(kzz, jitter)
    chol = torch.linalg.cholesky(blocks)
    w = torch.cholesky_solve(kxz[..., None], chol)[..., 0]
    mean = torch.sum(w * mu, dim=-1)
    wd = torch.einsum("...k,...kj->...j", w, s - blocks)
    cov = kxx + torch.sum(wd * w, dim=-1)
    return mean, cov


def block_conditional_bwd_plain(kzz, s, kxz, mu, g_mean, g_cov, jitter,
                                needs=(True,) * 5):
    """(dkzz, ds, dkxz, dmu, dkxx) of the per-point conditioning for the
    cotangents g_mean, g_cov (..., n) of (mean, cov), in closed form, None
    where ``needs`` (five flags, in that order) is false. With B = kzz +
    jitter·I, w = B⁻¹kxz and diff = s − B: dw = ḡ_mean·μ + ḡ_cov·(diff +
    diffᵀ)w, v = B⁻¹dw; dkzz = −½(vwᵀ + wvᵀ) − ḡ_cov·wwᵀ (the Cholesky's
    symmetrized gradient, then the subtracted B), ds = ḡ_cov·wwᵀ, dkxz = v,
    dmu = ḡ_mean·w and dkxx = ḡ_cov: the vjp of :func:`block_conditional_plain`
    and of ``vnngp_pallas._xla_reference``."""
    need_kzz, need_s, need_kxz, need_mu, need_kxx = needs
    blocks = add_jitter(kzz, jitter)
    chol = torch.linalg.cholesky(blocks)
    w = torch.cholesky_solve(kxz[..., None], chol)[..., 0]
    gm, gc = g_mean[..., None], g_cov[..., None]
    ww = w[..., :, None] * w[..., None, :]
    dkzz = dkxz = None
    if need_kzz or need_kxz:
        diff = s - blocks
        dw = gm * mu + gc * ((diff + diff.mT) @ w[..., None])[..., 0]
        v = torch.cholesky_solve(dw[..., None], chol)[..., 0]
        if need_kzz:
            dkzz = (-0.5 * (v[..., :, None] * w[..., None, :] + w[..., :, None] * v[..., None, :])
                    - gc[..., None] * ww)
        dkxz = v if need_kxz else None
    return (dkzz, gc[..., None] * ww if need_s else None, dkxz,
            gm * w if need_mu else None, g_cov if need_kxx else None)


def _check(kzz, s, kxz, mu, kxx):
    if kzz.ndim != 3 or kzz.shape[1] != kzz.shape[2]:
        raise ValueError(f"kzz must be (n, K, K), got {tuple(kzz.shape)}")
    n, k = kzz.shape[0], kzz.shape[1]
    for t, shape, what in ((s, (n, k, k), "s"), (kxz, (n, k), "kxz"),
                           (mu, (n, k), "mu"), (kxx, (n,), "kxx")):
        if tuple(t.shape) != shape:
            raise ValueError(f"{what} must be {shape}, got {tuple(t.shape)}")
    return n, k


@functools.cache
def _kernel(name="block_conditional_f32", argtypes=tuple(_ARGTYPES)):
    fn = getattr(_build.library("vnngp"), name)
    fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
    return fn


def block_conditional_fwd(kzz, s, kxz, mu, kxx, jitter):
    """(mean (n,), cov (n,)) of the per-point conditioning: kernel 5 on
    CUDA, :func:`block_conditional_plain` on CPU. kzz, s (n, K, K);
    kxz, mu (n, K); kxx (n,); K ≤ 16 on CUDA."""
    n, k = _check(kzz, s, kxz, mu, kxx)
    if kzz.device.type == "cpu":
        return block_conditional_plain(kzz, s, kxz, mu, kxx, jitter)
    if kzz.device.type != "cuda":  # refused as a device before any dtype
        raise ValueError(f"block_conditional: no kernel for device {kzz.device}")
    _build.check_operands("block_conditional", kzz=kzz, s=s, kxz=kxz, mu=mu, kxx=kxx)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"block_conditional: K={k} outside 1..{MAX_K}")
    mean = torch.empty((n,), dtype=kzz.dtype, device=kzz.device)
    cov = torch.empty_like(mean)
    stream = torch.cuda.current_stream(kzz.device).cuda_stream
    _build.check(_kernel()(kzz.data_ptr(), s.data_ptr(), kxz.data_ptr(), mu.data_ptr(),
                           kxx.data_ptr(), mean.data_ptr(), cov.data_ptr(), n, k,
                           float(jitter), stream),
                 "block_conditional_f32")
    block_conditional_fwd.launches += 1
    return mean, cov


block_conditional_fwd.launches = 0


def block_conditional_bwd(kzz, s, kxz, mu, g_mean, g_cov, jitter, needs=(True,) * 5):
    """(dkzz, ds, dkxz, dmu, dkxx) for the cotangents g_mean, g_cov (n,),
    None where ``needs`` is false: kernel 5's backward on CUDA (launched
    once for any of the first four; dkxx is g_cov itself),
    :func:`block_conditional_bwd_plain` on CPU. kzz, s (n, K, K); kxz, mu
    (n, K); K ≤ 16 on CUDA."""
    n, k = _check(kzz, s, kxz, mu, g_cov)
    if tuple(g_mean.shape) != (n,):
        raise ValueError(f"g_mean must be {(n,)}, got {tuple(g_mean.shape)}")
    if kzz.device.type == "cpu":
        return block_conditional_bwd_plain(kzz, s, kxz, mu, g_mean, g_cov, jitter, needs)
    _build.check_operands("block_conditional_bwd", kzz=kzz, s=s, kxz=kxz, mu=mu,
                          g_mean=g_mean, g_cov=g_cov)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"block_conditional_bwd: K={k} outside 1..{MAX_K}")
    outs = [torch.empty_like(t) if need else None
            for t, need in zip((kzz, s, kxz, mu), needs[:4])]
    if any(needs[:4]):
        stream = torch.cuda.current_stream(kzz.device).cuda_stream
        _build.check(_kernel("block_conditional_bwd_f32", tuple(_BWD_ARGTYPES))(
            kzz.data_ptr(), s.data_ptr(), kxz.data_ptr(), mu.data_ptr(), g_mean.data_ptr(),
            g_cov.data_ptr(), *(None if t is None else t.data_ptr() for t in outs), n, k,
            float(jitter), stream), "block_conditional_bwd_f32")
        block_conditional_bwd.launches += 1
    return (*outs, g_cov if needs[4] else None)


block_conditional_bwd.launches = 0


class BlockConditional(torch.autograd.Function):
    """Differentiable per-point conditioning. The forward is kernel 5 (the
    plain form on CPU); the backward is :func:`block_conditional_bwd`, the
    closed form of the JAX package's custom VJP (its kernel on CUDA)."""

    @staticmethod
    def forward(ctx, kzz, s, kxz, mu, kxx, jitter):
        ctx.save_for_backward(kzz, s, kxz, mu)
        ctx.jitter = jitter
        return block_conditional_fwd(kzz, s, kxz, mu, kxx, jitter)

    @staticmethod
    def backward(ctx, g_mean, g_cov):
        needs = ctx.needs_input_grad[:5]
        if not any(needs):
            return (None,) * 6
        return (*block_conditional_bwd(*ctx.saved_tensors, g_mean.contiguous(),
                                       g_cov.contiguous(), ctx.jitter, needs), None)


def block_conditional(kzz, s, kxz, mu, kxx, jitter):
    """Differentiable (mean, cov); see :func:`block_conditional_fwd`."""
    return BlockConditional.apply(kzz, s, kxz, mu, kxx, jitter)
