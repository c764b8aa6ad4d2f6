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
:class:`BlockConditional` adds the backward of ``vnngp_pallas._bwd``:
autograd of the plain form, recomputed.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gpzoo_tpu_torch.ops import _build
from gpzoo_tpu_torch.ops.linalg import add_jitter

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int,
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
def _kernel():
    fn = _build.library("vnngp").block_conditional_f32
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def block_conditional_fwd(kzz, s, kxz, mu, kxx, jitter):
    """(mean (n,), cov (n,)) of the per-point conditioning: kernel 5 on
    CUDA, :func:`block_conditional_plain` on CPU. kzz, s (n, K, K);
    kxz, mu (n, K); kxx (n,); K ≤ 16 on CUDA."""
    n, k = _check(kzz, s, kxz, mu, kxx)
    if kzz.device.type == "cpu":
        return block_conditional_plain(kzz, s, kxz, mu, kxx, jitter)
    if kzz.device.type != "cuda":
        raise ValueError(f"block_conditional: no kernel for device {kzz.device}")
    for t, what in ((kzz, "kzz"), (s, "s"), (kxz, "kxz"), (mu, "mu"),
                    (kxx, "kxx")):
        if t.device != kzz.device:
            raise ValueError(f"block_conditional: {what} must be on {kzz.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"block_conditional: {what} must be float32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"block_conditional: {what} must be contiguous")
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


class BlockConditional(torch.autograd.Function):
    """Differentiable per-point conditioning. The forward is kernel 5 (the
    plain form on CPU); the backward recomputes the plain form and takes
    its autograd gradient, as the JAX package's custom VJP does."""

    @staticmethod
    def forward(ctx, kzz, s, kxz, mu, kxx, jitter):
        ctx.save_for_backward(kzz, s, kxz, mu, kxx)
        ctx.jitter = jitter
        return block_conditional_fwd(kzz, s, kxz, mu, kxx, jitter)

    @staticmethod
    def backward(ctx, g_mean, g_cov):
        inputs = [t.detach().requires_grad_(need) for t, need
                  in zip(ctx.saved_tensors, ctx.needs_input_grad[:5])]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            mean, cov = block_conditional_plain(*inputs, ctx.jitter)
            grads = iter(torch.autograd.grad((mean, cov), wanted,
                                             (g_mean, g_cov)))
        return (*(next(grads) if t.requires_grad else None for t in inputs),
                None)


def block_conditional(kzz, s, kxz, mu, kxx, jitter):
    """Differentiable (mean, cov); see :func:`block_conditional_fwd`."""
    return BlockConditional.apply(kzz, s, kxz, mu, kxx, jitter)
