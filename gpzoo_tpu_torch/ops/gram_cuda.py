"""L-batched RBF Gram on Hopper: kernel 3 of the port.

Ports ``gpzoo_tpu/ops/gram_pallas.py`` ``rbf_gram``. :func:`rbf_gram_fwd`
launches ``csrc/gram.cu`` ``rbf_gram_f32`` for CUDA tensors (its
``launches`` counts them) and takes :func:`rbf_gram_plain`, the expanded
squared-distance form of ``kernels/rbf.py``, for CPU tensors. The two
agree up to float rounding of d² near d = 0 (the kernel forms d² directly
from the coordinates) and of the exponential (the kernel takes
2^(scale·d²) with log₂e folded into scale = −½log₂e/ℓ²). The kernel's
entry point owns its tile plan and its shape limits (D ≤ 8, N and M
inside int range) and refuses other shapes before it launches.

:class:`RBFGram` adds the backward of ``gram_pallas._rbf_gram_bwd``:
:func:`rbf_gram_bwd` launches ``rbf_gram_bwd_f32`` for CUDA tensors (its
own ``launches``), one kernel that reads the cotangent and the forward's k
once, sums its partials in a fixed order in the blocks that finish last,
and writes only the gradients asked for; it takes the closed form
:func:`rbf_gram_bwd_plain` for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gpzoo_tpu_torch.ops import _build
from gpzoo_tpu_torch.ops.distance import squared_dist

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_REFUSED = 1  # cudaErrorInvalidValue: the entry point does not take the shape


def rbf_gram_plain(x, z, sigma, lengthscale):
    """(L, N, M) σ_l² exp(−½‖x_n − z_m‖²/ℓ_l²) from the expanded,
    clamped squared distance; sigma and lengthscale are (L,)."""
    d2 = squared_dist(x, z)
    scale = -0.5 / torch.square(lengthscale)
    return torch.square(sigma)[:, None, None] * torch.exp(d2 * scale[:, None, None])


def rbf_gram_bwd_plain(g, x, z, sigma, lengthscale, k, needs=(True,) * 4):
    """(dx, dz, dσ, dℓ) of ``sum(g · k)``, k = :func:`rbf_gram_plain` (x, z,
    σ, ℓ) as the forward returned it, in closed form (recomputing d² rather
    than storing it), None where ``needs`` (four flags, in that order) is
    false:

        dσ_l = 2 Σ g·k / σ_l,   dℓ_l = Σ g·k·d² / ℓ_l³,
        dx = w z − rowsum(w) x, dz = wᵀx − colsum(w) z,  w = Σ_l g·k/ℓ_l².
    """
    need_x, need_z, need_s, need_l = needs
    gk = g * k
    inv_ell2 = 1.0 / torch.square(lengthscale)
    d_sigma = 2.0 * gk.sum(dim=(1, 2)) / sigma if need_s else None
    d_ell = (torch.einsum("lnm,nm->l", gk, squared_dist(x, z)) * inv_ell2 / lengthscale
             if need_l else None)
    dx = dz = None
    if need_x or need_z:
        w = torch.einsum("lnm,l->nm", gk, inv_ell2)
        dx = w @ z - w.sum(dim=1, keepdim=True) * x if need_x else None
        dz = w.T @ x - w.sum(dim=0)[:, None] * z if need_z else None
    return dx, dz, d_sigma, d_ell


@functools.cache
def _kernel(name="rbf_gram_f32", argtypes=tuple(_ARGTYPES), restype=ctypes.c_int):
    fn = getattr(_build.library("gram"), name)
    fn.argtypes, fn.restype = list(argtypes), restype
    return fn


@functools.lru_cache(maxsize=64)
def _bwd_sizes(device_index, *shape):
    """(scratch floats, counters) of the backward for shape (N, M, D, L) on
    that device (its plan depends on the device's SM count), -1 if refused."""
    with torch.cuda.device(device_index):
        return tuple(_kernel(f"rbf_gram_bwd_{what}", (ctypes.c_int,) * 4,
                             ctypes.c_longlong)(*shape) for what in ("scratch", "counters"))


def _check(x, z, sigma, lengthscale):
    if x.ndim != 2 or z.ndim != 2 or x.shape[1] != z.shape[1]:
        raise ValueError(f"x (N, D) and z (M, D) expected, got "
                         f"{tuple(x.shape)} and {tuple(z.shape)}")
    if sigma.ndim != 1 or sigma.shape != lengthscale.shape:
        raise ValueError("sigma and lengthscale must both be (L,)")


def rbf_gram_fwd(x, z, sigma, lengthscale):
    """(L, N, M) RBF Gram: kernel 3 on CUDA, :func:`rbf_gram_plain` on CPU.
    x (N, D), z (M, D) with D ≤ 8; sigma, lengthscale (L,)."""
    _check(x, z, sigma, lengthscale)
    if x.device.type == "cpu":
        return rbf_gram_plain(x, z, sigma, lengthscale)
    (n, dim), m, l_dim = x.shape, z.shape[0], sigma.shape[0]
    _build.check_operands("rbf_gram", x=x, z=z, sigma=sigma, lengthscale=lengthscale)
    out = torch.empty((l_dim, n, m), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _kernel()(x.data_ptr(), z.data_ptr(), sigma.data_ptr(),
                       lengthscale.data_ptr(), out.data_ptr(), n, m, dim, l_dim, stream)
    if status == _REFUSED:
        raise ValueError(f"rbf_gram: unsupported shape L={l_dim}, N={n}, M={m}, "
                         f"D={dim}")
    _build.check(status, "rbf_gram_f32")
    rbf_gram_fwd.launches += 1
    return out


rbf_gram_fwd.launches = 0


def rbf_gram_bwd(g, x, z, sigma, lengthscale, k, needs=(True,) * 4):
    """(dx, dz, dσ, dℓ) for the cotangent g and the forward's k, both
    (L, N, M), None where ``needs`` is false: kernel 3's backward on CUDA
    (one launch; g is read in place when contiguous or, as a column-major
    solve's gradient arrives, with each plane transposed; any other g, or
    one not 16-byte aligned, is copied first, counted in ``copies``),
    :func:`rbf_gram_bwd_plain` on CPU."""
    _check(x, z, sigma, lengthscale)
    (n, dim), m, l_dim = x.shape, z.shape[0], sigma.shape[0]
    for t, what in ((g, "g"), (k, "k")):
        if tuple(t.shape) != (l_dim, n, m):
            raise ValueError(f"{what} must be (L, N, M) = {(l_dim, n, m)}, "
                             f"got {tuple(t.shape)}")
    if x.device.type == "cpu":
        return rbf_gram_bwd_plain(g, x, z, sigma, lengthscale, k, needs)
    if not any(needs):
        return (None,) * 4
    transposed = not g.is_contiguous() and g.mT.is_contiguous()
    if not (g.is_contiguous() or transposed):
        g = g.contiguous()
        rbf_gram_bwd.copies += 1
    _build.check_operands("rbf_gram_bwd", x=x, z=z, sigma=sigma, lengthscale=lengthscale,
                          g=g.mT if transposed else g, k=k)
    if g.data_ptr() % 16 or k.data_ptr() % 16:  # the kernel's vector loads
        g, k = g.clone(), k.clone()
        rbf_gram_bwd.copies += 1
    floats, counts = _bwd_sizes(x.device.index, n, m, dim, l_dim)
    if floats < 0:
        raise ValueError(f"rbf_gram_bwd: unsupported shape L={l_dim}, N={n}, M={m}, "
                         f"D={dim}")
    need_x, need_z, need_s, need_l = needs
    dx = torch.empty_like(x) if need_x else None
    dz = torch.empty_like(z) if need_z else None
    scratch = x.new_empty((2 * l_dim + floats,))  # (dσ, dℓ), then the block partials
    hyper = scratch[:2 * l_dim].view(2, l_dim) if need_s or need_l else None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    counters = _build.tickets(x.device, counts, "rbf_gram_bwd")
    status = _kernel("rbf_gram_bwd_f32", tuple(_BWD_ARGTYPES))(
        g.data_ptr(), k.data_ptr(), x.data_ptr(), z.data_ptr(), sigma.data_ptr(),
        lengthscale.data_ptr(), *(None if t is None else t.data_ptr()
                                  for t in (dx, dz, hyper)),
        scratch[2 * l_dim:].data_ptr(), counters.data_ptr(), n, m, dim, l_dim,
        int(transposed), stream)
    if status == _REFUSED:
        raise ValueError(f"rbf_gram_bwd: unsupported shape L={l_dim}, N={n}, M={m}, "
                         f"D={dim}")
    _build.check(status, "rbf_gram_bwd_f32")
    rbf_gram_bwd.launches += 1
    return (dx, dz, hyper[0] if need_s else None, hyper[1] if need_l else None)


rbf_gram_bwd.launches = 0
rbf_gram_bwd.copies = 0


class RBFGram(torch.autograd.Function):
    """Differentiable RBF Gram; the backward is :func:`rbf_gram_bwd`
    (kernel 3's backward on CUDA, the closed form on CPU), which reads the
    forward's k and recomputes d² rather than storing it."""

    @staticmethod
    def forward(ctx, x, z, sigma, lengthscale):
        k = rbf_gram_fwd(x, z, sigma, lengthscale)
        ctx.save_for_backward(x, z, sigma, lengthscale, k)
        return k

    @staticmethod
    def backward(ctx, g):
        x, z, sigma, lengthscale, k = ctx.saved_tensors
        return rbf_gram_bwd(g, x, z, sigma, lengthscale, k, ctx.needs_input_grad[:4])


def rbf_gram(x, z, sigma, lengthscale):
    """Differentiable (L, N, M) RBF Gram; sigma, lengthscale (L,)."""
    return RBFGram.apply(x, z, sigma, lengthscale)
