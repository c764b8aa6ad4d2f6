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

:class:`RBFGram` adds the closed-form backward of
``gram_pallas._rbf_gram_bwd`` in plain PyTorch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gpzoo_tpu_torch.ops import _build
from gpzoo_tpu_torch.ops.distance import squared_dist

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_REFUSED = 1  # cudaErrorInvalidValue: the entry point does not take the shape


def rbf_gram_plain(x, z, sigma, lengthscale):
    """(L, N, M) σ_l² exp(−½‖x_n − z_m‖²/ℓ_l²) from the expanded,
    clamped squared distance; sigma and lengthscale are (L,)."""
    d2 = squared_dist(x, z)
    scale = -0.5 / torch.square(lengthscale)
    return torch.square(sigma)[:, None, None] * torch.exp(d2 * scale[:, None, None])


@functools.cache
def _kernel():
    fn = _build.library("gram").rbf_gram_f32
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def rbf_gram_fwd(x, z, sigma, lengthscale):
    """(L, N, M) RBF Gram: kernel 3 on CUDA, :func:`rbf_gram_plain` on CPU.
    x (N, D), z (M, D) with D ≤ 8; sigma, lengthscale (L,)."""
    if x.ndim != 2 or z.ndim != 2 or x.shape[1] != z.shape[1]:
        raise ValueError(f"x (N, D) and z (M, D) expected, got "
                         f"{tuple(x.shape)} and {tuple(z.shape)}")
    if sigma.ndim != 1 or sigma.shape != lengthscale.shape:
        raise ValueError("sigma and lengthscale must both be (L,)")
    if x.device.type == "cpu":
        return rbf_gram_plain(x, z, sigma, lengthscale)
    (n, dim), m, l_dim = x.shape, z.shape[0], sigma.shape[0]
    for t, what in ((x, "x"), (z, "z"), (sigma, "sigma"),
                    (lengthscale, "lengthscale")):
        if t.device != x.device:
            raise ValueError(f"rbf_gram: {what} must be on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"rbf_gram: {what} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"rbf_gram: {what} must be contiguous")
    if x.device.type != "cuda":
        raise ValueError(f"rbf_gram: no kernel for device {x.device}")
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


class RBFGram(torch.autograd.Function):
    """Differentiable RBF Gram; backward is the closed form (recomputing
    d² rather than storing it):

        dσ_l = 2 Σ g·k / σ_l,   dℓ_l = Σ g·k·d² / ℓ_l³,
        dx = w z − rowsum(w) x, dz = wᵀx − colsum(w) z,  w = Σ_l g·k/ℓ_l².
    """

    @staticmethod
    def forward(ctx, x, z, sigma, lengthscale):
        k = rbf_gram_fwd(x, z, sigma, lengthscale)
        ctx.save_for_backward(x, z, sigma, lengthscale, k)
        return k

    @staticmethod
    def backward(ctx, g):
        x, z, sigma, lengthscale, k = ctx.saved_tensors
        gk = g * k
        inv_ell2 = 1.0 / torch.square(lengthscale)
        d_sigma = 2.0 * gk.sum(dim=(1, 2)) / sigma
        d_ell = torch.einsum("lnm,nm->l", gk, squared_dist(x, z)) * inv_ell2 / lengthscale
        w = torch.einsum("lnm,l->nm", gk, inv_ell2)
        dx = w @ z - w.sum(dim=1, keepdim=True) * x
        dz = w.T @ x - w.sum(dim=0)[:, None] * z
        return dx, dz, d_sigma, d_ell


def rbf_gram(x, z, sigma, lengthscale):
    """Differentiable (L, N, M) RBF Gram; sigma, lengthscale (L,)."""
    return RBFGram.apply(x, z, sigma, lengthscale)
