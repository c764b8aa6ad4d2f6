"""L-batched multi-group (MGGP) Gram on Hopper: kernel 4 of the port.

Ports ``gpzoo_tpu/ops/gram_pallas.py`` ``mggp_gram``. :func:`mggp_gram_fwd`
launches ``csrc/mggp.cu`` ``mggp_gram_f32`` for CUDA tensors (its
``launches`` counts them) and takes :func:`mggp_gram_plain`, the
expanded-distance form of ``gram_pallas._mggp_gram_xla``, for CPU
tensors. The two agree up to float rounding of d² and g² near 0 (the
kernel forms both directly from the coordinates and embeddings).

:class:`MGGPGram` adds the backward: autograd of the plain recompute, as
JAX's ``_mggp_gram_bwd`` is the vjp of ``_mggp_gram_xla``. It gives the
gradients of σ, ℓ, α_eff, x, z and of the gathered embeddings ex, ez (the
embedding trains on the MGGP path, so these flow back through the
``embedding[groups]`` gather).
"""

from __future__ import annotations

import ctypes

import torch

from gpzoo_tpu_torch.ops import _build
from gpzoo_tpu_torch.ops.distance import squared_dist

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_void_p])
MAX_DIM = 8     # coordinate width the kernel stages in shared memory
MAX_L = 2048    # factors whose σ², −½/ℓ², α fit the kernel's shared memory
_ROWS = 32      # rows of x per block in csrc/mggp.cu


def mggp_gram_plain(x, z, ex, ez, sigma, lengthscale, alpha_eff, input_dim):
    """(L, N, M) σ_l² exp(−½ d²/ℓ_l²/(α_l g² + 1)) (α_l g² + 1)^(−p/2) from
    the expanded, clamped squared distances d² (x, z) and g² (ex, ez);
    sigma, lengthscale, alpha_eff are (L,), p = ``input_dim``."""
    d2 = squared_dist(x, z)
    g2 = squared_dist(ex, ez)
    denom = alpha_eff[:, None, None] * g2 + 1.0
    return (torch.square(sigma)[:, None, None]
            * torch.exp(-0.5 * d2 / torch.square(lengthscale)[:, None, None] / denom)
            * denom ** (-0.5 * input_dim))


def _check(x, z, ex, ez, sigma, lengthscale, alpha_eff):
    if x.ndim != 2 or z.ndim != 2 or x.shape[1] != z.shape[1]:
        raise ValueError(f"x (N, D) and z (M, D) expected, got "
                         f"{tuple(x.shape)} and {tuple(z.shape)}")
    if (ex.ndim != 2 or ez.ndim != 2 or ex.shape[1] != ez.shape[1]
            or ex.shape[0] != x.shape[0] or ez.shape[0] != z.shape[0]):
        raise ValueError(f"ex (N, E) and ez (M, E) expected for N={x.shape[0]}, "
                         f"M={z.shape[0]}, got {tuple(ex.shape)} and {tuple(ez.shape)}")
    if sigma.ndim != 1 or sigma.shape != lengthscale.shape or sigma.shape != alpha_eff.shape:
        raise ValueError("sigma, lengthscale and alpha_eff must all be (L,)")


def mggp_gram_fwd(x, z, ex, ez, sigma, lengthscale, alpha_eff, input_dim):
    """(L, N, M) MGGP Gram: kernel 4 on CUDA, :func:`mggp_gram_plain` on
    CPU. x (N, D), z (M, D) with D ≤ 8; ex (N, E), ez (M, E), any E;
    sigma, lengthscale, alpha_eff (L,) with α's convention applied."""
    _check(x, z, ex, ez, sigma, lengthscale, alpha_eff)
    if x.device.type == "cpu":
        return mggp_gram_plain(x, z, ex, ez, sigma, lengthscale, alpha_eff,
                               input_dim)
    (n, dim), m, e_dim, l_dim = x.shape, z.shape[0], ex.shape[1], sigma.shape[0]
    for t, what in ((x, "x"), (z, "z"), (ex, "ex"), (ez, "ez"), (sigma, "sigma"),
                    (lengthscale, "lengthscale"), (alpha_eff, "alpha_eff")):
        if t.device != x.device:
            raise ValueError(f"mggp_gram: {what} must be on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"mggp_gram: {what} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"mggp_gram: {what} must be contiguous")
    if x.device.type != "cuda":
        raise ValueError(f"mggp_gram: no kernel for device {x.device}")
    if (not 1 <= dim <= MAX_DIM or -(-n // _ROWS) > 65535 or m >= 2**31
            or e_dim < 1 or not 1 <= l_dim <= MAX_L):
        raise ValueError(f"mggp_gram: unsupported shape N={n}, M={m}, D={dim}, "
                         f"E={e_dim}, L={l_dim}")
    sigma2 = torch.square(sigma)
    nhalf_inv_ell2 = -0.5 / torch.square(lengthscale)
    out = torch.empty((l_dim, n, m), dtype=x.dtype, device=x.device)
    fn = _build.library("mggp").mggp_gram_f32
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(fn(x.data_ptr(), z.data_ptr(), ex.data_ptr(), ez.data_ptr(),
                    sigma2.data_ptr(), nhalf_inv_ell2.data_ptr(),
                    alpha_eff.data_ptr(), out.data_ptr(), n, m, dim, e_dim,
                    l_dim, 0.5 * input_dim, stream), "mggp_gram_f32")
    mggp_gram_fwd.launches += 1
    return out


mggp_gram_fwd.launches = 0


class MGGPGram(torch.autograd.Function):
    """Differentiable MGGP Gram; the backward recomputes
    :func:`mggp_gram_plain` under autograd for the inputs that need a
    gradient (no d², g² or (L, N, M) tensor is kept from the forward)."""

    @staticmethod
    def forward(ctx, x, z, ex, ez, sigma, lengthscale, alpha_eff, input_dim):
        ctx.input_dim = input_dim
        ctx.save_for_backward(x, z, ex, ez, sigma, lengthscale, alpha_eff)
        return mggp_gram_fwd(x, z, ex, ez, sigma, lengthscale, alpha_eff,
                             input_dim)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(())
        if wanted:
            with torch.enable_grad():
                out = mggp_gram_plain(*inputs, ctx.input_dim)
                grads = iter(torch.autograd.grad(out, wanted, g))
        return (*(next(grads) if t.requires_grad else None for t in inputs),
                None)


def mggp_gram(x, z, ex, ez, sigma, lengthscale, alpha_eff, input_dim):
    """Differentiable (L, N, M) MGGP Gram; sigma, lengthscale, alpha_eff
    (L,)."""
    return MGGPGram.apply(x, z, ex, ez, sigma, lengthscale, alpha_eff,
                          input_dim)
