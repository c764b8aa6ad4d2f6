"""Shared GP linear algebra (port of the main-path subset of
``gpzoo_tpu/ops/linalg.py``)."""

from __future__ import annotations

import torch


def add_jitter(mat, jitter=1e-3):
    """Return ``mat + jitter·I`` on the trailing two dims (pure)."""
    n = mat.shape[-1]
    return mat + jitter * torch.eye(n, dtype=mat.dtype, device=mat.device)


def sqrt_safe_grad(x):
    """sqrt(x) with a zero gradient at x == 0 instead of NaN, and the value
    unchanged everywhere. The inner ``where`` keeps sqrt's argument off 0
    so its backward never forms inf·0; the outer one pins the value."""
    pos = x > 0
    inner = torch.sqrt(torch.where(pos, x, torch.ones_like(x)))
    return torch.where(pos, inner, torch.zeros_like(x))


def tril_logdet(l):
    """``Σ log diag(L)`` over the trailing two dims, batched."""
    return torch.sum(torch.log(l.diagonal(dim1=-2, dim2=-1)), dim=-1)


def spd_inverse_from_cholesky(lz):
    """K⁻¹ = Lzz⁻ᵀ Lzz⁻¹ from the lower Cholesky factor."""
    return torch.cholesky_inverse(lz)
