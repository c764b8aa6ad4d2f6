"""Panel-blocked triangular contractions in plain PyTorch (port of
``gpzoo_tpu/ops/tri_blocked.py``).

These are the plain versions of the Hopper kernels in
:mod:`gpzoo_tpu_torch.ops.tri_cuda`: the CPU path, and the reference the
kernels are held against on the card. Cutting the M axis into panels and
skipping the strictly-upper panel pairs of the lower-triangular Lu
removes ~42% of the dense FLOPs at ``PANELS=6``.
"""

from __future__ import annotations

import torch

# Panel count for the M (inducing points) axis.
PANELS = 6

# Below this M the contraction runs as one dense product.
MIN_DIM = 1024


def _bounds(m, panels):
    edges = [round(m * p / panels) for p in range(panels + 1)]
    return [(s, e) for s, e in zip(edges[:-1], edges[1:]) if e > s]


def _panels(m_dim):
    return _bounds(m_dim, PANELS if m_dim >= MIN_DIM else 1)


def tri_t_matmul(lu, a):
    """c[..., m, b] = Σ_k lu[..., k, m] a[..., k, b] for lower-triangular
    lu, skipping the strictly-upper panels: output rows m ∈ [s, e) only
    read k ≥ s. Returns (..., M, B)."""
    parts = [torch.einsum("...km,...kn->...mn", lu[..., s:, s:e], a[..., s:, :])
             for s, e in _panels(lu.shape[-1])]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-2)


def tri_sq_colsum(lu, a):
    """Σ_m (Σ_k lu[..., k, m] a[..., k, b])² — the posterior-variance term
    colsum((Luᵀã)²) — skipping the strictly-upper panels of lu.

    lu (..., M, M) lower-triangular; a (..., M, B) broadcast-compatible
    in the leading dims. Returns (..., B).
    """
    out = None
    for s, e in _panels(lu.shape[-1]):
        c_p = torch.einsum("...km,...kn->...mn", lu[..., s:, s:e], a[..., s:, :])
        term = torch.sum(torch.square(c_p), dim=-2)
        out = term if out is None else out + term
    return out


def tri_kl_trace(k_inv, lu):
    """tr(K⁻¹ Lu Luᵀ) per factor, panel-blocked: column panel [s, e) of
    the lower-triangular Lu only touches the trailing block of K⁻¹.

    k_inv (M, M) shared or (L, M, M); lu (L, M, M) or (M, M). Returns (L,).
    """
    lu_l = lu if lu.ndim == 3 else lu[None]
    spec = "lij,ljk,lik->l" if k_inv.ndim == 3 else "ij,ljk,lik->l"
    if k_inv.ndim == 3 and lu_l.shape[0] != k_inv.shape[0]:
        lu_l = lu_l.expand(k_inv.shape)
    out = None
    for s, e in _panels(lu_l.shape[-1]):
        term = torch.einsum(spec, k_inv[..., s:, s:],
                            lu_l[:, s:, s:e], lu_l[:, s:, s:e])
        out = term if out is None else out + term
    return out
