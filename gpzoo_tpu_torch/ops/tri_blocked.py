"""Panel-blocked triangular contractions in plain PyTorch (port of
``gpzoo_tpu/ops/tri_blocked.py``).

``tri_sq_colsum`` and ``tri_t_matmul`` are the plain versions of the
Hopper kernels in :mod:`gpzoo_tpu_torch.ops.tri_cuda`: the CPU path, and
the reference the kernels are held against on the card. ``tri_matmul``
and ``tri_tri_matmul`` (the W-form loss's a = W·Kzx and C = W·Lu) are
cuBLAS products on the card, as they are XLA products in the JAX package,
run in the math mode of a precision string
(:mod:`gpzoo_tpu_torch.ops.precision`) in the forward and the backward.
Cutting the M axis into panels and skipping the strictly-upper panel pairs
of a lower-triangular factor removes ~42% of the dense FLOPs at
``PANELS=6``.
"""

from __future__ import annotations

import torch

from gpzoo_tpu_torch.ops.precision import check, mm

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
    in the leading dims: shared (M, B) or per-factor (L, M, B). Returns
    (..., B).
    """
    out = None
    for s, e in _panels(lu.shape[-1]):
        c_p = torch.einsum("...km,...kn->...mn", lu[..., s:, s:e], a[..., s:, :])
        term = torch.sum(torch.square(c_p), dim=-2)
        out = term if out is None else out + term
    return out


class TriMatmul(torch.autograd.Function):
    """``W @ rhs`` for lower-triangular W, panel by panel: output row panel
    [s, e) reads rhs rows k < e. Forward and backward products in one mode;
    the backward is that of the panel products, as JAX differentiates them:
    dW[s:e, :e] = g[s:e]·rhs[:e]ᵀ and d(rhs) = Wᵀg with the same skipping."""

    @staticmethod
    def forward(ctx, w, rhs, precision, keep):
        ctx.precision = precision
        ctx.save_for_backward(w, rhs)
        if keep is None:
            return _tri_matmul(w, rhs, precision)
        return keep(lambda: _tri_matmul(w, rhs, precision))

    @staticmethod
    def backward(ctx, g):
        w, rhs = ctx.saved_tensors
        p, bounds = ctx.precision, _panels(w.shape[-1])
        gw = grhs = None
        if ctx.needs_input_grad[0]:
            if len(bounds) == 1:
                gw = mm(g, rhs.mT, p, "backward")
            else:
                gw = g.new_zeros(g.shape[:-2] + w.shape[-2:])
                for s, e in bounds:
                    gw[..., s:e, :e] = mm(g[..., s:e, :], rhs[..., :e, :].mT, p,
                                          "backward")
            gw = gw.sum_to_size(w.shape)
        if ctx.needs_input_grad[1]:
            if len(bounds) == 1:
                grhs = mm(w.mT, g, p, "backward")
            else:
                grhs = torch.empty_like(g)
                for s, e in bounds:
                    grhs[..., s:e, :] = mm(w[..., s:, s:e].mT, g[..., s:, :], p,
                                           "backward")
            grhs = grhs.sum_to_size(rhs.shape)
        return gw, grhs, None, None


def _tri_matmul(w, rhs, precision):
    m_dim = w.shape[-1]
    bounds = _panels(m_dim)
    if len(bounds) == 1:
        return mm(w, rhs, precision)
    batch = torch.broadcast_shapes(w.shape[:-2], rhs.shape[:-2])
    out = torch.empty(batch + (m_dim, rhs.shape[-1]), dtype=rhs.dtype,
                      device=rhs.device)
    for s, e in bounds:
        out[..., s:e, :] = mm(w[..., s:e, :e], rhs[..., :e, :], precision)
    return out


def tri_matmul(w, rhs, precision="highest", keep=None):
    """``W @ rhs`` for lower-triangular W (..., M, M) and rhs (..., M, B),
    its products (backward included) in ``precision``'s mode
    (:mod:`gpzoo_tpu_torch.ops.precision`): output row panel [s, e) only
    reads rhs rows k < e. The panels are written into one preallocated
    result, so the peak is the result and one panel, not all panels and
    their concatenation. ``keep`` as in :func:`precision.matmul`."""
    return TriMatmul.apply(w, rhs, check(precision), keep)


class TriTriMatmul(torch.autograd.Function):
    """``C = tril(W @ Lu)`` for lower-triangular W and Lu, panel by panel:
    row panel [s, e) of C reads the leading e×e blocks of both. Forward and
    backward products in one mode; the backward is that of the masked panel
    products."""

    @staticmethod
    def forward(ctx, w, lu, precision):
        ctx.precision = precision
        ctx.save_for_backward(w, lu)
        m_dim = w.shape[-1]
        bounds = _panels(m_dim)
        if len(bounds) == 1:
            return torch.tril(mm(w, lu, precision))
        batch = torch.broadcast_shapes(w.shape[:-2], lu.shape[:-2])
        out = torch.zeros(batch + (m_dim, m_dim), dtype=torch.result_type(w, lu),
                          device=w.device)
        for s, e in bounds:
            # global row s + i keeps columns ≤ s + i
            out[..., s:e, :e] = torch.tril(mm(w[..., s:e, :e], lu[..., :e, :e],
                                              precision), diagonal=s)
        return out

    @staticmethod
    def backward(ctx, g):
        w, lu = ctx.saved_tensors
        p = ctx.precision
        batch = torch.broadcast_shapes(w.shape[:-2], lu.shape[:-2])
        gw = g.new_zeros(batch + w.shape[-2:]) if ctx.needs_input_grad[0] else None
        glu = g.new_zeros(batch + lu.shape[-2:]) if ctx.needs_input_grad[1] else None
        for s, e in _panels(w.shape[-1]):
            gm = torch.tril(g[..., s:e, :e], diagonal=s)
            if gw is not None:
                gw[..., s:e, :e] = mm(gm, lu[..., :e, :e].mT, p, "backward")
            if glu is not None:
                glu[..., :e, :e] += mm(w[..., s:e, :e].mT, gm, p, "backward")
        return (None if gw is None else gw.sum_to_size(w.shape),
                None if glu is None else glu.sum_to_size(lu.shape), None)


def tri_tri_matmul(w, lu, precision="highest"):
    """``C = W @ Lu`` with both factors (..., M, M) lower-triangular, so C
    is too: row panel [s, e) of C only reads the leading e×e blocks of
    both. Its products, backward included, run in ``precision``'s mode.
    Returns the broadcast batch of W and Lu."""
    return TriTriMatmul.apply(w, lu, check(precision))


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


def tri_t_matmul_b(w, rhs):
    """``Wᵀ @ rhs`` for lower-triangular W (..., M, M) and rhs (..., M, B):
    output row panel [s, e) only reads rhs rows k ≥ s (Wᵀ is
    upper-triangular)."""
    parts = [torch.einsum("...ki,...kb->...ib", w[..., s:, s:e], rhs[..., s:, :])
             for s, e in _panels(w.shape[-1])]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-2)


def matmul_tri(a, w):
    """``A @ W`` for lower-triangular W (..., M, M): output column panel
    [s, e) only reads A's columns l ≥ s."""
    parts = [torch.einsum("...il,...lj->...ij", a[..., s:], w[..., s:, s:e])
             for s, e in _panels(w.shape[-1])]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def matmul_tri_t(a, w):
    """``A @ Wᵀ`` for lower-triangular W (..., M, M): output column panel
    [s, e) only reads A's columns l < e (Wᵀ is upper-triangular)."""
    parts = [torch.einsum("...il,...jl->...ij", a[..., :e], w[..., s:e, :e])
             for s, e in _panels(w.shape[-1])]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
