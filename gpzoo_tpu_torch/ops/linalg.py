"""Shared GP linear algebra (port of the subset of ``gpzoo_tpu/ops/linalg.py``
that the ported paths read)."""

from __future__ import annotations

import torch

from gpzoo_tpu_torch.ops.clip import clip_min
from gpzoo_tpu_torch.ops.distance import squared_dist
from gpzoo_tpu_torch.ops.precision import check, matmul, mm
from gpzoo_tpu_torch.ops.tri_blocked import _panels


def add_jitter(mat, jitter=1e-3):
    """Return ``mat + jitter·I`` on the trailing two dims (pure)."""
    n = mat.shape[-1]
    return mat + jitter * torch.eye(n, dtype=mat.dtype, device=mat.device)


def safe_sqrt(x, eps=1e-12):
    """sqrt(x + eps): finite gradient at 0, value shifted by eps."""
    return torch.sqrt(x + eps)


def sqrt_safe_grad(x):
    """sqrt(x) with a zero gradient at x == 0 instead of NaN, and the value
    unchanged everywhere. The inner ``where`` keeps sqrt's argument off 0
    so its backward never forms inf·0; the outer one pins the value."""
    pos = x > 0
    inner = torch.sqrt(torch.where(pos, x, torch.ones_like(x)))
    return torch.where(pos, inner, torch.zeros_like(x))


def svgp_forward(kxx_diag, kzz, w, inducing_mean, inducing_cov):
    """Marginal posterior projection of the unwhitened SVGP:
    mean = W μ, cov = Kxx + rowsum((W (S − Kzz)) ⊙ W), batched over any
    leading dims: kxx_diag (..., N), kzz (..., M, M), w (..., N, M),
    inducing_mean (..., M), inducing_cov (..., M, M)."""
    mean = torch.einsum("...nm,...m->...n", w, inducing_mean)
    wd = torch.einsum("...nm,...mk->...nk", w, inducing_cov - kzz)
    return mean, kxx_diag + torch.sum(wd * w, dim=-1)


def reshape_param(param):
    """A (..., M, M) tensor with its leading dims flattened: (B, M, M)."""
    return param.reshape((-1,) + tuple(param.shape[-2:]))


def tril_logdet(l):
    """``Σ log diag(L)`` over the trailing two dims, batched."""
    return torch.sum(torch.log(l.diagonal(dim1=-2, dim2=-1)), dim=-1)


def whitened_kl(mz, lz):
    """KL(N(m, L Lᵀ) ‖ N(0, I)) = ½(‖L‖²_F + ‖m‖² − M) − log|L|, batched
    over the leading dims of lz (..., M, M) and mz (..., M)."""
    m = lz.shape[-1]
    return 0.5 * (-2.0 * tril_logdet(lz)
                  + torch.sum(torch.square(lz), dim=(-2, -1))
                  + torch.sum(torch.square(mz), dim=-1) - m)


def lowrank_whitened_kl(mz, v, var_diag):
    """KL(N(m, D + VVᵀ) ‖ N(0, I)) with D = diag(var_diag), variances:
    ½[tr D + ‖V‖²_F + ‖m‖² − M − log|D + VVᵀ|], the log-determinant by
    the matrix determinant lemma, Σ log D_ii + log|I_r + VᵀD⁻¹V|, through
    an r×r Cholesky. No M×M tensor is formed. Batched over the leading
    dims of v (..., M, r), var_diag (..., M) and mz (..., M)."""
    m, r = v.shape[-2], v.shape[-1]
    cap = (torch.eye(r, dtype=v.dtype, device=v.device)
           + v.mT @ (v / var_diag[..., None]))
    logdet = (torch.sum(torch.log(var_diag), dim=-1)
              + 2.0 * tril_logdet(torch.linalg.cholesky(cap)))
    return 0.5 * (torch.sum(var_diag, dim=-1)
                  + torch.sum(torch.square(v), dim=(-2, -1))
                  + torch.sum(torch.square(mz), dim=-1) - m - logdet)


def tri_inverse(l, block=512, precision="highest"):
    """Lower-triangular inverse by the 2×2 block recursion

        [[A, 0], [B, C]]⁻¹ = [[A⁻¹, 0], [−C⁻¹ B A⁻¹, C⁻¹]],

    so that only the ≤ ``block`` diagonal blocks run as triangular solves
    and the rest are products, in ``precision``'s mode
    (:mod:`gpzoo_tpu_torch.ops.precision`), backward included. The split is
    at a multiple of 128, or at m // 2 where that multiple is not below m,
    as in the JAX package. l (..., M, M) lower-triangular, any batch rank."""
    m = l.shape[-1]
    if m <= block:
        eye = torch.eye(m, dtype=l.dtype, device=l.device)
        return torch.linalg.solve_triangular(l, eye.expand(l.shape), upper=False)
    h = ((m // 2 + 127) // 128) * 128
    if h >= m:
        h = m // 2
    a_inv = tri_inverse(l[..., :h, :h], block, precision)
    c_inv = tri_inverse(l[..., h:, h:], block, precision)
    b_inv = -matmul(matmul(c_inv, l[..., h:, :h], precision), a_inv, precision)
    top = torch.cat([a_inv, a_inv.new_zeros(l.shape[:-2] + (h, m - h))], dim=-1)
    return torch.cat([top, torch.cat([b_inv, c_inv], dim=-1)], dim=-2)


def cholesky_blocked(k, block=512):
    """Cholesky factor by the right-looking 2×2 block recursion:
    L11 = chol(K11), L21 = K21 L11⁻ᵀ (through :func:`tri_inverse`),
    L22 = chol(K22 − L21 L21ᵀ); only the ≤ ``block`` diagonal blocks run
    the library factorization. k (..., M, M) SPD, any batch rank."""
    m = k.shape[-1]
    if m <= block:
        return torch.linalg.cholesky(k)
    h = ((m // 2 + 127) // 128) * 128
    if h >= m:
        h = m // 2
    l11 = cholesky_blocked(k[..., :h, :h], block)
    l21 = k[..., h:, :h] @ tri_inverse(l11, block).mT
    l22 = cholesky_blocked(k[..., h:, h:] - l21 @ l21.mT, block)
    top = torch.cat([l11, l11.new_zeros(k.shape[:-2] + (h, m - h))], dim=-1)
    return torch.cat([top, torch.cat([l21, l22], dim=-1)], dim=-2)


def spd_inverse_from_cholesky(lz, block=None, precision="highest"):
    """K⁻¹ = Lzz⁻ᵀ Lzz⁻¹ from the lower Cholesky factor: the library's
    ``cholesky_inverse`` at "highest" without ``block``; else WᵀW with
    W = Lzz⁻¹ from :func:`tri_inverse` (the JAX package's form), every
    product in ``precision``'s mode."""
    if block is None and precision == "highest":
        return torch.cholesky_inverse(lz)
    w = tri_inverse(lz, 512 if block is None else block, precision)
    return matmul(w.mT, w, precision)


def _murray_kbar(l, w, lbar, precision="highest"):
    """K̄ = ½ Wᵀ (Φ(LᵀL̄) + Φ(LᵀL̄)ᵀ) W with Φ(X) = tril(X), diagonal
    halved (Murray 2016): the Cholesky's backward through W = L⁻¹, its
    products in ``precision``'s mode."""
    phi = torch.tril(mm(l.mT, lbar, precision, "backward"))
    del lbar  # one (L, M, M) buffer fewer at the peak
    return mm(mm(w.mT, _sym_phi(phi), precision, "backward"), w, precision, "backward")


def _sym_phi(phi):
    """½(Φ + Φᵀ) of a lower-triangular Φ whose diagonal is then halved."""
    phi.diagonal(dim1=-2, dim2=-1).mul_(0.5)
    return 0.5 * (phi + phi.mT)


class CholeskyMM(torch.autograd.Function):
    """``torch.linalg.cholesky`` whose backward is products through the
    blocked :func:`tri_inverse` instead of triangular solves."""

    @staticmethod
    def forward(ctx, k):
        l = torch.linalg.cholesky(k)
        ctx.save_for_backward(l)
        return l

    @staticmethod
    def backward(ctx, dl):
        (l,) = ctx.saved_tensors
        return _murray_kbar(l, tri_inverse(l), torch.tril(dl))


def cholesky_mm(k):
    """chol(K) through :class:`CholeskyMM`."""
    return CholeskyMM.apply(k)


def embed_distance_matrix(distance_matrix, eps=1e-6):
    """Classical MDS embedding of a distance matrix: double-centre −½D²,
    eigendecompose, zero the negative eigenvalues, return
    ``Q diag(sqrt(λ + eps))``.

    The embedding is not unique where eigenvalues repeat (the complete-graph
    distances 1 − I have one eigenvalue of multiplicity G − 1), so
    ``torch.linalg.eigh`` and ``jnp.linalg.eigh`` may return different
    bases; the squared distances between rows, which the MGGP kernels read,
    are the same."""
    d = torch.as_tensor(distance_matrix)
    n = d.shape[-1]
    c = (torch.eye(n, dtype=d.dtype, device=d.device)
         - torch.ones((n, n), dtype=d.dtype, device=d.device) / n)
    b = -0.5 * (c @ torch.square(d) @ c)
    eigvals, eigvecs = torch.linalg.eigh(b)
    return eigvecs @ torch.diag(safe_sqrt(clip_min(eigvals, 0.0), eps))


def build_group_distances(x, groups, n_groups):
    """Distance matrix between per-group mean positions. Like the JAX
    package, each group's mean is taken over all its coordinates at once,
    one scalar per group broadcast back to a (D,) row."""
    x = torch.as_tensor(x)
    groups = torch.as_tensor(groups, device=x.device)
    rows = []
    for g in range(n_groups):
        mask = groups == g
        total = torch.sum(torch.where(mask[:, None], x, torch.zeros_like(x)))
        count = torch.sum(mask) * x.shape[1]
        rows.append((total / count).expand(x.shape[1]))
    avg = torch.stack(rows)
    return torch.sqrt(squared_dist(avg, avg))


def _panel_bwd_products(l, w, dl, dw, precision):
    """The products of :class:`CholeskyInverse`'s backward, panel-blocked over
    their triangular operand (the JAX package's ``_panel_bwd_products``): each
    output panel reads only the panels of L or W that are not structural
    zeros, ≈0.58× the dense FLOPs at 6 panels. Every panel is written into
    one preallocated result, so the peak is the result and one panel."""
    bounds = _panels(l.shape[-1])

    def prod(a, b):
        return mm(a, b, precision, "backward")

    def out_like(a, b, rows, cols):
        batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
        return torch.empty(batch + (rows, cols), dtype=torch.result_type(a, b),
                           device=a.device)

    def tri_t_mm(w_, rhs):
        # Wᵀ @ rhs, W lower-triangular: output rows [s, e) read k ≥ s
        out = out_like(w_, rhs, w_.shape[-1], rhs.shape[-1])
        for s, e in bounds:
            out[..., s:e, :] = prod(w_[..., s:, s:e].mT, rhs[..., s:, :])
        return out

    def mm_tri_t(a, w_):
        # A @ Wᵀ: output columns [s, e) read A's columns < e
        out = out_like(a, w_, a.shape[-2], w_.shape[-2])
        for s, e in bounds:
            out[..., :, s:e] = prod(a[..., :e], w_[..., s:e, :e].mT)
        return out

    def mm_tri(a, w_):
        # A @ W: output columns [s, e) read A's columns ≥ s
        out = out_like(a, w_, a.shape[-2], w_.shape[-1])
        for s, e in bounds:
            out[..., :, s:e] = prod(a[..., s:], w_[..., s:, s:e])
        return out

    lbar = torch.tril(dl) - torch.tril(mm_tri_t(tri_t_mm(w, dw), w))
    phi = torch.tril(tri_t_mm(l, lbar))  # Φ(Lᵀ L̄) before the halving
    del lbar
    return mm_tri(tri_t_mm(w, _sym_phi(phi)), w)  # Wᵀ Φ W


class CholeskyInverse(torch.autograd.Function):
    """``(Lzz, W) = (chol(K), Lzz⁻¹)`` with one combined backward (Murray
    2016), sharing W between both cotangents:

        L̄ = tril(dL) − tril(Wᵀ dW Wᵀ),
        K̄ = ½ Wᵀ (Φ(LᵀL̄) + Φ(LᵀL̄)ᵀ) W,   Φ(X) = tril(X), diagonal halved.

    The five backward products run in ``bwd_precision``'s mode, dense or,
    with ``bwd_blocked``, panel-blocked (:func:`_panel_bwd_products`).
    W is the library's triangular solve at ``fwd_precision`` "highest" and
    :func:`tri_inverse` in that mode otherwise, as in the JAX package."""

    @staticmethod
    def forward(ctx, k, bwd_precision, bwd_blocked, fwd_precision):
        l = torch.linalg.cholesky(k)
        if fwd_precision == "highest":
            eye = torch.eye(k.shape[-1], dtype=k.dtype, device=k.device)
            w = torch.linalg.solve_triangular(l, eye.expand(k.shape), upper=False)
        else:
            w = tri_inverse(l, precision=fwd_precision)
        ctx.save_for_backward(l, w)
        ctx.bwd = bwd_precision, bwd_blocked
        return l, w

    @staticmethod
    def backward(ctx, dl, dw):
        l, w = ctx.saved_tensors
        precision, blocked = ctx.bwd
        if blocked:
            kbar = _panel_bwd_products(l, w, dl, dw, precision)
        else:
            t = mm(mm(w.mT, dw, precision, "backward"), w.mT, precision, "backward")
            kbar = _murray_kbar(l, w, torch.tril(dl) - torch.tril(t), precision)
        return kbar, None, None, None


def cholesky_inverse_mm(k, bwd_precision="highest", bwd_blocked=False,
                        fwd_precision="highest"):
    """``(chol(K), chol(K)⁻¹)`` through :class:`CholeskyInverse`: its
    backward's five products in ``bwd_precision``'s mode, panel-blocked with
    ``bwd_blocked``; W built in ``fwd_precision``'s mode. The arguments are
    those of the JAX package's ``cholesky_inverse_mm``."""
    return CholeskyInverse.apply(k, check(bwd_precision, "bwd_precision"),
                                 bool(bwd_blocked),
                                 check(fwd_precision, "fwd_precision"))
