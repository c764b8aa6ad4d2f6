"""Shared GP linear algebra (port of the subset of ``gpzoo_tpu/ops/linalg.py``
that the ported paths read)."""

from __future__ import annotations

import torch

from gpzoo_tpu_torch.ops.distance import squared_dist


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


def tril_logdet(l):
    """``Σ log diag(L)`` over the trailing two dims, batched."""
    return torch.sum(torch.log(l.diagonal(dim1=-2, dim2=-1)), dim=-1)


def spd_inverse_from_cholesky(lz):
    """K⁻¹ = Lzz⁻ᵀ Lzz⁻¹ from the lower Cholesky factor."""
    return torch.cholesky_inverse(lz)


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
    return eigvecs @ torch.diag(safe_sqrt(torch.clamp_min(eigvals, 0.0), eps))


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


class CholeskyInverse(torch.autograd.Function):
    """``(Lzz, W) = (chol(K), Lzz⁻¹)`` with one combined backward (Murray
    2016), sharing W between both cotangents:

        L̄ = tril(dL) − tril(Wᵀ dW Wᵀ),
        K̄ = ½ Wᵀ (Φ(LᵀL̄) + Φ(LᵀL̄)ᵀ) W,   Φ(X) = tril(X), diagonal halved.
    """

    @staticmethod
    def forward(ctx, k):
        l = torch.linalg.cholesky(k)
        eye = torch.eye(k.shape[-1], dtype=k.dtype, device=k.device)
        w = torch.linalg.solve_triangular(l, eye.expand(k.shape), upper=False)
        ctx.save_for_backward(l, w)
        return l, w

    @staticmethod
    def backward(ctx, dl, dw):
        l, w = ctx.saved_tensors
        lbar = torch.tril(dl) - torch.tril(w.mT @ dw @ w.mT)
        phi = torch.tril(l.mT @ lbar)
        del lbar
        phi.diagonal(dim1=-2, dim2=-1).mul_(0.5)
        phi = 0.5 * (phi + phi.mT)
        return w.mT @ phi @ w


def cholesky_inverse_mm(k):
    """``(chol(K), chol(K)⁻¹)`` through :class:`CholeskyInverse`, every
    product in the tensor's dtype. The JAX package's TPU precision and
    panel-blocking switches are not taken."""
    return CholeskyInverse.apply(k)
