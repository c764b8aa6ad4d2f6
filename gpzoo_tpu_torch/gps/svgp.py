"""Sparse variational GPs (port of ``gpzoo_tpu/gps/svgp.py``): the
unwhitened :class:`SVGP`, the whitened :class:`WSVGP` and the whitened
low-rank-plus-diagonal :class:`LowRankWSVGP`.

Each holds the parameters the fast losses read and gives its marginal
posterior ``gp(x) → (qf, qu, pu)`` at the rows of x, which
``predict.latent_posterior`` calls; the whitened ones return ``pu = None``
(their KL is against N(0, I)). Kzx and Kzz go through the kernel's Gram,
kernel 3 on the card.
"""

from __future__ import annotations

import torch
from torch import nn

from gpzoo_tpu_torch.bijectors import lower_cholesky, softplus
from gpzoo_tpu_torch.dists import (LowRankMultivariateNormal,
                                   MultivariateNormalTril, Normal)
from gpzoo_tpu_torch.ops.clip import clip_min
from gpzoo_tpu_torch.ops.linalg import add_jitter, sqrt_safe_grad, svgp_forward


def _posterior_tail(kxx, kzz_jittered, lzz, w, mu, lu_raw, var_floor):
    """Shared unwhitened tail: S = Lu Luᵀ, then ``svgp_forward``, then
    (qf, qu, pu): qf the marginal ``Normal`` with its variance clamped at
    ``var_floor``, qu = N(mu, Lu Luᵀ), pu = N(0, Kzz)."""
    lu = lower_cholesky(lu_raw)
    s = lu @ lu.mT
    mean, cov = svgp_forward(kxx, kzz_jittered, w, mu, s)
    qf = Normal(mean, torch.sqrt(clip_min(cov, var_floor)))
    return (qf, MultivariateNormalTril(mu, lu),
            MultivariateNormalTril(torch.zeros_like(mu), lzz))


class SVGP(nn.Module):
    """Canonical SVGP state.

      kernel — an :class:`gpzoo_tpu_torch.kernels.RBF`,
      Z (M, dim) inducing locations,
      mu (M,) or (L, M) inducing mean,
      Lu_raw (M, M) or (L, M, M) unconstrained Cholesky (diagonal exp'd by
          :func:`gpzoo_tpu_torch.bijectors.lower_cholesky`),
      jitter — added to Kzz before its Cholesky,
      var_floor — clamp of the marginal posterior variance.

    All tensors are ``nn.Parameter`` so that ``named_parameters`` gives the
    JAX package's dotted leaf paths; a configuration freezes Z and the
    kernel by turning their ``requires_grad`` off.
    """

    def __init__(self, kernel, Z, mu, Lu_raw, jitter=1e-4, var_floor=1e-6):
        super().__init__()
        self.kernel = kernel
        self.Z = nn.Parameter(Z)
        self.mu = nn.Parameter(mu)
        self.Lu_raw = nn.Parameter(Lu_raw)
        self.jitter = jitter
        self.var_floor = var_floor

    def forward(self, x):
        """(qf, qu, pu) at the rows of x, with W = (Kzz⁻¹Kzx)ᵀ by two
        triangular solves."""
        kxx, kzx, kzz = _grams(self, x)
        lzz = torch.linalg.cholesky(kzz)
        w = torch.cholesky_solve(kzx, lzz).mT
        return _posterior_tail(kxx, kzz, lzz, w, self.mu, self.Lu_raw,
                               self.var_floor)


def _grams(gp, x):
    """(Kxx diagonal, Kzx, Kzz + jitter·I) of ``gp`` at the rows of x."""
    kzz = add_jitter(gp.kernel.gram(gp.Z, gp.Z), gp.jitter)
    return gp.kernel.diag(x), gp.kernel.gram(gp.Z, x), kzz


def _whitened_projection(gp, x):
    """(Kxx diagonal, W = Kxz Lzz⁻ᵀ) of a whitened ``gp``: one solve."""
    kxx, kzx, kzz = _grams(gp, x)
    lzz = torch.linalg.cholesky(kzz)
    return kxx, torch.linalg.solve_triangular(lzz, kzx, upper=False).mT


class WSVGP(nn.Module):
    """Whitened SVGP: u = Lzz v with v ~ N(0, I) a priori and
    q(v) = N(mu, Lu Luᵀ). W = Kxz Lzz⁻ᵀ,
    cov = clamp(Kxx − Σ W², 0) + Σ (W Lu)², and no pu: the loss pairs qu
    with :func:`gpzoo_tpu_torch.ops.linalg.whitened_kl`. Fields as
    :class:`SVGP`'s, without var_floor."""

    def __init__(self, kernel, Z, mu, Lu_raw, jitter=1e-4):
        super().__init__()
        self.kernel = kernel
        self.Z = nn.Parameter(Z)
        self.mu = nn.Parameter(mu)
        self.Lu_raw = nn.Parameter(Lu_raw)
        self.jitter = jitter

    def forward(self, x):
        """(qf, qu, None) at the rows of x."""
        return self._tail(*_whitened_projection(self, x))

    def _tail(self, kxx, w):
        """(qf, qu, None) from the Kxx diagonal and W = Kxz Lzz⁻ᵀ."""
        lu = lower_cholesky(self.Lu_raw)
        cov = clip_min(kxx - torch.sum(torch.square(w), dim=-1), 0.0)
        cov = cov + torch.sum(torch.square(w @ lu), dim=-1)
        mean = torch.einsum("...nm,...m->...n", w, self.mu)
        # the clamp can leave cov exactly 0, where sqrt's gradient is NaN
        return (Normal(mean, sqrt_safe_grad(cov)),
                MultivariateNormalTril(self.mu, lu), None)


class LowRankWSVGP(nn.Module):
    """Whitened SVGP with q(v) = N(mu, D + VVᵀ): ``V`` (M, r) or (L, M, r)
    and D = diag(softplus(d_raw)²), ``d_raw`` (M,) or (L, M), in place of
    the full Cholesky Lu. No M×M tensor of q exists; the loss pairs qu
    with :func:`gpzoo_tpu_torch.ops.linalg.lowrank_whitened_kl`."""

    def __init__(self, kernel, Z, mu, V, d_raw, jitter=1e-4):
        super().__init__()
        self.kernel = kernel
        self.Z = nn.Parameter(Z)
        self.mu = nn.Parameter(mu)
        self.V = nn.Parameter(V)
        self.d_raw = nn.Parameter(d_raw)
        self.jitter = jitter

    @property
    def rank(self):
        return self.V.shape[-1]

    def forward(self, x):
        """(qf, qu, None) at the rows of x."""
        return self._tail(*_whitened_projection(self, x))

    def _tail(self, kxx, w):
        """(qf, qu, None) from the Kxx diagonal and W = Kxz Lzz⁻ᵀ;
        diag(W S Wᵀ) is Σ_m D_mm W²_nm + Σ_k (W V)²_nk."""
        var_diag = torch.square(softplus(self.d_raw))
        w2 = torch.square(w)
        cov = clip_min(kxx - torch.sum(w2, dim=-1), 0.0)
        cov = cov + torch.einsum("...nm,...m->...n", w2, var_diag)
        cov = cov + torch.sum(torch.square(w @ self.V), dim=-1)
        mean = torch.einsum("...nm,...m->...n", w, self.mu)
        return (Normal(mean, sqrt_safe_grad(cov)),
                LowRankMultivariateNormal(self.mu, self.V, var_diag), None)
