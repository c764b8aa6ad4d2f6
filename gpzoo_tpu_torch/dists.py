"""Distributions (port of ``gpzoo_tpu/dists.py`` without its samplers of
counts: the Poisson and negative-binomial count likelihoods, the diagonal
normal, the MVN and low-rank MVN containers, and the KL divergences the
ELBOs take).

Sampling takes its standard-normal draws ``eps`` as an argument: a torch
generator and a JAX key never give the same numbers, so the callers and
the tests supply them.
"""

from __future__ import annotations

import math

import torch

from gpzoo_tpu_torch.ops.linalg import tril_logdet

_LOG_2PI = math.log(2.0 * math.pi)


class Poisson:
    """Poisson with mean ``rate``."""

    def __init__(self, rate):
        self.rate = rate

    def log_prob(self, x):
        """Normalized log-pmf ``y·log(rate) − rate − log y!``."""
        return torch.xlogy(x, self.rate) - self.rate - torch.lgamma(x + 1.0)

    def unnormalized_log_prob(self, x):
        """``y·log(rate) − rate``, dropping the data-only ``log y!``.
        ``xlogy`` gives the limit 0 at y = rate = 0."""
        return torch.xlogy(x, self.rate) - self.rate


class NegativeBinomial:
    """Gamma-Poisson mixture in mean form: ``total_count`` r > 0 (inverse
    dispersion; Poisson is the r → ∞ limit) and ``rate`` μ, the mean.
    Variance μ + μ²/r. Written out rather than taken from
    ``torch.distributions.NegativeBinomial``, whose logits form gives NaN
    at (x = 0, μ = 0); ``xlogy`` gives the limit 0 there."""

    def __init__(self, total_count, rate):
        self.total_count = total_count
        self.rate = rate

    @property
    def mean(self):
        return self.rate

    def variance(self):
        return self.rate + torch.square(self.rate) / self.total_count

    def unnormalized_log_prob(self, x):
        """:meth:`log_prob` without the data-only ``−lgamma(x + 1)``; every
        r-dependent term stays, since they carry the dispersion's gradient."""
        r, mu = self.total_count, self.rate
        return (torch.lgamma(x + r) - torch.lgamma(r) + torch.xlogy(x, mu)
                + r * torch.log(r) - (x + r) * torch.log(mu + r))

    def log_prob(self, x):
        """lgamma(x+r) − lgamma(r) − lgamma(x+1) + xlogy(x, μ) + r·log r
        − (x+r)·log(μ+r)."""
        return self.unnormalized_log_prob(x) - torch.lgamma(x + 1.0)


class Normal:
    """Elementwise normal; batch shape = broadcast(loc, scale)."""

    def __init__(self, loc, scale):
        self.loc = loc
        self.scale = scale

    @property
    def mean(self):
        return self.loc

    def sample(self, eps):
        """Reparameterized draw ``loc + scale·eps``; eps is (*sample, *batch)."""
        return self.loc + self.scale * eps

    def log_prob(self, x):
        z = (x - self.loc) / self.scale
        return -0.5 * (z * z + _LOG_2PI) - torch.log(self.scale)


def kl_normal_normal(q, p):
    """Elementwise KL(q ‖ p) of two diagonal :class:`Normal` s."""
    var_ratio = torch.square(q.scale / p.scale)
    t1 = torch.square((q.loc - p.loc) / p.scale)
    return 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))


class MultivariateNormalTril:
    """MVN with mean ``loc`` (..., M) and lower-triangular ``scale_tril``
    (..., M, M)."""

    def __init__(self, loc, scale_tril):
        self.loc = loc
        self.scale_tril = scale_tril


def kl_mvn_mvn(q, p):
    """KL(q ‖ p) of two :class:`MultivariateNormalTril` s, batched over the
    broadcast leading dims: ½(‖Lp⁻¹Lq‖²_F + ‖Lp⁻¹(μp − μq)‖² − M)
    + log|Lp| − log|Lq|, by triangular solves."""
    lq, lp = torch.broadcast_tensors(q.scale_tril, p.scale_tril)
    a = torch.linalg.solve_triangular(lp, lq, upper=False)
    trace = torch.sum(a * a, dim=(-2, -1))
    diff = (p.loc - q.loc).expand(lq.shape[:-1])
    b = torch.linalg.solve_triangular(lp, diff[..., None], upper=False)[..., 0]
    maha = torch.sum(b * b, dim=-1)
    return (0.5 * (trace + maha - lq.shape[-1])
            + tril_logdet(lp) - tril_logdet(lq))


def kl_divergence(q, p):
    """KL(q ‖ p) of two diagonal normals (elementwise) or two MVNs."""
    if isinstance(q, Normal) and isinstance(p, Normal):
        return kl_normal_normal(q, p)
    if isinstance(q, MultivariateNormalTril) and isinstance(p, MultivariateNormalTril):
        return kl_mvn_mvn(q, p)
    raise NotImplementedError(f"KL({type(q).__name__} ‖ {type(p).__name__})")


class LowRankMultivariateNormal:
    """MVN with covariance ``diag(cov_diag) + cov_factor cov_factorᵀ``:
    ``loc`` (..., M), ``cov_factor`` (..., M, r), ``cov_diag`` (..., M)
    variances. The q(u) of :class:`gpzoo_tpu_torch.gps.LowRankWSVGP`."""

    def __init__(self, loc, cov_factor, cov_diag):
        self.loc = loc
        self.cov_factor = cov_factor
        self.cov_diag = cov_diag

    @property
    def mean(self):
        return self.loc

    def variance(self):
        return self.cov_diag + torch.sum(torch.square(self.cov_factor), dim=-1)
