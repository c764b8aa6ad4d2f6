"""Unwhitened sparse variational GP (port of ``gpzoo_tpu/gps/svgp.py``
SVGP and the posterior tail shared with the MGGP SVGP).

:class:`SVGP` holds the parameters the fast losses read; its posterior is
evaluated by :mod:`gpzoo_tpu_torch.train.fast`.
"""

from __future__ import annotations

import torch
from torch import nn

from gpzoo_tpu_torch.bijectors import lower_cholesky
from gpzoo_tpu_torch.dists import MultivariateNormalTril, Normal
from gpzoo_tpu_torch.ops.linalg import svgp_forward


def _posterior_tail(kxx, kzz_jittered, lzz, w, mu, lu_raw, var_floor):
    """Shared unwhitened tail: S = Lu Luᵀ, then ``svgp_forward``, then
    (qf, qu, pu): qf the marginal ``Normal`` with its variance clamped at
    ``var_floor``, qu = N(mu, Lu Luᵀ), pu = N(0, Kzz)."""
    lu = lower_cholesky(lu_raw)
    s = lu @ lu.mT
    mean, cov = svgp_forward(kxx, kzz_jittered, w, mu, s)
    qf = Normal(mean, torch.sqrt(torch.clamp(cov, min=var_floor)))
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
