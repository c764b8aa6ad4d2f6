"""Unwhitened sparse variational GP (port of ``gpzoo_tpu/gps/svgp.py`` SVGP).

Holds the parameters the precomputed-projection training path reads; the
posterior itself is evaluated by :mod:`gpzoo_tpu_torch.train.fast`.
"""

from __future__ import annotations

from torch import nn


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
