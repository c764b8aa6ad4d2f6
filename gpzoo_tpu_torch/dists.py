"""Distributions (port of the subset of ``gpzoo_tpu/dists.py`` that the
ported paths read).

Sampling takes its standard-normal draws ``eps`` as an argument: a torch
generator and a JAX key never give the same numbers, so the callers and
the tests supply them.
"""

from __future__ import annotations

import torch


class Poisson:
    """Poisson with mean ``rate``."""

    def __init__(self, rate):
        self.rate = rate

    def unnormalized_log_prob(self, x):
        """``y·log(rate) − rate``, dropping the data-only ``log y!``.
        ``xlogy`` gives the limit 0 at y = rate = 0."""
        return torch.xlogy(x, self.rate) - self.rate


class Normal:
    """Elementwise normal; batch shape = broadcast(loc, scale)."""

    def __init__(self, loc, scale):
        self.loc = loc
        self.scale = scale

    def sample(self, eps):
        """Reparameterized draw ``loc + scale·eps``; eps is (*sample, *batch)."""
        return self.loc + self.scale * eps


class MultivariateNormalTril:
    """MVN with mean ``loc`` (..., M) and lower-triangular ``scale_tril``
    (..., M, M)."""

    def __init__(self, loc, scale_tril):
        self.loc = loc
        self.scale_tril = scale_tril
