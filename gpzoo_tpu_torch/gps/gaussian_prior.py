"""Free-form mean-field Gaussian "prior" of the hybrid heads' non-spatial
half (port of ``gpzoo_tpu/gps/gaussian_prior.py``): a free mean and a
softplus'd scale per factor and spot, against a fixed
N(0, scale_pf²)."""

from __future__ import annotations

import torch
from torch import nn

from gpzoo_tpu_torch.bijectors import softplus
from gpzoo_tpu_torch.dists import Normal


class GaussianPrior(nn.Module):
    """``mean`` (T, N), ``scale_raw`` (T, N) softplus'd, and the prior's
    scale ``scale_pf`` (a static float)."""

    def __init__(self, mean, scale_raw, scale_pf=1.0):
        super().__init__()
        self.mean = nn.Parameter(mean)
        self.scale_raw = nn.Parameter(scale_raw)
        self.scale_pf = scale_pf

    def _pair(self, mean, scale_raw):
        scale = softplus(scale_raw)
        return (Normal(mean, scale),
                Normal(torch.zeros_like(mean), self.scale_pf * torch.ones_like(scale)))

    def forward(self):
        """(qf, pf) over all N spots."""
        return self._pair(self.mean, self.scale_raw)

    def batched(self, idx):
        """(qf, pf) over the spots idx: the columns idx of both fields."""
        return self._pair(self.mean[:, idx], self.scale_raw[:, idx])
