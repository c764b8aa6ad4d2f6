"""Gaussian observation heads over a GP posterior (port of
``gpzoo_tpu/models/likelihoods.py``: GaussianLikelihood, ExactLikelihood).

The draws come in as ``eps`` (E, *qf's batch shape), standard normal, as
everywhere in the port."""

from __future__ import annotations

import torch
from torch import nn

from gpzoo_tpu_torch.bijectors import softplus
from gpzoo_tpu_torch.dists import Normal


class GaussianLikelihood(nn.Module):
    """pY = N(F, softplus(``noise_raw``)) around the E draws of qF from
    ``gp``. ``noise_raw`` is stored raw: ``create(gp, noise=0.1)`` puts 0.1
    there, as the JAX head does."""

    def __init__(self, gp, noise_raw):
        super().__init__()
        self.gp = gp
        self.noise_raw = nn.Parameter(torch.as_tensor(noise_raw))

    @classmethod
    def create(cls, gp, noise=0.1):
        p = next(gp.parameters())
        return cls(gp, torch.tensor(noise, dtype=p.dtype, device=p.device))

    def forward(self, x, eps, **kwargs):
        """(pY, qf, qu, pu) at the rows of x."""
        qf, qu, pu = self.gp(x, **kwargs)
        return Normal(qf.sample(eps), softplus(self.noise_raw)), qf, qu, pu


class ExactLikelihood(GaussianLikelihood):
    """pY = N(qF.mean, softplus(``noise_raw``)), no draws: the head of
    :func:`gpzoo_tpu_torch.train.elbo.gaussian_exact_negative_elbo`."""

    def forward(self, x, eps=None, **kwargs):
        qf, qu, pu = self.gp(x, **kwargs)
        return Normal(qf.mean, softplus(self.noise_raw)), qf, qu, pu
