"""Nonnegative Spatial Factorization heads (port of NSF and MGGPNSF from
``gpzoo_tpu/models/factorization.py``).

Counts y (D genes, N spots) are Poisson with rate
``softplus(V) · softplus(W) @ exp(F)``, F from a multi-factor GP.
"""

from __future__ import annotations

import torch
from torch import nn

from gpzoo_tpu_torch.bijectors import softplus
from gpzoo_tpu_torch.dists import Poisson


class NSF(nn.Module):
    """NSF state: ``prior`` (an SVGP), loadings ``W_raw`` (D, L) and
    per-spot size factors ``V_raw`` (N,), both softplus'd in the rate."""

    def __init__(self, prior, W_raw, V_raw):
        super().__init__()
        self.prior = prior
        self.W_raw = nn.Parameter(W_raw)
        self.V_raw = nn.Parameter(V_raw)

    @property
    def gp_prior(self):
        """The head's GP, whichever attribute holds it."""
        return self.prior


class MGGPNSF(nn.Module):
    """NSF head over a multi-group GP: ``gp`` (an MGGPSVGP; the attribute
    is ``gp``, not ``prior``, as in the JAX package), loadings ``W_raw``
    (D, L) and size factors ``V_raw`` (N,)."""

    def __init__(self, gp, W_raw, V_raw):
        super().__init__()
        self.gp = gp
        self.W_raw = nn.Parameter(W_raw)
        self.V_raw = nn.Parameter(V_raw)

    @property
    def gp_prior(self):
        """The head's GP, whichever attribute holds it."""
        return self.gp

    def forward(self, x, eps, *, groups_x):
        """(Poisson(rate), qf, qu, pu) over all N rows of x, with the
        reparameterized draw f = qf.loc + qf.scale·eps for eps (E, L, N).
        The group labels are keyword-only, as in the JAX head."""
        qf, qu, pu = self.gp(x, groups_x)
        f = qf.sample(eps)
        rate = softplus(self.V_raw) * (softplus(self.W_raw) @ torch.exp(f))
        return Poisson(rate), qf, qu, pu
