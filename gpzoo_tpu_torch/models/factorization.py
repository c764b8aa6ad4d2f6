"""Factorization heads (port of NSF, NBNSF, MGGPNSF, PoissonFactorization,
HybridNSF and HybridNSFExact from ``gpzoo_tpu/models/factorization.py``).

Counts y (D genes, N spots) have mean ``softplus(V) · softplus(W) @ exp(F)``,
F from a multi-factor GP: Poisson, or negative binomial for
:class:`NBNSF`. The hybrids add a mean-field half's rate. The heads hold
parameters; the fast losses of :mod:`gpzoo_tpu_torch.train.fast` evaluate
them (the generic forms of the JAX heads are not ported).
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


class NBNSF(NSF):
    """:class:`NSF` with negative-binomial counts: a per-gene inverse
    dispersion r = softplus(``r_raw``), (D,), trained with the rest."""

    def __init__(self, prior, W_raw, V_raw, r_raw):
        super().__init__(prior, W_raw, V_raw)
        self.r_raw = nn.Parameter(r_raw)


class PoissonFactorization(nn.Module):
    """One half of a hybrid head: a ``prior`` (a GP, or the mean-field
    :class:`gpzoo_tpu_torch.gps.GaussianPrior`) and its loadings ``W_raw``
    (D, factors), softplus'd in the rate."""

    def __init__(self, prior, W_raw):
        super().__init__()
        self.prior = prior
        self.W_raw = nn.Parameter(W_raw)


class HybridNSF(nn.Module):
    """Spatial plus non-spatial factorization: ``sf`` a
    :class:`PoissonFactorization` over a GP (L factors), ``cf`` one over a
    mean-field prior (T factors), and size factors ``V_raw`` (N,). The two
    halves' rates add: softplus(V)·(sp(W₁) exp(F₁) + sp(W₂) exp(F₂))."""

    def __init__(self, sf, cf, V_raw):
        super().__init__()
        self.sf = sf
        self.cf = cf
        self.V_raw = nn.Parameter(V_raw)

    @property
    def gp_prior(self):
        """The head's GP, the spatial half's prior."""
        return self.sf.prior


class HybridNSFExact(HybridNSF):
    """:class:`HybridNSF` whose rate takes the lognormal mean
    E[e^F] = exp(μ + ½σ²) of both halves instead of draws."""


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
