"""Factorization heads (port of ``gpzoo_tpu/models/factorization.py``).

Counts y (D genes, N spots) have mean ``softplus(V) · softplus(W) @ exp(F)``,
F from a multi-factor GP (:class:`NSF`, :class:`LegacyNSF`,
:class:`MGGPNSF`) or a mean-field prior (:class:`PNMF`): Poisson, or
negative binomial for :class:`NBNSF`. The hybrids add a mean-field half's
rate; :class:`LegacyHybridNSF` takes its concatenated loadings raw.

Each head's ``forward`` (all N spots) and ``batched`` (the spots idx: the
GP at x[idx], V and the mean-field fields sliced) are the generic forms the
ELBOs of :mod:`gpzoo_tpu_torch.train.elbo` call. The reparameterized
draws come in as arguments: ``eps`` (E, L, n) for the GP half or the PNMF
prior, ``eps2`` (E, T, n) for a hybrid's mean-field half. The fast losses
of :mod:`gpzoo_tpu_torch.train.fast` read the heads' parameters directly.
"""

from __future__ import annotations

import torch
from torch import nn

from gpzoo_tpu_torch.bijectors import softplus
from gpzoo_tpu_torch.dists import NegativeBinomial, Normal, Poisson


def _rate(w_raw, f_samples, apply_softplus=True):
    """softplus(W) @ exp(F): (D, Lt) @ (..., Lt, n) → (..., D, n)."""
    w = softplus(w_raw) if apply_softplus else w_raw
    return torch.einsum("dl,...ln->...dn", w, torch.exp(f_samples))


def _groups_at(kwargs, idx):
    """``kwargs`` with a full-length ``groups_x`` sliced to the spots idx:
    the minibatch is drawn inside the step, so the caller cannot slice."""
    if kwargs.get("groups_x") is not None:
        return dict(kwargs, groups_x=kwargs["groups_x"][idx])
    return kwargs


class PoissonFactorization(nn.Module):
    """A ``prior`` (a GP, or the mean-field
    :class:`gpzoo_tpu_torch.gps.GaussianPrior`) and its loadings ``W_raw``
    (D, factors), softplus'd in the rate; one half of a hybrid head."""

    def __init__(self, prior, W_raw):
        super().__init__()
        self.prior = prior
        self.W_raw = nn.Parameter(W_raw)

    def get_rate(self, f_samples):
        """softplus(W) @ exp(F) for draws F (..., factors, n)."""
        return _rate(self.W_raw, f_samples)


class PNMF(PoissonFactorization):
    """Probabilistic NMF: Poisson factorization over a mean-field
    :class:`gpzoo_tpu_torch.gps.GaussianPrior` (L, N), no GP, with per-spot
    size factors ``V_raw`` (N,)."""

    def __init__(self, prior, W_raw, V_raw):
        super().__init__(prior, W_raw)
        self.V_raw = nn.Parameter(V_raw)

    def forward(self, eps):
        """(Poisson(rate), qf, pf) over all N spots; eps (E, L, N)."""
        qf, pf = self.prior()
        rate = softplus(self.V_raw) * self.get_rate(qf.sample(eps))
        return Poisson(rate), qf, pf

    def batched(self, idx, eps):
        """The same over the spots idx; eps (E, L, B)."""
        qf, pf = self.prior.batched(idx)
        rate = softplus(self.V_raw[idx]) * self.get_rate(qf.sample(eps))
        return Poisson(rate), qf, pf


class NSF(PoissonFactorization):
    """NSF: ``prior`` a GP (SVGP, WSVGP, LowRankWSVGP, VNNGP), loadings
    ``W_raw`` (D, L) and per-spot size factors ``V_raw`` (N,), both
    softplus'd in the rate."""

    def __init__(self, prior, W_raw, V_raw):
        super().__init__(prior, W_raw)
        self.V_raw = nn.Parameter(V_raw)

    @property
    def gp_prior(self):
        """The head's GP, whichever attribute holds it."""
        return self.prior

    def _py(self, rate):
        return Poisson(rate)

    def forward(self, x, eps, **kwargs):
        """(pY, qf, qu, pu) over all rows of x; eps (E, L, N)."""
        qf, qu, pu = self.prior(x, **kwargs)
        rate = softplus(self.V_raw) * self.get_rate(qf.sample(eps))
        return self._py(rate), qf, qu, pu

    def batched(self, x, idx, eps, **kwargs):
        """The GP at x[idx] only, V sliced; eps (E, L, B)."""
        qf, qu, pu = self.prior(x[idx], **kwargs)
        rate = softplus(self.V_raw[idx]) * self.get_rate(qf.sample(eps))
        return self._py(rate), qf, qu, pu


class NBNSF(NSF):
    """:class:`NSF` with negative-binomial counts: a per-gene inverse
    dispersion r = softplus(``r_raw``), (D,), trained with the rest."""

    def __init__(self, prior, W_raw, V_raw, r_raw):
        super().__init__(prior, W_raw, V_raw)
        self.r_raw = nn.Parameter(r_raw)

    def _py(self, rate):
        return NegativeBinomial(softplus(self.r_raw)[:, None], rate)


class HybridNSF(nn.Module):
    """Spatial plus non-spatial factorization: ``sf`` a
    :class:`PoissonFactorization` over a GP (L factors), ``cf`` one over a
    mean-field prior (T factors), and size factors ``V_raw`` (N,). The two
    halves' rates add: softplus(V)·(sp(W₁) exp(F₁) + sp(W₂) exp(F₂)).
    ``forward`` and ``batched`` return (pY, qf1, qu, pu, qf2, pf2)."""

    def __init__(self, sf, cf, V_raw):
        super().__init__()
        self.sf = sf
        self.cf = cf
        self.V_raw = nn.Parameter(V_raw)

    @property
    def gp_prior(self):
        """The head's GP, the spatial half's prior."""
        return self.sf.prior

    def _combine(self, f1, f2, v_raw):
        return Poisson(softplus(v_raw) * (self.sf.get_rate(f1) + self.cf.get_rate(f2)))

    def forward(self, x, eps, eps2, **kwargs):
        """Over all rows of x; eps (E, L, N), eps2 (E, T, N)."""
        qf1, qu, pu = self.sf.prior(x, **kwargs)
        qf2, pf2 = self.cf.prior()
        py = self._combine(qf1.sample(eps), qf2.sample(eps2), self.V_raw)
        return py, qf1, qu, pu, qf2, pf2

    def batched(self, x, idx, eps, eps2, **kwargs):
        """Over the spots idx (a full-length ``groups_x`` is sliced here);
        eps (E, L, B), eps2 (E, T, B)."""
        qf1, qu, pu = self.sf.prior(x[idx], **_groups_at(kwargs, idx))
        qf2, pf2 = self.cf.prior.batched(idx)
        py = self._combine(qf1.sample(eps), qf2.sample(eps2), self.V_raw[idx])
        return py, qf1, qu, pu, qf2, pf2


def _log_mean(q):
    """μ + ½σ², the log of the lognormal mean E[e^F] of a Normal q."""
    return q.mean + 0.5 * torch.square(q.scale)


def _no_draws(eps, eps2):
    if eps is not None or eps2 is not None:
        raise ValueError("HybridNSFExact takes no draws (eps, eps2)")


class HybridNSFExact(HybridNSF):
    """:class:`HybridNSF` whose rate takes the lognormal mean
    E[e^F] = exp(μ + ½σ²) of both halves instead of draws."""

    def forward(self, x, eps=None, eps2=None, **kwargs):
        _no_draws(eps, eps2)
        qf1, qu, pu = self.sf.prior(x, **kwargs)
        qf2, pf2 = self.cf.prior()
        py = self._combine(_log_mean(qf1), _log_mean(qf2), self.V_raw)
        return py, qf1, qu, pu, qf2, pf2

    def batched(self, x, idx, eps=None, eps2=None, **kwargs):
        _no_draws(eps, eps2)
        qf1, qu, pu = self.sf.prior(x[idx], **_groups_at(kwargs, idx))
        qf2, pf2 = self.cf.prior.batched(idx)
        py = self._combine(_log_mean(qf1), _log_mean(qf2), self.V_raw[idx])
        return py, qf1, qu, pu, qf2, pf2


class LegacyNSF(nn.Module):
    """The older NSF head: :class:`NSF`'s math over ``gp`` (the attribute
    is ``gp``, as in the JAX package), loadings ``W_raw`` (D, L) and size
    factors ``V_raw`` (N,)."""

    def __init__(self, gp, W_raw, V_raw):
        super().__init__()
        self.gp = gp
        self.W_raw = nn.Parameter(W_raw)
        self.V_raw = nn.Parameter(V_raw)

    @property
    def gp_prior(self):
        return self.gp

    def forward(self, x, eps, **kwargs):
        qf, qu, pu = self.gp(x, **kwargs)
        rate = softplus(self.V_raw) * _rate(self.W_raw, qf.sample(eps))
        return Poisson(rate), qf, qu, pu

    def batched(self, x, idx, eps, **kwargs):
        qf, qu, pu = self.gp(x[idx], **kwargs)
        rate = softplus(self.V_raw[idx]) * _rate(self.W_raw, qf.sample(eps))
        return Poisson(rate), qf, qu, pu


class LegacyHybridNSF(nn.Module):
    """The single-module hybrid: ``gp`` (L factors), loadings ``W_raw``
    (D, L) and ``W2_raw`` (D, T) used RAW, not softplus'd, which relies on
    the trainer clamping them at 0 after each step
    (:func:`gpzoo_tpu_torch.train.loop.clamp_nonnegative` as the step's
    ``project``); the mean-field half's means ``mF`` (T, N) and scales
    softplus(``scale_qF_raw``) (T, N) against N(0, 1); size factors
    ``V_raw`` (N,)."""

    def __init__(self, gp, W_raw, W2_raw, mF, scale_qF_raw, V_raw):
        super().__init__()
        self.gp = gp
        self.W_raw = nn.Parameter(W_raw)
        self.W2_raw = nn.Parameter(W2_raw)
        self.mF = nn.Parameter(mF)
        self.scale_qF_raw = nn.Parameter(scale_qF_raw)
        self.V_raw = nn.Parameter(V_raw)

    @property
    def gp_prior(self):
        return self.gp

    def _forward(self, qf, qf2, v_raw, eps, eps2):
        f_all = torch.cat((qf.sample(eps), qf2.sample(eps2)), dim=-2)
        w_all = torch.cat((self.W_raw, self.W2_raw), dim=-1)
        py = Poisson(softplus(v_raw) * _rate(w_all, f_all, apply_softplus=False))
        return py, Normal(torch.zeros_like(qf2.loc), torch.ones_like(qf2.scale))

    def forward(self, x, eps, eps2, **kwargs):
        qf, qu, pu = self.gp(x, **kwargs)
        qf2 = Normal(self.mF, softplus(self.scale_qF_raw))
        py, pf2 = self._forward(qf, qf2, self.V_raw, eps, eps2)
        return py, qf, qu, pu, qf2, pf2

    def batched(self, x, idx, eps, eps2, **kwargs):
        qf, qu, pu = self.gp(x[idx], **kwargs)
        qf2 = Normal(self.mF[:, idx], softplus(self.scale_qF_raw[:, idx]))
        py, pf2 = self._forward(qf, qf2, self.V_raw[idx], eps, eps2)
        return py, qf, qu, pu, qf2, pf2


class MGGPNSF(nn.Module):
    """NSF head over a multi-group GP: ``gp`` (an MGGPSVGP; the attribute
    is ``gp``, not ``prior``, as in the JAX package), loadings ``W_raw``
    (D, L) and size factors ``V_raw`` (N,). The group labels are
    keyword-only, as in the JAX head."""

    def __init__(self, gp, W_raw, V_raw):
        super().__init__()
        self.gp = gp
        self.W_raw = nn.Parameter(W_raw)
        self.V_raw = nn.Parameter(V_raw)

    @property
    def gp_prior(self):
        """The head's GP, whichever attribute holds it."""
        return self.gp

    def forward(self, x, eps, *, groups_x, **kwargs):
        """(Poisson(rate), qf, qu, pu) over all N rows of x; eps (E, L, N)."""
        qf, qu, pu = self.gp(x, groups_x, **kwargs)
        rate = softplus(self.V_raw) * _rate(self.W_raw, qf.sample(eps))
        return Poisson(rate), qf, qu, pu

    def batched(self, x, idx, eps, *, groups_x, **kwargs):
        """The GP at x[idx] with labels groups_x[idx]; eps (E, L, B)."""
        qf, qu, pu = self.gp(x[idx], groups_x[idx], **kwargs)
        rate = softplus(self.V_raw[idx]) * _rate(self.W_raw, qf.sample(eps))
        return Poisson(rate), qf, qu, pu
