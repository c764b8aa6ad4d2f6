"""The generic ELBO objectives (port of ``gpzoo_tpu/train/elbo.py``).

Each loss evaluates the head's generic forward (``model(...)`` over all
spots, ``model.batched(...)`` over the spots idx) and returns the negative
ELBO as a scalar tensor. The conventions of the JAX package are kept:

* the expected log-likelihood is the mean over the E draws, then the sum
  over every (D, N) entry;
* the ``*_batched`` losses default to the unnormalized Poisson
  log-likelihood ``y·log(rate) − rate`` and the full-batch ones to the
  normalized one; a Gaussian likelihood always normalizes;
* the KL is not rescaled by N/B on a minibatch;
* a whitened prior (``pu`` None) takes the closed-form KL against
  N(0, I), the low-rank one through the matrix determinant lemma.

The draws come in as arguments, standard normal, in the model's dtype:
``eps`` (E, L, n) for the GP half (or the PNMF prior; (E, n) for a
single-output GP), and ``eps2`` (E, T, n) for a hybrid's mean-field half,
n the spots the loss evaluates. ``E``, where given, must be their first
dimension.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from gpzoo_tpu_torch.bijectors import softplus
from gpzoo_tpu_torch.dists import LowRankMultivariateNormal, Normal, kl_divergence
from gpzoo_tpu_torch.ops.linalg import lowrank_whitened_kl, whitened_kl


def _gp_kl(qu, pu):
    """KL(qU ‖ pU) summed over factors; against N(0, I) when pu is None."""
    if pu is None:
        if isinstance(qu, LowRankMultivariateNormal):
            return torch.sum(lowrank_whitened_kl(qu.loc, qu.cov_factor, qu.cov_diag))
        return torch.sum(whitened_kl(qu.loc, qu.scale_tril))
    return torch.sum(kl_divergence(qu, pu))


def _expected_ll(py, y, unnormalized):
    """Σ over entries of the draw-averaged log-likelihood. Count
    likelihoods have the unnormalized form; a Gaussian always normalizes."""
    if unnormalized and hasattr(py, "unnormalized_log_prob"):
        lp = py.unnormalized_log_prob(y)
    else:
        lp = py.log_prob(y)
    return torch.sum(torch.mean(lp, dim=0))


def _check_draws(E, *draws):
    for eps in draws:
        if E is not None and eps is not None and eps.shape[0] != E:
            raise ValueError(f"draws have {eps.shape[0]} samples, E={E}")


def negative_elbo(model, x, y, eps, E=None, unnormalized=False, **kwargs):
    """Full-batch −ELBO of a GP head: ``model(x, eps, **kwargs)``."""
    _check_draws(E, eps)
    py, qf, qu, pu = model(x, eps, **kwargs)
    return -(_expected_ll(py, y, unnormalized) - _gp_kl(qu, pu))


def negative_elbo_batched(model, x, y, idx, eps, E=None, unnormalized=True,
                          remat=False, **kwargs):
    """Minibatch −ELBO: the GP at x[idx] only, the likelihood over
    y[:, idx]. ``remat=True`` recomputes the head's forward in the
    backward pass (``torch.utils.checkpoint``) instead of storing its
    (L, M, B)-sized intermediates."""
    if y.shape[-1] != x.shape[0]:
        raise ValueError(f"y has {y.shape[-1]} spots (last axis) but x has "
                         f"{x.shape[0]}: counts must be (D, N) aligned with X")
    _check_draws(E, eps)

    def fwd():
        return model.batched(x, idx, eps, **kwargs)

    py, qf, qu, pu = checkpoint(fwd, use_reentrant=False) if remat else fwd()
    return -(_expected_ll(py, y[:, idx], unnormalized) - _gp_kl(qu, pu))


def negative_elbo_hybrid(model, x, y, eps=None, eps2=None, E=None,
                         unnormalized=False, **kwargs):
    """Full-batch hybrid −ELBO, with the mean-field half's KL. A
    HybridNSFExact takes no draws."""
    _check_draws(E, eps, eps2)
    py, qf1, qu, pu, qf2, pf2 = model(x, eps, eps2, **kwargs)
    elbo = _expected_ll(py, y, unnormalized) - _gp_kl(qu, pu)
    return -(elbo - torch.sum(kl_divergence(qf2, pf2)))


def negative_elbo_hybrid_batched(model, x, y, idx, eps=None, eps2=None, E=None,
                                 unnormalized=True, **kwargs):
    """Minibatch hybrid −ELBO over the spots idx."""
    _check_draws(E, eps, eps2)
    py, qf1, qu, pu, qf2, pf2 = model.batched(x, idx, eps, eps2, **kwargs)
    elbo = _expected_ll(py, y[:, idx], unnormalized) - _gp_kl(qu, pu)
    return -(elbo - torch.sum(kl_divergence(qf2, pf2)))


def pnmf_negative_elbo(model, y, eps, E=None, unnormalized=False):
    """PNMF −ELBO: no GP; the KL is the mean-field Normal-Normal one."""
    _check_draws(E, eps)
    py, qf, pf = model(eps)
    return -(_expected_ll(py, y, unnormalized) - torch.sum(kl_divergence(qf, pf)))


def pnmf_negative_elbo_batched(model, y, idx, eps, E=None, unnormalized=True):
    """PNMF −ELBO over the spots idx."""
    _check_draws(E, eps)
    py, qf, pf = model.batched(idx, eps)
    return -(_expected_ll(py, y[:, idx], unnormalized)
             - torch.sum(kl_divergence(qf, pf)))


def gaussian_exact_negative_elbo(model, x, y, eps=None, E=None, **kwargs):
    """Analytic −ELBO of an :class:`ExactLikelihood`: log N(y | qF.mean,
    noise) with the variance correction − Σ qF.scale² / (2·noise²), noise =
    softplus(noise_raw). It takes no draws."""
    if eps is not None:
        raise ValueError("gaussian_exact_negative_elbo takes no draws (eps)")
    py, qf, qu, pu = model(x, **kwargs)
    noise = softplus(model.noise_raw)
    elbo = torch.sum(py.log_prob(y))
    elbo = elbo - torch.sum(torch.square(qf.scale)) / (2.0 * torch.square(noise))
    return -(elbo - _gp_kl(qu, pu))


def whitened_negative_elbo(model, x, y, eps, E=None, **kwargs):
    """−ELBO of a whitened GP under a Gaussian likelihood: the sampled
    expected log-likelihood and the whitened KL."""
    _check_draws(E, eps)
    py, qf, qu, pu = model(x, eps, **kwargs)
    elbo = _expected_ll(py, y, unnormalized=False)
    return -(elbo - torch.sum(whitened_kl(qu.loc, qu.scale_tril)))


def posterior_nll(qf, y_latent):
    """Gaussian negative log-likelihood of held-out latent values under the
    marginal posterior qF."""
    return -torch.sum(Normal(qf.loc, qf.scale).log_prob(y_latent))
