"""Held-out quality metric (port of ``poisson_deviance`` from
``gpzoo_tpu/data/metrics.py`` and of the held-out deviances in
``bench.py`` and ``benchmarks/mggp_anatomy.py``). Ported rather than
imported: ``gpzoo_tpu.data`` pulls in JAX through the package's
``__init__``."""

from __future__ import annotations

import torch

from gpzoo_tpu_torch.bijectors import softplus
from gpzoo_tpu_torch.predict import latent_posterior


def poisson_deviance(y, rate):
    """Mean per-entry Poisson deviance ``2[y log(y/μ) − (y − μ)]``."""
    d = 2.0 * (torch.where(y > 0,
                           y * torch.log(torch.clamp(y, min=1e-12) / rate),
                           torch.zeros_like(y)) - (y - rate))
    return torch.mean(d)


def plugin_rate_deviance(v_raw, w_raw, fmean, y_dv):
    """Deviance of the plug-in rate sp(V)·sp(W) exp(E[F]) against counts
    (D, B): v_raw (B,), w_raw (D, L), fmean (L, B). The one convention of
    every held-out deviance in ``bench.py``."""
    return poisson_deviance(y_dv, softplus(v_raw) * (softplus(w_raw) @ torch.exp(fmean)))


@torch.no_grad()
def held_out_deviance(model, proj, y_t, vidx):
    """Deviance on spots ``vidx`` with E[F] = μ ãᵀ from the precomputed
    projection and counts y_t stored spot-major (N, D)."""
    mu = model.prior.mu
    mu_l = mu if mu.ndim == 2 else mu[None]
    fmean = mu_l @ proj.proj_t[vidx].T  # (L, B)
    return plugin_rate_deviance(model.V_raw[vidx], model.W_raw, fmean,
                                y_t[vidx].T)


@torch.no_grad()
def posterior_deviance(model, x, y_t, vidx, groups=None):
    """Deviance on spots ``vidx`` with E[F] from the model's GP posterior
    at those spots alone (``predict.latent_posterior`` over x[vidx], with
    their group labels for an MGGP model) and counts y_t stored spot-major
    (N, D): the held-out deviance of the JAX MGGP benchmark
    (benchmarks/mggp_anatomy.py ``_val_deviance``)."""
    fmean, _ = latent_posterior(model.gp_prior, x[vidx],
                                None if groups is None else groups[vidx])
    return plugin_rate_deviance(model.V_raw[vidx], model.W_raw, fmean,
                                y_t[vidx].T)


@torch.no_grad()
def posterior_mean_deviance(model, fmean, y_t, vidx):
    """Deviance on spots ``vidx`` with E[F] from a posterior mean over all
    spots, fmean (L, N) (``predict.latent_posterior``), and counts y_t
    stored spot-major (N, D)."""
    return plugin_rate_deviance(model.V_raw[vidx], model.W_raw,
                                fmean[..., vidx], y_t[vidx].T)
