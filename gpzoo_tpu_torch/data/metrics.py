"""Quality metrics (port of ``gpzoo_tpu/data/metrics.py`` and of the
held-out deviances in ``bench.py`` and ``benchmarks/mggp_anatomy.py``).
Ported rather than imported: ``gpzoo_tpu.data`` pulls in JAX through the
package's ``__init__``.

The spatial-autocorrelation metrics (:func:`morans_i`,
:func:`dims_autocorr`) and :func:`best_match_correlation` run on the host
in numpy (and scipy's assignment solver), as in the JAX package. Their
KNN weights are a dense N×N float64 matrix: 128 MB at N = 4,000, 16 GB
at N = 45,000.
"""

from __future__ import annotations

import numpy as np
import torch

from gpzoo_tpu_torch.bijectors import softplus
from gpzoo_tpu_torch.predict import latent_posterior


def poisson_deviance(y, rate):
    """Mean per-entry Poisson deviance ``2[y log(y/μ) − (y − μ)]``."""
    d = 2.0 * (torch.where(y > 0,
                           y * torch.log(torch.clamp(y, min=1e-12) / rate),
                           torch.zeros_like(y)) - (y - rate))
    return torch.mean(d)


def plugin_rate_deviance(v_raw, halves, y_dv):
    """Deviance of the plug-in rate sp(V)·Σᵢ sp(Wᵢ) exp(E[Fᵢ]) against
    counts (D, B): v_raw (B,), ``halves`` a list of (w_raw (D, Lᵢ),
    fmean (Lᵢ, B)), one for NSF and two for a hybrid. The one convention
    of every held-out deviance in ``bench.py``."""
    rate = sum(softplus(w_raw) @ torch.exp(fmean) for w_raw, fmean in halves)
    return poisson_deviance(y_dv, softplus(v_raw) * rate)


@torch.no_grad()
def held_out_deviance(model, proj, y_t, vidx):
    """Deviance on spots ``vidx`` with E[F] = μ ãᵀ from the precomputed
    projection and counts y_t stored spot-major (N, D). For a whitened
    prior ã is the whitened a = Lzz⁻¹Kzx, which pairs with its whitened μ,
    so the same product gives E[F]."""
    mu = model.prior.mu
    mu_l = mu if mu.ndim == 2 else mu[None]
    fmean = mu_l @ proj.proj_t[vidx].T  # (L, B)
    return plugin_rate_deviance(model.V_raw[vidx], [(model.W_raw, fmean)],
                                y_t[vidx].T)


@torch.no_grad()
def hybrid_posterior_deviance(model, x, y_t, vidx, groups=None):
    """Deviance of a hybrid head on spots ``vidx``: the spatial half's E[F₁]
    from its GP posterior at those spots (with their labels ``groups[vidx]``
    for a multi-group prior), the mean-field half's E[F₂] its mean at those
    spots, and counts y_t stored spot-major (N, D) (bench.py
    ``_hybrid_val_deviance``)."""
    fmean, _ = latent_posterior(model.sf.prior, x[vidx],
                                None if groups is None else groups[vidx])
    return plugin_rate_deviance(
        model.V_raw[vidx], [(model.sf.W_raw, fmean),
                            (model.cf.W_raw, model.cf.prior.mean[:, vidx])],
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
    return plugin_rate_deviance(model.V_raw[vidx], [(model.W_raw, fmean)],
                                y_t[vidx].T)


@torch.no_grad()
def posterior_mean_deviance(model, fmean, y_t, vidx):
    """Deviance on spots ``vidx`` with E[F] from a posterior mean over all
    spots, fmean (L, N) (``predict.latent_posterior``), and counts y_t
    stored spot-major (N, D)."""
    return plugin_rate_deviance(model.V_raw[vidx],
                                [(model.W_raw, fmean[..., vidx])], y_t[vidx].T)


def _knn_weights(coords, n_neighs=6):
    """Row-normalized symmetrized KNN adjacency (squidpy-style weights)."""
    coords = np.asarray(coords)
    n = coords.shape[0]
    d2 = (np.sum(coords**2, axis=1)[:, None] - 2.0 * coords @ coords.T
          + np.sum(coords**2, axis=1)[None, :])
    np.fill_diagonal(d2, np.inf)
    nbr = np.argpartition(d2, n_neighs, axis=1)[:, :n_neighs]
    w = np.zeros((n, n), dtype=np.float64)
    w[np.repeat(np.arange(n), n_neighs), nbr.ravel()] = 1.0
    w = np.maximum(w, w.T)  # symmetrize (mutual neighbours counted once)
    row_sums = w.sum(axis=1, keepdims=True)
    row_sums[row_sums == 0] = 1.0
    return w / row_sums


def morans_i(values, coords=None, weights=None, n_neighs=6):
    """Moran's I of one or more variables over spatial coordinates:
    values (N,) or (N, P) → a scalar or (P,);
    I = (N/ΣW) · (zᵀ W z) / (zᵀ z), z the centred variable."""
    v = np.asarray(values, dtype=np.float64)
    squeeze = v.ndim == 1
    if squeeze:
        v = v[:, None]
    if weights is None:
        weights = _knn_weights(coords, n_neighs=n_neighs)
    z = v - v.mean(axis=0, keepdims=True)
    num = np.einsum("np,nm,mp->p", z, weights, z)
    i = (v.shape[0] / weights.sum()) * num / np.sum(z * z, axis=0)
    return i[0] if squeeze else i


def dims_autocorr(factors, coords, sort=True, n_neighs=6):
    """Rank latent dimensions by Moran's I: factors (N, L), coords (N, D)
    → (idx, I), ``factors[:, idx]`` in decreasing spatial autocorrelation
    when ``sort``."""
    i_vals = morans_i(factors, coords, n_neighs=n_neighs)
    idx = np.argsort(-i_vals) if sort else np.arange(len(i_vals))
    return idx, i_vals[idx] if sort else i_vals


def best_match_correlation(true_components, factors):
    """Pearson correlation of each row of ``true_components`` with a
    distinct row of ``factors``, matched by the assignment that maximizes
    their sum (scipy's Hungarian solver; without scipy, greedy matching in
    the true components' order). ``factors`` needs at least as many rows."""
    try:
        from scipy.optimize import linear_sum_assignment
    except ImportError:
        linear_sum_assignment = None

    p = np.asarray(true_components, np.float64)
    f = np.asarray(factors, np.float64)
    if f.shape[0] < p.shape[0]:
        raise ValueError(f"need >= {p.shape[0]} factors to match without "
                         f"replacement, got {f.shape[0]}")
    p = p - p.mean(axis=1, keepdims=True)
    f = f - f.mean(axis=1, keepdims=True)
    corr = (p @ f.T) / (np.linalg.norm(p, axis=1)[:, None]
                        * np.linalg.norm(f, axis=1)[None, :] + 1e-12)
    if linear_sum_assignment is not None:
        rows, cols = linear_sum_assignment(-corr)
        return corr[rows, cols]
    taken = np.zeros(f.shape[0], bool)
    out = np.empty(p.shape[0])
    for i in range(p.shape[0]):
        j = int(np.argmax(np.where(taken, -np.inf, corr[i])))
        taken[j] = True
        out[i] = corr[i, j]
    return out
