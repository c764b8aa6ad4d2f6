"""Quality metrics (port of ``gpzoo_tpu/data/metrics.py`` and of the
held-out deviances in ``bench.py`` and ``benchmarks/mggp_anatomy.py``).
Ported rather than imported: ``gpzoo_tpu.data`` pulls in JAX through the
package's ``__init__``.

The spatial-autocorrelation metrics (:func:`morans_i`,
:func:`dims_autocorr`) build the JAX package's KNN graph sparsely, a block
of rows at a time (:func:`_knn_graph`: 317,838 entries for the 45,000
seed-0 spots of ``simulate_nsf_counts``, where the JAX package's dense
weights take 16 GB), on the device of the
coordinates: numpy arrays and CPU tensors on the host, CUDA tensors on
their card. :func:`_knn_weights`, the JAX package's dense form, stays as
the reference. :func:`best_match_correlation` runs on the host in numpy
(and scipy's assignment solver), as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gpzoo_tpu_torch.bijectors import softplus
from gpzoo_tpu_torch.ops import precision
from gpzoo_tpu_torch.predict import latent_posterior

#: rows of the neighbour search's squared distances held at a time: a
#: (1,024, N) block, 184 MB in float32 at N = 45,000
KNN_CHUNK = 1024


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
def hybrid_posterior_deviance(model, x, y_t, vidx, groups=None, chunk_size=None):
    """Deviance of a hybrid head on spots ``vidx``: the spatial half's E[F₁]
    from its GP posterior at those spots (with their labels ``groups[vidx]``
    for a multi-group prior; ``chunk_size`` spots at a time, as
    ``predict.latent_posterior`` takes it), the mean-field half's E[F₂] its
    mean at those spots, and counts y_t stored spot-major (N, D) (bench.py
    ``_hybrid_val_deviance``)."""
    fmean, _ = latent_posterior(model.sf.prior, x[vidx],
                                None if groups is None else groups[vidx], chunk_size)
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


def _knn_neighbours(coords, n_neighs=6, chunk=KNN_CHUNK):
    """The ``n_neighs`` nearest other points of each of the N points of
    coords (N, D), as an (N, n_neighs) int64 tensor of indices in no
    order, on the coordinates' device (the CPU for numpy): the
    neighbour sets of :func:`_knn_weights`, whose d² = ‖a‖² − 2a·b + ‖b‖²
    this computes in the coordinates' own dtype, in that order, for
    ``chunk`` rows at a time, with the diagonal at +inf.

    A numpy array or a CPU tensor takes the host route: numpy's product
    and ``argpartition`` per block of rows, as the dense form does over
    all rows. BLAS may tile a block of rows otherwise than the whole
    product, so a d² may differ from the dense one in its last bit and a
    near-tie within that bit may fall otherwise; exact ties (a pixel grid)
    give the same values and the same selection. A CUDA tensor takes the
    card's route: the product in IEEE arithmetic (TF32 off, whose 10-bit
    mantissa on ‖a‖² ≈ 8 errs by ~4e-3 where neighbours lie ~4e-4 apart at
    N = 45,000) and ``torch.topk``, which may break an exact tie at the
    k-th neighbour otherwise than ``argpartition``."""
    if isinstance(coords, torch.Tensor) and coords.device.type != "cpu":
        return _device_neighbours(coords, n_neighs, chunk)
    c = coords.detach().numpy() if isinstance(coords, torch.Tensor) else np.asarray(coords)
    n = c.shape[0]
    sq = np.sum(c**2, axis=1)
    nbr = np.empty((n, n_neighs), np.int64)
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        d2 = sq[start:stop, None] - 2.0 * c[start:stop] @ c.T + sq[None, :]
        d2[np.arange(stop - start), np.arange(start, stop)] = np.inf
        nbr[start:stop] = np.argpartition(d2, n_neighs, axis=1)[:, :n_neighs]
    return torch.from_numpy(nbr)


def _device_neighbours(coords, n_neighs, chunk):
    """:func:`_knn_neighbours` on the coordinates' card."""
    n = coords.shape[0]
    sq = torch.sum(coords**2, dim=1)
    nbr = torch.empty((n, n_neighs), dtype=torch.int64, device=coords.device)
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        rows = torch.arange(stop - start, device=coords.device)
        d2 = (sq[start:stop, None]
              - 2.0 * precision.mm(coords[start:stop], coords.T, "highest") + sq[None, :])
        d2[rows, rows + start] = math.inf
        nbr[start:stop] = torch.topk(d2, n_neighs, dim=1, largest=False,
                                     sorted=False).indices
    return nbr


def _knn_graph(coords, n_neighs=6, chunk=KNN_CHUNK):
    """:func:`_knn_weights` as (rows, cols, values) of its nonzero entries,
    sorted by row then column, on the device :func:`_knn_neighbours` takes
    (the host for numpy input): the KNN edges and their reverses, a mutual
    pair once (``np.maximum(w, w.T)``), each row divided by its degree in
    float64."""
    return _symmetrize(_knn_neighbours(coords, n_neighs, chunk))


def _symmetrize(nbr):
    """:func:`_knn_graph` of the neighbour sets nbr (N, k)."""
    n = nbr.shape[0]
    own = torch.arange(n, device=nbr.device)[:, None]
    keys = torch.unique(torch.cat([(own * n + nbr).ravel(), (nbr * n + own).ravel()]))
    rows = keys // n
    degree = torch.bincount(rows, minlength=n).to(torch.float64)
    return rows, keys % n, 1.0 / degree[rows]


def morans_i(values, coords=None, weights=None, n_neighs=6):
    """Moran's I of one or more variables over spatial coordinates:
    values (N,) or (N, P) → a scalar or (P,) as numpy;
    I = (N/ΣW) · (zᵀ W z) / (zᵀ z), z the centred variable. ``weights``
    is a dense (N, N) matrix or :func:`_knn_graph`'s (rows, cols, values);
    by default the latter, built from ``coords`` on their device, where
    zᵀ W z is then summed over the edges in float64."""
    if weights is None:
        weights = _knn_graph(coords, n_neighs=n_neighs)
    if isinstance(weights, tuple):
        return _graph_morans_i(values, *weights)
    v = np.asarray(values, dtype=np.float64)
    squeeze = v.ndim == 1
    if squeeze:
        v = v[:, None]
    z = v - v.mean(axis=0, keepdims=True)
    num = np.einsum("np,nm,mp->p", z, weights, z)
    i = (v.shape[0] / weights.sum()) * num / np.sum(z * z, axis=0)
    return i[0] if squeeze else i


def _graph_morans_i(values, rows, cols, w):
    """:func:`morans_i` over a graph's (rows, cols, values), in float64 on
    the graph's device."""
    v = torch.as_tensor(values).to(rows.device, torch.float64)
    squeeze = v.ndim == 1
    if squeeze:
        v = v[:, None]
    z = v - v.mean(dim=0, keepdim=True)
    num = torch.sum(w[:, None] * z[rows] * z[cols], dim=0)
    i = ((v.shape[0] / w.sum()) * num / torch.sum(z * z, dim=0)).cpu().numpy()
    return i[0] if squeeze else i


def dims_autocorr(factors, coords, sort=True, n_neighs=6):
    """Rank latent dimensions by Moran's I: factors (N, L), coords (N, D)
    → (idx, I) as numpy, ``factors[:, idx]`` in decreasing spatial
    autocorrelation when ``sort``; the KNN graph is built on the device of
    ``coords`` (:func:`morans_i`)."""
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
