"""Posterior extraction (port of ``latent_posterior`` and
``extract_factors`` from ``gpzoo_tpu/predict.py``)."""

from __future__ import annotations

import numpy as np
import torch


def latent_posterior(gp, x, groups=None, chunk_size=None, mesh=None):
    """qF's marginal (mean, scale) of ``gp`` at all N rows of x, as (L, N)
    or (N,) tensors. ``groups`` (N,) are the labels of an MGGP GP, passed
    to it beside x and chunked with it. ``chunk_size`` evaluates the spot
    axis in blocks of that many rows to bound memory (default: all at
    once). Sharding over a device mesh (``mesh=``) is not ported."""
    if mesh is not None:
        raise NotImplementedError("latent_posterior over a mesh is not ported")

    def one(xc, gc):
        qf, _, _ = gp(xc) if gc is None else gp(xc, gc)
        return qf.loc, qf.scale

    n = x.shape[0]
    if chunk_size is None or chunk_size >= n:
        return one(x, groups)
    means, scales = [], []
    for start in range(0, n, chunk_size):
        c = slice(start, start + chunk_size)
        mean, scale = one(x[c], None if groups is None else groups[c])
        means.append(mean)
        scales.append(scale)
    return torch.cat(means, dim=-1), torch.cat(scales, dim=-1)


@torch.no_grad()
def extract_factors(model, x, groups=None, chunk_size=None, coords=None):
    """NSF factor extraction and Moran's I ranking (the north-star
    notebook's cells 32-33): (factors (L, N) = exp(qF mean) as a numpy
    array, the factor order by Moran's I, the Moran's I values). ``coords``
    (default ``x``) are the positions of the ranking's KNN graph. The
    ranking runs on the host over a dense N×N float64 weight matrix (16 GB
    at N = 45,000), so pass a subset of the spots at that scale."""
    from gpzoo_tpu_torch.data.metrics import dims_autocorr

    gp = model.prior if hasattr(model, "prior") else model.gp
    mean, _ = latent_posterior(gp, x, groups=groups, chunk_size=chunk_size)
    factors = np.exp(mean.cpu().numpy())
    ref = x if coords is None else coords
    ref = ref.cpu().numpy() if isinstance(ref, torch.Tensor) else np.asarray(ref)
    idx, morans = dims_autocorr(factors.T, ref)
    return factors, idx, morans
