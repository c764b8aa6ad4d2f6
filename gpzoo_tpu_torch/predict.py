"""Posterior extraction (port of ``latent_posterior`` from
``gpzoo_tpu/predict.py``)."""

from __future__ import annotations

import torch


def latent_posterior(gp, x, chunk_size=None, mesh=None):
    """qF's marginal (mean, scale) of ``gp`` at all N rows of x, as (L, N)
    or (N,) tensors. ``chunk_size`` evaluates the spot axis in blocks of
    that many rows to bound memory (default: all at once). Sharding over
    a device mesh (``mesh=``) is not ported."""
    if mesh is not None:
        raise NotImplementedError("latent_posterior over a mesh is not ported")
    n = x.shape[0]
    if chunk_size is None or chunk_size >= n:
        qf, _, _ = gp(x)
        return qf.loc, qf.scale
    means, scales = [], []
    for start in range(0, n, chunk_size):
        qf, _, _ = gp(x[start:start + chunk_size])
        means.append(qf.loc)
        scales.append(qf.scale)
    return torch.cat(means, dim=-1), torch.cat(scales, dim=-1)
