"""Posterior extraction (port of ``latent_posterior`` and
``extract_factors`` from ``gpzoo_tpu/predict.py``)."""

from __future__ import annotations

import torch


def latent_posterior(gp, x, groups=None, chunk_size=None, mesh=None,
                     shardings=None):
    """qF's marginal (mean, scale) of ``gp`` at all N rows of x, as (L, N)
    or (N,) tensors. ``groups`` (N,) are the labels of an MGGP GP, passed
    to it beside x and chunked with it. ``chunk_size`` evaluates the spot
    axis in blocks of that many rows to bound memory (default: all at
    once).

    ``mesh``: a mesh with a ``"data"`` axis (``gpzoo_tpu_torch.parallel``)
    over which the spot axis is split: N is padded to a multiple of the
    axis size, each rank runs the forward on its block of rows (and
    groups) with its replica of ``gp``, and the (L, N) mean and scale are
    gathered to every rank (an exact all-reduce each) and trimmed.
    ``chunk_size`` is ignored with a mesh, as in the JAX package: a rank's
    working set is already the whole one over the axis size.

    ``shardings``: the :class:`~gpzoo_tpu_torch.parallel.sharding.
    FactorShardings` of a ``gp`` split by ``shard_factor_params`` (the
    port's tensors do not carry their layout as JAX's do). The GP is then
    gathered whole on every rank before the forward, as the JAX package
    replicates it, and every rank gets the whole (L, N)."""
    if shardings is not None:
        if mesh is None:
            raise ValueError("shardings requires mesh")
        from gpzoo_tpu_torch.parallel.sharding import gather_factor_params

        gp = gather_factor_params(gp, shardings)

    def one(xc, gc):
        qf, _, _ = gp(xc) if gc is None else gp(xc, gc)
        return qf.loc, qf.scale

    n = x.shape[0]
    if mesh is not None:
        return _sharded_forward(one, x, groups, mesh)
    if chunk_size is None or chunk_size >= n:
        return one(x, groups)
    means, scales = [], []
    for start in range(0, n, chunk_size):
        c = slice(start, start + chunk_size)
        mean, scale = one(x[c], None if groups is None else groups[c])
        means.append(mean)
        scales.append(scale)
    return torch.cat(means, dim=-1), torch.cat(scales, dim=-1)


def _sharded_forward(one, x, groups, mesh):
    """:func:`latent_posterior` over the mesh's "data" axis."""
    from gpzoo_tpu_torch.parallel.collectives import gather_factors
    from gpzoo_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size

    if "data" not in mesh.mesh_dim_names:
        raise ValueError(f"mesh {mesh.mesh_dim_names} has no 'data' axis")
    n, parts = x.shape[0], axis_size(mesh, "data")
    rows = -(-n // parts)
    pad = rows * parts - n
    x_p = torch.nn.functional.pad(x, (0, 0, 0, pad))
    g_p = None if groups is None else torch.nn.functional.pad(groups, (0, pad))
    r = axis_index(mesh, "data")
    block = slice(r * rows, (r + 1) * rows)
    mean, scale = one(x_p[block], None if g_p is None else g_p[block])
    group = axis_group(mesh, "data")
    # the exact all-reduce gather of the factor axis, here along the spots
    return (gather_factors(mean, group, dim=-1)[..., :n],
            gather_factors(scale, group, dim=-1)[..., :n])


@torch.no_grad()
def extract_factors(model, x, groups=None, chunk_size=None, coords=None):
    """NSF factor extraction and Moran's I ranking (the north-star
    notebook's cells 32-33): (factors (L, N) = exp(qF mean) as a numpy
    array, the factor order by Moran's I, the Moran's I values). ``coords``
    (default ``x``) are the positions of the ranking's KNN graph, which is
    built sparsely on their device (``data.metrics._knn_graph``), so the
    ranking of x on the card stays on the card."""
    from gpzoo_tpu_torch.data.metrics import dims_autocorr

    gp = model.prior if hasattr(model, "prior") else model.gp
    mean, _ = latent_posterior(gp, x, groups=groups, chunk_size=chunk_size)
    factors = torch.exp(mean)
    idx, morans = dims_autocorr(factors.T, x if coords is None else coords)
    return factors.cpu().numpy(), idx, morans
