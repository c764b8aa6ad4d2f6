"""The port's sparse Moran graph (``data.metrics._knn_graph``, built a block
of rows at a time) against the JAX package's dense ``_knn_weights``, on the
CPU, with coordinates drawn by numpy from a seed: the same nonzero entries
at 1e-15, Moran's I at 1e-12 (relative) and the same ``dims_autocorr``
order, over N (200, 4,000 uniform points; a 40 x 40 integer pixel grid,
whose exact ties every arithmetic keeps), n_neighs, the coordinates'
dtype, the block size (1, 7, which divides no N here, and all rows) and
numpy or CPU-tensor input. The card's route (``_device_neighbours``) runs
here on CPU tensors: the same neighbour sets off the grid, and on it a
valid choice among the tied k-th neighbours.
"""

from __future__ import annotations

import functools
import tracemalloc

import numpy as np
import pytest
import torch

from gpzoo_tpu.data import metrics as jm

from gpzoo_tpu_torch.data import metrics as tm

CASES = ("uniform200", "uniform4000", "grid1600")
TOL_W = 1e-15
TOL_I = 1e-12


@functools.lru_cache(maxsize=None)
def _coords(case, dtype):
    if case == "grid1600":
        side = np.arange(40)
        grid = np.stack(np.meshgrid(side, side), axis=-1).reshape(-1, 2)
        return grid.astype(dtype)
    n = int(case.removeprefix("uniform"))
    return np.random.default_rng(n).uniform(-2.0, 2.0, (n, 2)).astype(dtype)


def _values(coords):
    """Four variables over the points: two smooth fields, one with a
    period across the grid, and noise."""
    c = coords.astype(np.float64)
    rng = np.random.default_rng(7)
    return np.stack([np.sin(c[:, 0]), c[:, 1] ** 2, np.cos(3.0 * c[:, 0] + c[:, 1]),
                     rng.standard_normal(c.shape[0])], axis=1)


@functools.lru_cache(maxsize=None)
def _reference(case, n_neighs, dtype):
    """(nonzero rows, cols, values) of JAX's dense weights, row-major, and
    JAX's Moran's I of :func:`_values`."""
    coords = _coords(case, dtype)
    w = jm._knn_weights(coords, n_neighs=n_neighs)
    rows, cols = np.nonzero(w)
    return rows, cols, w[rows, cols], jm.morans_i(_values(coords), weights=w)


def _chunk(chunk, n):
    return n if chunk == "all" else chunk


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
@pytest.mark.parametrize("chunk", [1, 7, "all"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n_neighs", [4, 6])
@pytest.mark.parametrize("case", CASES)
def test_graph_matches_jax_dense(case, n_neighs, dtype, chunk, as_tensor):
    """The sparse graph's entries are the dense weights' nonzeros (the
    densified graph equals ``_knn_weights``), and Moran's I over it is
    JAX's."""
    coords = _coords(case, dtype)
    rows, cols, vals, moran = _reference(case, n_neighs, dtype)
    arg = torch.from_numpy(coords) if as_tensor else coords
    graph = tm._knn_graph(arg, n_neighs, _chunk(chunk, coords.shape[0]))
    got_rows, got_cols, got_vals = (t.numpy() for t in graph)
    np.testing.assert_array_equal(got_rows, rows)
    np.testing.assert_array_equal(got_cols, cols)
    np.testing.assert_allclose(got_vals, vals, rtol=0, atol=TOL_W)
    np.testing.assert_allclose(tm.morans_i(_values(coords), weights=graph), moran,
                               rtol=TOL_I, atol=0)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
@pytest.mark.parametrize("n_neighs", [4, 6])
@pytest.mark.parametrize("case", CASES)
def test_morans_i_and_ranking_match_jax(case, n_neighs, as_tensor):
    """``morans_i`` (vector and scalar) and ``dims_autocorr`` (sorted and
    not) through their default graph, against JAX's dense ones."""
    coords = _coords(case, np.float32)
    values = _values(coords)
    arg = (lambda a: torch.from_numpy(a)) if as_tensor else (lambda a: a)
    np.testing.assert_allclose(tm.morans_i(arg(values), arg(coords), n_neighs=n_neighs),
                               jm.morans_i(values, coords, n_neighs=n_neighs),
                               rtol=TOL_I, atol=0)
    scalar = tm.morans_i(arg(values[:, 0]), arg(coords), n_neighs=n_neighs)
    assert np.ndim(scalar) == 0
    np.testing.assert_allclose(scalar, jm.morans_i(values[:, 0], coords, n_neighs=n_neighs),
                               rtol=TOL_I, atol=0)
    for sort in (True, False):
        idx, vals = tm.dims_autocorr(arg(values), arg(coords), sort=sort, n_neighs=n_neighs)
        j_idx, j_vals = jm.dims_autocorr(values, coords, sort=sort, n_neighs=n_neighs)
        np.testing.assert_array_equal(idx, j_idx)
        np.testing.assert_allclose(vals, j_vals, rtol=TOL_I, atol=0)


def _distances(coords, nbr):
    """Each point's squared distances to its neighbours, sorted, in float64."""
    c = coords.astype(np.float64)
    return np.sort(np.sum((c[nbr] - c[:, None]) ** 2, axis=-1), axis=1)


@pytest.mark.parametrize("chunk", [1, 7, "all"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", CASES)
def test_card_route_on_cpu_tensors(case, dtype, chunk):
    """The card's neighbour search (``topk`` over IEEE d² blocks) run on CPU
    tensors: the host route's neighbour sets off the grid; on the grid,
    where ``topk`` may break the exact ties at the k-th neighbour otherwise,
    the same neighbour distances, each no farther than the k-th."""
    coords = _coords(case, dtype)
    n_neighs = 6
    host = tm._knn_neighbours(coords, n_neighs).numpy()
    card = tm._device_neighbours(torch.from_numpy(coords), n_neighs,
                                 _chunk(chunk, coords.shape[0])).numpy()
    assert card.shape == host.shape and card.dtype == np.int64
    assert not (card == np.arange(len(coords))[:, None]).any()
    if case == "grid1600":
        np.testing.assert_array_equal(_distances(coords, card), _distances(coords, host))
    else:
        np.testing.assert_array_equal(np.sort(card, axis=1), np.sort(host, axis=1))


@pytest.mark.parametrize("fn", ["morans_i", "dims_autocorr"])
def test_no_dense_matrix_on_the_host(fn):
    """The host route's numpy allocations stay below one dense N x N
    float64 matrix (the dense weights allocate several) at N = 4,000."""
    coords = _coords("uniform4000", np.float32)
    values = _values(coords)
    tracemalloc.start()
    try:
        getattr(tm, fn)(values, coords)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert peak < 8 * coords.shape[0] ** 2, peak
