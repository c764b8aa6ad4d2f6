"""The port's host data helpers (``data/{preprocess,nmf_init,io,plotting}``),
``utils``, ``train.snapshot.PosteriorSnapshotter`` and
``predict.extract_factors`` against the JAX package's, on the same numpy
inputs (CPU, float64); JAX models are carried over through
``gpzoo_tpu_torch.convert``."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpzoo_tpu as gz
from gpzoo_tpu import utils as jutils
from gpzoo_tpu.data import io as jio
from gpzoo_tpu.data import nmf_init as jnmf
from gpzoo_tpu.data import plotting as jplotting
from gpzoo_tpu.data import preprocess as jprep
from gpzoo_tpu.predict import extract_factors as j_extract
from gpzoo_tpu.train.loop import _path_str
from gpzoo_tpu.train.snapshot import PosteriorSnapshotter as JSnapshotter

import gpzoo_tpu_torch as gt
from gpzoo_tpu_torch import utils
from gpzoo_tpu_torch.convert import nsf_from_numpy
from gpzoo_tpu_torch.data import io, nmf_init, plotting, preprocess
from gpzoo_tpu_torch.predict import extract_factors
from gpzoo_tpu_torch.train.snapshot import PosteriorSnapshotter

N, D, L, M = 150, 12, 3, 16
TOL = 1e-8


def jax_leaves(model):
    return {_path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(model)[0]}


def _equal_trees(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("sz", ["constant", "mean", "scanpy"])
def test_preprocess_matches_jax(sz):
    rng = np.random.default_rng(1)
    coords = rng.uniform(10, 500, (80, 2))
    counts = rng.poisson(4.0, (80, 9)).astype(np.float64)
    np.testing.assert_array_equal(preprocess.rescale_spatial_coords(coords),
                                  jprep.rescale_spatial_coords(coords))
    np.testing.assert_array_equal(preprocess.scanpy_sizefactors(counts),
                                  jprep.scanpy_sizefactors(counts))
    for frac in (0.8, 1.0):
        got = preprocess.arrays_to_train_val(coords, counts, train_frac=frac, sz=sz,
                                             flip_yaxis=True)
        expect = jprep.arrays_to_train_val(coords, counts, train_frac=frac, sz=sz,
                                           flip_yaxis=True)
        for g, e in zip(got, expect):
            _equal_trees(g, e)

    class AnnDataLike:
        def __init__(self, x, y):
            self.obsm, self.X, self.layers = {"spatial": x}, y, {"raw": 2 * y}

        def __getitem__(self, key):
            return AnnDataLike(self.obsm["spatial"], self.X[key])

    ad = AnnDataLike(coords, counts)
    for kw in ({"nfeat": 5}, {"layer": "raw"}):
        for g, e in zip(preprocess.anndata_to_train_val(ad, sz=sz, **kw),
                        jprep.anndata_to_train_val(ad, sz=sz, **kw)):
            _equal_trees(g, e)
    with pytest.raises(ValueError):
        preprocess.arrays_to_train_val(coords, counts, sz="nope")


def test_nmf_init_matches_jax():
    """The regularized NMF (sklearn's, seeded) and the spatial smoothing
    (sklearn's regressions) give JAX's arrays exactly."""
    rng = np.random.default_rng(2)
    y = rng.poisson(3.0, (100, 15)).astype(np.float64)
    x = rng.uniform(-1, 1, (100, 2))
    z = rng.uniform(-1, 1, (10, 2))
    kw = dict(init="nndsvda", max_iter=200, random_state=0)
    for got, expect in zip(nmf_init.regularized_nmf(y, 4, **kw),
                           jnmf.regularized_nmf(y, 4, **kw)):
        np.testing.assert_array_equal(got, expect)
    f, w = rng.uniform(0.1, 2, (100, 4)), rng.uniform(0.1, 2, (15, 4))
    for got, expect in zip(
            nmf_init.regularized_nmf(y, 4, sz=2.0, factors=f, loadings=w),
            jnmf.regularized_nmf(y, 4, sz=2.0, factors=f, loadings=w)):
        np.testing.assert_array_equal(got, expect)
    fl = np.log(f)
    for xs in (x, None):
        for got, expect in zip(nmf_init.smooth_spatial_factors(fl, z, xs),
                               jnmf.smooth_spatial_factors(fl, z, xs)):
            if expect is None:
                assert got is None
            else:
                np.testing.assert_array_equal(got, expect)
    assert nmf_init.lnormal_approx_dirichlet(7) == jnmf.lnormal_approx_dirichlet(7)
    np.testing.assert_array_equal(nmf_init.shrink_factors(f), jnmf.shrink_factors(f))
    np.testing.assert_array_equal(nmf_init.shrink_loadings(w), jnmf.shrink_loadings(w))


def _write_h5ad(path, x, coords, codes, csr, old_categorical):
    import h5py
    from scipy import sparse

    with h5py.File(path, "w") as f:
        if csr:
            sp = sparse.csr_matrix(x)
            g = f.create_group("X")
            g.attrs["encoding-type"] = "csr_matrix"
            g.attrs["shape"] = np.array(x.shape)
            for name in ("data", "indices", "indptr"):
                g.create_dataset(name, data=getattr(sp, name))
        else:
            f.create_dataset("X", data=x)
        f.create_dataset("obsm/spatial", data=coords)
        cats = np.array([b"a", b"b", b"c"])
        if old_categorical:
            f.create_dataset("obs/cluster", data=codes)
            f.create_dataset("obs/__categories/cluster", data=cats)
        else:
            g = f.create_group("obs/cluster")
            g.attrs["encoding-type"] = "categorical"
            g.create_dataset("codes", data=codes)
            g.create_dataset("categories", data=cats)
        f.create_dataset("obs/depth", data=np.arange(x.shape[0], dtype=np.float32))


@pytest.mark.parametrize("csr,old_categorical", [(False, False), (True, True)])
def test_h5ad_reader_matches_jax(tmp_path, csr, old_categorical):
    rng = np.random.default_rng(3)
    n, d = 60, 10
    x = rng.poisson(3.0, (n, d)).astype(np.float32)
    coords = rng.uniform(0, 100, (n, 2)).astype(np.float32)
    codes = rng.integers(0, 3, n).astype(np.int8)
    path = str(tmp_path / "data.h5ad")
    _write_h5ad(path, x, coords, codes, csr, old_categorical)
    cols = ("cluster", "depth")
    got, expect = io.read_h5ad(path, obs_columns=cols), jio.read_h5ad(path, obs_columns=cols)
    np.testing.assert_array_equal(got["X"], expect["X"])
    np.testing.assert_array_equal(got["X"], x)
    np.testing.assert_array_equal(got["spatial"], expect["spatial"])
    for name in cols:
        for g, e in zip(got["obs"][name], expect["obs"][name]):
            assert (g is None) == (e is None)
            if e is not None:
                np.testing.assert_array_equal(g, e)
    kw = dict(train_frac=0.8, sz="scanpy", shuffle_seed=0, obs_columns=("cluster",))
    got, expect = io.load_train_val(path, **kw), jio.load_train_val(path, **kw)
    _equal_trees(got[0], expect[0])
    _equal_trees(got[1], expect[1])
    for g, e in zip(got[2]["cluster"], expect[2]["cluster"]):
        np.testing.assert_array_equal(g, e)


def test_plot_factors_matches_jax():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(4)
    factors, coords = rng.uniform(0, 1, (7, 40)), rng.uniform(0, 1, (40, 2))
    kw = dict(moran_idx=np.arange(7)[::-1], names=[f"f{i}" for i in range(7)], ncols=3)
    got = plotting.plot_factors(factors, coords, **kw)
    expect = jplotting.plot_factors(factors, coords, **kw)
    assert len(got.axes) == len(expect.axes) == 9
    assert ([a.get_title() for a in got.axes] == [a.get_title() for a in expect.axes])
    plt.close("all")


def test_utils_match_jax(tmp_path):
    """MetricLogger's records, find_nonfinite (its paths in JAX's keystr
    form), tree_size_bytes and copy_arrays on the same trees as JAX."""
    tree = {"a": np.array([1.0, np.nan]), "b": [np.zeros(3), np.array([np.inf])],
            "c": np.arange(4)}
    assert utils.find_nonfinite(tree) == jutils.find_nonfinite(tree)
    assert utils.find_nonfinite(tree, prefix="g") == jutils.find_nonfinite(tree, prefix="g")
    assert utils.tree_size_bytes(tree) == jutils.tree_size_bytes(tree)
    with pytest.raises(FloatingPointError, match="'a'"):
        utils.assert_finite(tree, "grads")
    utils.assert_finite({"x": np.ones(2)})
    copied = utils.copy_arrays({"t": torch.ones(3), "n": np.ones(2)})
    copied["t"][0] = 5.0
    assert copied["t"][0] == 5.0 and copied["n"].shape == (2,)

    loggers = [utils.MetricLogger(str(tmp_path / "m.jsonl")), jutils.MetricLogger()]
    for lg in loggers:
        for step in (10, 20):
            lg.log(step, loss=1.0 / step, kl=2.0)
    keys = [{k: v for k, v in r.items() if k not in ("wall", "steps_per_sec")}
            for lg in loggers for r in lg.history]
    assert keys[:2] == keys[2:]
    assert loggers[0].losses() == loggers[1].losses()
    assert all("steps_per_sec" in r for r in loggers[0].history[1:])
    assert len(open(tmp_path / "m.jsonl").readlines()) == 2


def test_utils_on_models_match_jax():
    """On an NSF model the non-finite paths and the byte count are JAX's
    (``.prior.mu`` style paths); ``copy_arrays`` of a module is a copy."""
    rng = np.random.default_rng(5)
    jmodel = gz.SlideseqNSFConfig(D=D, N=N, L=L, M=M).build(
        jax.random.PRNGKey(0), jnp.asarray(rng.uniform(-2, 2, (N, 2))))
    mu = np.asarray(jmodel.prior.mu).copy()
    mu[1, 2] = np.nan
    jmodel = jmodel.replace(prior=jmodel.prior.replace(mu=jnp.asarray(mu)))
    tmodel = nsf_from_numpy(jax_leaves(jmodel), "cpu", torch.float64)
    assert utils.find_nonfinite(tmodel) == [".prior.mu"]
    assert jutils.find_nonfinite(jmodel) == [".prior.mu"]
    assert utils.tree_size_bytes(tmodel) == jutils.tree_size_bytes(jmodel)
    copy = utils.copy_arrays(tmodel)
    assert copy is not tmodel and copy.W_raw.data_ptr() != tmodel.W_raw.data_ptr()
    assert torch.equal(copy.W_raw, tmodel.W_raw)


def test_debug_nans_and_profile_trace(tmp_path):
    x = torch.tensor(-1.0, requires_grad=True)
    with utils.debug_nans(), pytest.raises(RuntimeError, match="nan"):
        torch.sqrt(x).backward()
    torch.sqrt(x).backward()  # anomaly mode is off again
    with utils.profile_trace(str(tmp_path / "tr")) as log_dir:
        torch.ones(8).sum()
    assert (tmp_path / "tr" / "trace.json").exists() and log_dir == str(tmp_path / "tr")


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(6)
    coords = rng.uniform(-2, 2, (N, 2))
    jmodel = gz.SlideseqNSFConfig(D=D, N=N, L=L, M=M).build(
        jax.random.PRNGKey(1), jnp.asarray(coords))
    lu_raw = np.tril(0.2 * rng.standard_normal((L, M, M)))
    jmodel = jmodel.replace(prior=jmodel.prior.replace(Lu_raw=jnp.asarray(lu_raw)))
    tmodel = nsf_from_numpy(jax_leaves(jmodel), "cpu", torch.float64,
                            jitter=jmodel.prior.jitter, var_floor=jmodel.prior.var_floor)
    return coords, jmodel, tmodel


def test_snapshotter_records_match_jax(models, tmp_path):
    """Every other chunk the port's snapshotter records JAX's keys and
    values (percentiles of the probe posterior, the last loss) and keeps
    JAX's frames; its logger and ``.npz`` hold the same."""
    coords, jmodel, tmodel = models
    probe = coords[:50]
    jlog, tlog = jutils.MetricLogger(), utils.MetricLogger()
    jsnap = JSnapshotter(jnp.asarray(probe), every=2, logger=jlog)
    tsnap = PosteriorSnapshotter(torch.tensor(probe), every=2, logger=tlog)
    for chunk in range(1, 5):
        losses = np.array([3.0, 2.0 / chunk])
        jsnap(types.SimpleNamespace(model=jmodel, step=jnp.asarray(5 * chunk)), losses)
        tsnap(types.SimpleNamespace(model=tmodel, step=5 * chunk), torch.tensor(losses))
    assert [s for s, _ in tsnap.history] == [s for s, _ in jsnap.history] == [10, 20]
    for (_, got), (_, expect) in zip(tsnap.history, jsnap.history):
        np.testing.assert_allclose(got, expect, rtol=0, atol=TOL * np.abs(expect).max())
    for got, expect in zip(tsnap.records, jsnap.records):
        assert got.keys() == expect.keys()
        for k in expect:
            assert got[k] == pytest.approx(expect[k], rel=TOL, abs=1e-12), k
    assert len(tlog.history) == len(jlog.history) == 2
    data = np.load(tsnap.save(str(tmp_path / "frames.npz")))
    assert data["frames"].shape == (2, L, 50) and list(data["steps"]) == [10, 20]


def test_snapshotter_on_the_runner(models):
    """Through ``make_scan_runner(on_chunk=)`` on the Adam step: one record
    per chunk at the state's step count."""
    coords, _, tmodel = models
    x = torch.tensor(coords)
    model = nsf_from_numpy({k: v.detach().numpy() for k, v in
                            tmodel.state_dict().items()}, "cpu", torch.float64)
    gen = torch.Generator().manual_seed(0)
    state = gt.TrainState(model, torch.optim.Adam(model.parameters(), lr=1e-3), gen)
    y = torch.tensor(np.random.default_rng(0).poisson(3.0, (D, N)).astype(np.float64))
    step = gt.make_batched_train_step(gt.nsf_negative_elbo_precomputed, state.optimizer,
                                      N, 32, L, gen)
    snap = PosteriorSnapshotter(x[:20], keep_arrays=False)
    runner = gt.make_scan_runner(step, 3, on_chunk=snap)
    proj = gt.precompute_nsf_projection(model, x)
    for _ in range(2):
        state, losses = runner(state, proj, y)
    assert [r["step"] for r in snap.records] == [3, 6] and snap.history == []
    assert snap.records[-1]["loss"] == float(losses[-1])


@pytest.mark.parametrize("chunk_size", [None, 64])
def test_extract_factors_matches_jax(models, chunk_size):
    coords, jmodel, tmodel = models
    got = extract_factors(tmodel, torch.tensor(coords), chunk_size=chunk_size)
    expect = j_extract(jmodel, jnp.asarray(coords), chunk_size=chunk_size)
    np.testing.assert_allclose(got[0], expect[0], rtol=0,
                               atol=TOL * np.abs(expect[0]).max())
    np.testing.assert_array_equal(got[1], expect[1])
    np.testing.assert_allclose(got[2], expect[2], rtol=0, atol=TOL)
    other = coords[::-1].copy()
    got = extract_factors(tmodel, torch.tensor(coords), coords=other)
    expect = j_extract(jmodel, jnp.asarray(coords), coords=other)
    np.testing.assert_array_equal(got[1], expect[1])
