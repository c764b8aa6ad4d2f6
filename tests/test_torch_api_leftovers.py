"""The port's small API leftovers against the JAX package, on the CPU in
float64: ``ops.distance.cdist``, ``ops.linalg.reshape_param``, the
panel-blocked ``tri_t_matmul_b``, ``matmul_tri`` and ``matmul_tri_t``,
``train.loop.freeze_loss`` and ``apply_stop_gradient``, the reference-name
aliases of ``kernels``, ``gps`` and ``models``, and the subpackages the
package root exports."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpzoo_tpu as gz
from gpzoo_tpu.ops import distance as j_distance
from gpzoo_tpu.ops import linalg as j_linalg
from gpzoo_tpu.ops import tri_blocked as j_tri
from gpzoo_tpu.train.fast import nsf_negative_elbo_batched as j_batched
from gpzoo_tpu.train.loop import _path_str, freeze_loss as j_freeze_loss
from gpzoo_tpu.train.loop import trainable_mask

import gpzoo_tpu_torch as gt
from gpzoo_tpu_torch.convert import nsf_from_numpy
from gpzoo_tpu_torch.ops import cdist, reshape_param
from gpzoo_tpu_torch.ops import tri_blocked
from gpzoo_tpu_torch.train import apply_stop_gradient, freeze_loss

T = torch.tensor


def _close(got, expect, rtol=1e-12):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    expect = np.asarray(expect)
    np.testing.assert_allclose(got, expect, rtol=0,
                               atol=rtol * max(np.max(np.abs(expect)), 1e-300))


def test_cdist_matches_jax():
    rng = np.random.default_rng(0)
    x, z = rng.normal(size=(30, 2)), rng.normal(size=(17, 2))
    _close(cdist(T(x), T(z)), j_distance.cdist(jnp.asarray(x), jnp.asarray(z)))


def test_reshape_param_matches_jax():
    p = np.arange(2 * 3 * 4 * 4, dtype=np.float64).reshape(2, 3, 4, 4)
    got = reshape_param(T(p))
    assert got.shape == (6, 4, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_linalg.reshape_param(jnp.asarray(p))))


@pytest.mark.parametrize("m", [20, 1100])
@pytest.mark.parametrize("name", ["tri_t_matmul_b", "matmul_tri", "matmul_tri_t"])
def test_panel_products_match_jax(name, m):
    """Below MIN_DIM one dense product, above it six panels; both against
    JAX's and against the dense product of the lower-triangular factor."""
    rng = np.random.default_rng(m)
    w = np.tril(rng.normal(size=(2, m, m)))
    other = rng.normal(size=(2, m, 9)) if name == "tri_t_matmul_b" else rng.normal(
        size=(2, 7, m))
    args = (w, other) if name == "tri_t_matmul_b" else (other, w)
    got = getattr(tri_blocked, name)(*map(T, args))
    expect = getattr(j_tri, name)(*map(jnp.asarray, args))
    _close(got, expect)
    dense = {"tri_t_matmul_b": lambda: np.swapaxes(w, -1, -2) @ other,
             "matmul_tri": lambda: other @ w,
             "matmul_tri_t": lambda: other @ np.swapaxes(w, -1, -2)}[name]()
    _close(got, dense)


def _models():
    rng = np.random.default_rng(1)
    n, d, l, m = 120, 6, 3, 10
    coords = rng.uniform(-2, 2, (n, 2))
    counts = rng.poisson(2.0, (d, n)).astype(np.float64)
    jmodel = gz.NSFConfig(D=d, N=n, L=l, M=m).build(jax.random.PRNGKey(2),
                                                    X=jnp.asarray(coords))
    jmodel = jmodel.replace(prior=jmodel.prior.replace(
        mu=jnp.asarray(0.1 * rng.normal(size=(l, m))),
        Lu_raw=jnp.asarray(np.tril(0.2 * rng.normal(size=(l, m, m))))))
    leaves = {_path_str(p): np.asarray(v)
              for p, v in jax.tree_util.tree_flatten_with_path(jmodel)[0]}
    tmodel = nsf_from_numpy(leaves, "cpu", torch.float64, jitter=jmodel.prior.jitter)
    idx = rng.permutation(n)[:32]
    eps = rng.normal(size=(1, l, 32))
    return jmodel, tmodel, coords, counts, idx, eps


def _trainable(path):
    return not (path.endswith(".Z") or ".kernel." in path)


def test_freeze_loss_matches_jax():
    """The blockwise loss with Z and the kernel stop-gradiented: the value
    and every trainable leaf's gradient equal JAX's; the frozen leaves get
    no gradient (JAX's are zero), and the model's parameters are the same
    objects afterwards."""
    jmodel, tmodel, coords, counts, idx, eps = _models()
    kw = {"microbatch": 16, "factored": True}

    def normal(key, shape=(), dtype=None):
        return jnp.asarray(eps, dtype)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", normal)
        jval, jgrad = jax.value_and_grad(j_freeze_loss(
            j_batched, trainable_mask(jmodel, _trainable)))(
                jmodel, jnp.asarray(coords), jnp.asarray(counts),
                jnp.asarray(idx), jax.random.PRNGKey(0), **kw)
    params = dict(tmodel.named_parameters())
    loss = freeze_loss(gt.nsf_negative_elbo_batched, _trainable)(
        tmodel, T(coords), T(counts), T(idx), eps=T(eps), **kw)
    loss.backward()
    _close(loss, jval, 1e-10)
    jg = {_path_str(p): np.asarray(v)
          for p, v in jax.tree_util.tree_flatten_with_path(jgrad)[0]}
    for path, p in tmodel.named_parameters():
        assert p is params[path]
        if _trainable(path):
            _close(p.grad, jg[path], 1e-10)
        else:
            assert p.grad is None and not np.any(jg[path]), path


def test_apply_stop_gradient_is_a_view():
    """The stop-gradient model shares every tensor's storage with the model,
    holds its trainable parameters themselves, and leaves it unchanged."""
    _, tmodel, *_ = _models()
    view = apply_stop_gradient(tmodel, _trainable)
    assert view.prior.Z.data_ptr() == tmodel.prior.Z.data_ptr()
    assert not view.prior.Z.requires_grad and tmodel.prior.Z.requires_grad
    assert view.prior.mu is tmodel.prior.mu and view.W_raw is tmodel.W_raw
    assert isinstance(tmodel.prior.Z, torch.nn.Parameter)


@pytest.mark.parametrize("module", ["kernels", "gps", "models"])
def test_reference_name_aliases(module):
    jmod, tmod = getattr(gz, module), getattr(gt, module)
    aliases = [n for n in jmod.__all__ if getattr(jmod, n).__name__ != n]
    assert aliases
    for name in aliases:
        assert name in tmod.__all__
        assert getattr(tmod, name).__name__ == getattr(jmod, name).__name__


def test_root_exports_the_subpackages():
    for name in ("bijectors", "dists", "kernels", "gps", "models", "ops", "data",
                 "parallel", "predict", "utils", "warmstart"):
        assert name in gt.__all__ and getattr(gt, name).__name__.endswith(name)
    assert set(gt.parallel.__all__) == set(gz.parallel.__all__)
