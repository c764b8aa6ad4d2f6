"""The port's sharded Adam step (``parallel.make_sharded_batched_train_step``)
against the JAX package's unsharded loss and optax Adam, on four gloo ranks
on the CPU in float64 (the mirror of tests/test_sharding.py).

Every rank draws the global idx and eps from the same seeded generator and
takes its blocks; the parent draws the same sequence and feeds it to the
JAX loss (``jax.random.normal`` patched to return it). Each mesh is one
spawn of four ranks (``scenario_step``), which runs three steps of the
precomputed loss and three of the blockwise loss (factored, microbatch 32
of the global batch of 64) from the same init, with the counts split by
columns over the data axis. The ``{"data": 4}`` spawn also runs
``latent_posterior(mesh=)`` at an N the mesh does not divide, and two
data-parallel steps each of the MGGP blockwise loss and the VNNGP fast
loss.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import gpzoo_tpu as gz
from gpzoo_tpu.predict import latent_posterior as j_latent_posterior
from gpzoo_tpu.train.fast import (nsf_negative_elbo_batched as j_batched,
                                  nsf_negative_elbo_precomputed as j_precomputed,
                                  precompute_nsf_projection as j_precompute)
from gpzoo_tpu.train.fast_vnngp import vnngp_nsf_negative_elbo_batched as j_vnngp
from gpzoo_tpu.train.loop import _path_str, _value_and_grad

from _torch_parallel_ranks import nsf_draws, spawn, stack_blocks

N, D, L, M, B, E = 512, 10, 4, 16, 64, 1
STEPS, LR, SEED, MICROBATCH = 3, 1e-2, 5, 32
TOL = 1e-9
FACTOR_LEAVES = ("prior.mu", "prior.Lu_raw", "prior.kernel.sigma",
                 "prior.kernel.lengthscale")


def jax_leaves(model):
    return {_path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(model)[0]}


def _close(got, expect, rtol=TOL):
    expect = np.asarray(expect)
    np.testing.assert_allclose(got, expect, rtol=0,
                               atol=rtol * max(np.max(np.abs(expect)), 1e-300))


def _fed_normal(eps):
    """``jax.random.normal`` returning ``eps`` (a traced argument)."""
    def normal(key, shape=(), dtype=None):
        assert tuple(shape) == eps.shape, (shape, eps.shape)
        return eps if dtype is None else eps.astype(dtype)

    return mock.patch.object(jax.random, "normal", normal)


def jax_run(loss, model, args, draws, lr, **kw):
    """The JAX loss under optax Adam over every leaf on the given draws:
    (losses, final model)."""
    opt = optax.adam(lr)

    @jax.jit
    def jstep(model, opt_state, idx, eps):
        with _fed_normal(eps):
            val, grads = _value_and_grad(
                lambda m: loss(m, *args, idx, jax.random.PRNGKey(0), **kw), model)
        updates, opt_state = opt.update(grads, opt_state, model)
        return optax.apply_updates(model, updates), opt_state, val

    opt_state, losses = opt.init(model), []
    for idx, eps in draws:
        model, opt_state, val = jstep(model, opt_state, jnp.asarray(idx),
                                      jnp.asarray(eps))
        losses.append(float(val))
    return losses, model


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    coords = rng.uniform(-2, 2, (N, 2))
    counts = rng.poisson(2.0, (D, N)).astype(np.float64)
    jmodel = gz.NSFConfig(D=D, N=N, L=L, M=M).build(jax.random.PRNGKey(7),
                                                    X=jnp.asarray(coords))
    jmodel = jmodel.replace(prior=jmodel.prior.replace(
        mu=jnp.asarray(0.1 * rng.standard_normal((L, M))),
        Lu_raw=jnp.asarray(np.tril(0.2 * rng.standard_normal((L, M, M))))))
    x_post = rng.uniform(-2, 2, (N - 2, 2))
    inputs = dict(leaves=jax_leaves(jmodel), jitter=jmodel.prior.jitter, x=coords,
                  y=counts, N=N, B=B, L=L, E=E, lr=LR, seed=SEED, steps=STEPS,
                  microbatch=MICROBATCH, x_post=x_post)
    draws = nsf_draws(SEED, N, B, L, STEPS, E)
    X, Y = jnp.asarray(coords), jnp.asarray(counts)
    ref = {
        "precomputed": jax_run(j_precomputed, jmodel,
                               (j_precompute(jmodel, X), Y), draws, LR),
        "batched": jax_run(j_batched, jmodel, (X, Y), draws, LR,
                           microbatch=MICROBATCH, factored=True),
    }
    return dict(inputs=inputs, ref=ref, jmodel=jmodel)


def _mggp_vnngp_inputs(ref_store):
    rng = np.random.default_rng(5)
    coords = rng.uniform(-2, 2, (N, 2))
    counts = rng.poisson(2.0, (D, N)).astype(np.float64)
    groups = rng.integers(0, 3, N)
    X, Y = jnp.asarray(coords), jnp.asarray(counts)
    cfg = gz.MGGPNSFConfig(D=D, N=N, L=2, M_per_group=6, n_groups=3, batch_size=B)
    mg = cfg.build(jax.random.PRNGKey(9), X=coords, groups=groups)
    mg = mg.replace(gp=mg.gp.replace(
        mu=jnp.asarray(0.1 * rng.standard_normal((2, cfg.M))),
        Lu_raw=jnp.asarray(np.tril(0.2 * rng.standard_normal((2, cfg.M, cfg.M))))))
    vn = gz.VNNGPConfig(D=D, N=N, L=3, M=64, K=4).build(jax.random.PRNGKey(11), X=X)
    common = dict(x=coords, y=counts, N=N, B=B, lr=1e-3, steps=2, seed=SEED + 1)
    mggp = dict(common, leaves=jax_leaves(mg), jitter=mg.gp.jitter,
                var_floor=mg.gp.var_floor, groups=groups, L=2, microbatch=MICROBATCH)
    vnngp = dict(common, leaves=jax_leaves(vn), jitter=vn.prior.jitter,
                 var_floor=vn.prior.var_floor, K=4, L=3)
    ref_store["mggp"] = jax_run(j_batched, mg, (X, Y), nsf_draws(SEED + 1, N, B, 2, 2),
                                1e-3, microbatch=MICROBATCH, factored=True,
                                groups=jnp.asarray(groups, jnp.int32))
    ref_store["vnngp"] = jax_run(j_vnngp, vn, (X, Y), nsf_draws(SEED + 1, N, B, 3, 2),
                                 1e-3, shared_kernel=True)
    return mggp, vnngp


@pytest.fixture(scope="module")
def data4(problem, tmp_path_factory):
    ref = dict(problem["ref"])
    mggp, vnngp = _mggp_vnngp_inputs(ref)
    inputs = dict(problem["inputs"], mesh={"data": 4}, posterior=True, mggp=mggp,
                  vnngp=vnngp)
    return spawn("step", 4, tmp_path_factory.mktemp("data4"), inputs), ref


@pytest.fixture(scope="module")
def data2_factor2(problem, tmp_path_factory):
    inputs = dict(problem["inputs"], mesh={"data": 2, "factor": 2})
    return spawn("step", 4, tmp_path_factory.mktemp("d2f2"), inputs), problem["ref"]


def _check_step(ranks, ref, loss, n_factor):
    losses, jmodel = ref[loss]
    jl = jax_leaves(jmodel)
    for out in ranks:
        assert out[loss]["losses"] == pytest.approx(losses, rel=TOL)
    for path, value in jl.items():
        if path in FACTOR_LEAVES and n_factor > 1:
            got = stack_blocks(ranks, lambda o: o[loss]["leaves"][path],
                               lambda o: o["coords"]["factor"], n_factor)
        else:
            got = ranks[0][loss]["leaves"][path]
        _close(got, value)
    # replicated leaves are bit-identical across ranks; a factor block is
    # bit-identical across the data ranks that hold it
    for out in ranks[1:]:
        for path, value in out[loss]["leaves"].items():
            twin = next(o for o in ranks if o["coords"].get("factor", 0)
                        == out["coords"].get("factor", 0))
            np.testing.assert_array_equal(value, twin[loss]["leaves"][path])
            if path not in FACTOR_LEAVES or n_factor == 1:
                np.testing.assert_array_equal(value, ranks[0][loss]["leaves"][path])


@pytest.mark.parametrize("loss", ["precomputed", "batched"])
def test_data_parallel_step_matches_jax(data4, loss):
    ranks, ref = data4
    _check_step(ranks, ref, loss, 1)


@pytest.mark.parametrize("loss", ["precomputed", "batched"])
def test_data_factor_step_matches_jax(data2_factor2, loss):
    ranks, ref = data2_factor2
    _check_step(ranks, ref, loss, 2)


@pytest.mark.parametrize("loss", ["precomputed", "batched"])
def test_factor_leaves_and_moments_are_split(data2_factor2, loss):
    """Each rank holds half of Lu_raw and half of each of its Adam moments."""
    ranks, _ = data2_factor2
    for out in ranks:
        assert out[loss]["leaves"]["prior.Lu_raw"].shape == (L // 2, M, M)
        assert out[loss]["leaves"]["prior.mu"].shape == (L // 2, M)
        for moment in out[loss]["lu_moments"]:
            assert moment.shape == (L // 2, M, M)
        assert out[loss]["leaves"]["W_raw"].shape == (D, L)


def test_sharded_posterior_matches_jax(problem, data4):
    """latent_posterior(mesh=) at N − 2 = 510 spots over 4 data ranks (padded
    to 512, trimmed), against JAX's unsharded posterior."""
    ranks, _ = data4
    jmean, jscale = j_latent_posterior(problem["jmodel"].prior,
                                       jnp.asarray(problem["inputs"]["x_post"]))
    for out in ranks:
        mean, scale = out["posterior"]
        assert mean.shape == (L, N - 2)
        _close(mean, jmean, 1e-12)
        _close(scale, jscale, 1e-12)


def test_sharded_mggp_loss_matches_jax(data4):
    ranks, ref = data4
    losses, jmodel = ref["mggp"]
    for out in ranks:
        assert out["mggp"]["losses"] == pytest.approx(losses, rel=TOL)
        _close(out["mggp"]["leaves"]["gp.kernel.lengthscale"],
               jmodel.gp.kernel.lengthscale)


def test_sharded_vnngp_loss_matches_jax(data4):
    ranks, ref = data4
    losses, _ = ref["vnngp"]
    for out in ranks:
        assert out["vnngp"]["losses"] == pytest.approx(losses, rel=1e-8)
