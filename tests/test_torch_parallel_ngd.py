"""The port's sharded NGD step (``make_ngd_train_step(mesh=)``) against the
JAX package's ``ngd_step`` on the same draws, on four gloo ranks on the CPU
in float64, under ``{"data": 2, "factor": 2}``: μ, P and chol P split over
the factor axis, the minibatch over the data axis.

The JAX step is fed the port's draws (``jax.random.choice`` and
``jax.random.normal`` patched while a fresh step traces). One case runs
three steps at the default ``max_f``; the other one step at a ``max_f``
between the two data blocks' largest |f′| of one factor, so that one data
rank alone would keep that factor's update and the other would reject it:
JAX's guard sees the whole minibatch and rejects it, and so must the port.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import gpzoo_tpu as gz
from gpzoo_tpu.train.fast import precompute_nsf_projection as j_precompute
from gpzoo_tpu.train.loop import _path_str
from gpzoo_tpu.train.ngd import make_ngd_train_step as j_make_step
from gpzoo_tpu.train.ngd import ngd_create as j_create

from _torch_parallel_ranks import nsf_draws, spawn, stack_blocks

N, D, L, M, B = 256, 12, 4, 16, 64
NAT_LR, RAMP, LR, SEED, STEPS = 0.05, 10, 1e-2, 3, 3
TOL = 1e-8


def jax_leaves(model):
    return {_path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(model)[0]}


def _close(got, expect, rtol=TOL):
    expect = np.asarray(expect)
    np.testing.assert_allclose(got, expect, rtol=0,
                               atol=rtol * max(np.max(np.abs(expect)), 1e-300))


def _jax_steps(jstate, jopt, jproj, y, draws, max_f):
    """JAX's NGD step on the given draws, a fresh trace per step."""
    losses = []
    for idx, eps in draws:
        step = j_make_step(jopt, num_points=N, batch_size=B, nat_lr=NAT_LR,
                           ramp_steps=RAMP, static_kwargs={"E": 1}, max_f=max_f)
        with mock.patch.object(jax.random, "choice",
                               lambda *a, **k: jnp.asarray(idx)), \
                mock.patch.object(jax.random, "normal",
                                  lambda key, shape, dtype=None: jnp.asarray(eps, dtype)):
            jstate, loss = step(jstate, jproj, y)
        losses.append(float(loss))
    return jstate, losses


def _straddling_max_f(jstate, jopt, jproj, y, draw):
    """A max_f between the two data blocks' largest |f′| of the factor where
    they differ most, from one JAX step without the guard; and the number
    of factors whose largest |f′| over the whole minibatch exceeds it."""
    idx, _ = draw
    after, _ = _jax_steps(jstate, jopt, jproj, y, [draw], None)
    f_new = np.asarray(after.model.prior.mu) @ np.asarray(jproj.proj_t)[idx].T
    half = np.abs(f_new).reshape(L, 2, B // 2).max(axis=-1)  # (L, data block)
    lo, hi = half.min(axis=1), half.max(axis=1)
    l_star = int(np.argmax(hi / lo))
    max_f = float(np.sqrt(lo[l_star] * hi[l_star]))
    return max_f, int(np.sum(half.max(axis=1) > max_f))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    rng = np.random.default_rng(0)
    coords = rng.uniform(-2, 2, (N, 2))
    counts = rng.poisson(3.0, (D, N)).astype(np.float64)
    cfg = gz.SlideseqNSFConfig(D=D, N=N, L=L, M=M, batch_size=B)
    jmodel = cfg.build(jax.random.PRNGKey(3), jnp.asarray(coords))
    jmodel = jmodel.replace(prior=jmodel.prior.replace(
        Lu_raw=jnp.asarray(np.tril(0.2 * rng.standard_normal((L, M, M))))))
    jstate, jopt = j_create(jmodel, optax.adam(LR), jax.random.PRNGKey(1))
    jproj, y = j_precompute(jmodel, jnp.asarray(coords)), jnp.asarray(counts)
    draws = nsf_draws(SEED, N, B, L, STEPS)
    max_f, n_bad = _straddling_max_f(jstate, jopt, jproj, y, draws[0])
    ref = {"default": _jax_steps(jstate, jopt, jproj, y, draws, 60.0),
           "straddle": _jax_steps(jstate, jopt, jproj, y, draws[:1], max_f)}
    inputs = dict(leaves=jax_leaves(jmodel), prec=np.asarray(jstate.prec),
                  prec_chol=np.asarray(jstate.prec_chol), jitter=jmodel.prior.jitter,
                  x=coords, y=counts, N=N, B=B, L=L, E=1, lr=LR, seed=SEED,
                  nat_lr=NAT_LR, ramp=RAMP, mesh={"data": 2, "factor": 2},
                  cases=[{"name": "default", "max_f": 60.0, "steps": STEPS},
                         {"name": "straddle", "max_f": max_f, "steps": 1}])
    ranks = spawn("ngd", 4, tmp_path_factory.mktemp("ngd"), inputs)
    return ranks, ref, n_bad


@pytest.mark.parametrize("case", ["default", "straddle"])
def test_sharded_ngd_matches_jax(run, case):
    ranks, ref, _ = run
    jstate, losses = ref[case]
    for out in ranks:
        assert out[case]["losses"] == pytest.approx(losses, rel=TOL)
        _close(out[case]["W_raw"], jstate.model.W_raw)
        _close(out[case]["V_raw"], jstate.model.V_raw)
    for name, expect in (("mu", jstate.model.prior.mu), ("prec", jstate.prec)):
        got = stack_blocks(ranks, lambda o: o[case][name],
                           lambda o: o["coords"]["factor"], 2)
        assert got.shape[0] == L
        _close(got, expect)
    # the data ranks that hold a factor block hold it bit for bit alike
    for out in ranks:
        twin = next(o for o in ranks if o["coords"]["factor"] == out["coords"]["factor"])
        np.testing.assert_array_equal(out[case]["prec"], twin[case]["prec"])
        np.testing.assert_array_equal(out[case]["W_raw"], ranks[0][case]["W_raw"])


def test_max_f_reads_the_whole_minibatch(run):
    """The straddling max_f rejects at least one factor; every rank counts
    the rejections of all factors (summed over the factor group)."""
    ranks, _, n_bad = run
    assert n_bad >= 1
    for out in ranks:
        assert out["straddle"]["rejected"] == n_bad
        assert out["default"]["rejected"] == 0
