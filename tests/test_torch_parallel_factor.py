"""The factor axis on every loss of the port, against the JAX package: the
shared-kernel collapse of the blockwise loss (σ and ℓ trained through
global factor 0), MGGP priors (per-factor and shared μ/Lu, and the
collapse over an MGGP kernel, whose group parameter α stays whole), the
Slideseq Hybrid-MGGP model at a small size, both VNNGP losses, and
``latent_posterior(mesh=, shardings=)`` of a factor-split GP.

One spawn of four gloo ranks on the CPU in float64 on ``{"data": 2,
"factor": 2}`` (``_torch_parallel_factor_ranks.scenario_factor``) runs
every case; the parent feeds JAX's unsharded loss the same idx and eps
(``jax.random.normal`` patched) under optax Adam, with the frozen leaves'
gradients zeroed (Adam then leaves them as they are). M ≠ L throughout,
so that a shared μ is never taken for a per-factor leaf. One more case
runs on the JAX side alone: ``shard_factor_params`` on the 8 virtual CPU
devices takes the MGGP blockwise loss, as the port's refusals once
assumed it did not.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import gpzoo_tpu as gz
from gpzoo_tpu.parallel import (create_mesh, make_sharded_batched_train_step,
                                replicate, shard_columns, shard_factor_params)
from gpzoo_tpu.predict import latent_posterior as j_latent_posterior
from gpzoo_tpu.train import TrainState, make_batched_train_step
from gpzoo_tpu.train.fast import nsf_negative_elbo_batched as j_batched
from gpzoo_tpu.train.fast_vnngp import (
    precompute_vnngp_conditioning as j_vnngp_conditioning,
    vnngp_nsf_negative_elbo_batched as j_vnngp,
    vnngp_nsf_negative_elbo_precomputed as j_vnngp_precomputed)
from gpzoo_tpu.train.loop import _path_str, _value_and_grad

from _torch_parallel_ranks import spawn

N, D, L, B, MICROBATCH, STEPS, SEED, LR = 256, 8, 4, 64, 32, 3, 5, 1e-2
M_NSF, M_VNNGP, K = 12, 24, 4
MGGP_SIZE = dict(M_per_group=5, n_groups=3)  # M = 15
T = 2  # the hybrid's mean-field factors
MESH = {"data": 2, "factor": 2}
TOL, TOL_VNNGP = 1e-9, 1e-8
BLOCKWISE = {"microbatch": MICROBATCH, "factored": True}
COLLAPSED = ("nsf_collapse_per_factor", "nsf_collapse_shared_mu", "mggp_collapse",
             "vnngp_collapse", "nsf_collapse_partial")


def jax_leaves(model):
    return {_path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(model)[0]}


def _close(got, expect, rtol):
    expect = np.asarray(expect)
    np.testing.assert_allclose(got, expect, rtol=0,
                               atol=rtol * max(np.max(np.abs(expect)), 1e-300))


def draws(seed, rows, E, steps, eps2_rows=None):
    """The global (idx, eps, eps2) of ``steps`` unsharded steps, drawn as the
    port's step draws them from a CPU generator seeded ``seed``."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(steps):
        idx = torch.randperm(N, generator=g)[:B].numpy()
        eps = torch.randn((E, rows, B), generator=g, dtype=torch.float64).numpy()
        eps2 = (None if eps2_rows is None else
                torch.randn((E, eps2_rows, B), generator=g, dtype=torch.float64).numpy())
        out.append((idx, eps, eps2))
    return out


def _fed_normal(eps, eps2):
    """``jax.random.normal`` returning ``eps``, or ``eps2`` for a hybrid's
    mean-field half (told apart by shape: T ≠ L)."""
    def normal(key, shape=(), dtype=None):
        out = eps if tuple(shape) == eps.shape else eps2
        assert out is not None and tuple(shape) == out.shape, (shape, eps.shape)
        return out if dtype is None else out.astype(dtype)

    return mock.patch.object(jax.random, "normal", normal)


def jax_run(loss, model, args, feed, frozen=(), **kw):
    """The JAX loss under optax Adam on the fed draws: (losses, the first
    step's gradients, the final model). Frozen leaves get a zero gradient,
    which Adam turns into no update."""
    opt = optax.adam(LR)

    def mask(grads):
        return jax.tree_util.tree_map_with_path(
            lambda p, g: jnp.zeros_like(g) if any(f in _path_str(p) for f in frozen)
            else g, grads)

    @jax.jit
    def jstep(model, opt_state, idx, eps, eps2):
        with _fed_normal(eps, eps2):
            val, grads = _value_and_grad(
                lambda m: loss(m, *args, idx, jax.random.PRNGKey(0), **kw), model)
        grads = mask(grads)
        updates, opt_state = opt.update(grads, opt_state, model)
        return optax.apply_updates(model, updates), opt_state, val, grads

    opt_state, losses, first = opt.init(model), [], None
    for idx, eps, eps2 in feed:
        model, opt_state, val, grads = jstep(
            model, opt_state, jnp.asarray(idx), jnp.asarray(eps),
            None if eps2 is None else jnp.asarray(eps2))
        losses.append(float(val))
        first = jax_leaves(grads) if first is None else first
    return losses, first, model


def _factor_leaves(jm, attr, rng, per_factor, m):
    """``jm`` with random μ and Lu_raw in its prior ``attr``: per-factor (L,
    M) and (L, M, M), or shared (M,) and (M, M). An MGGP kernel also gets a
    random embedding: the MDS embedding of three equidistant groups has a
    null column, whose gradient is rounding noise that Adam scales up to
    ±lr a step in either program."""
    lead = (L,) if per_factor else ()
    gp = getattr(jm, attr)
    gp = gp.replace(mu=jnp.asarray(0.1 * rng.standard_normal(lead + (m,))),
                    Lu_raw=jnp.asarray(np.tril(0.2 * rng.standard_normal(lead + (m, m)))))
    if hasattr(gp.kernel, "embedding"):
        gp = gp.replace(kernel=gp.kernel.replace(embedding=jnp.asarray(
            0.5 * rng.standard_normal(gp.kernel.embedding.shape))))
    return jm.replace(**{attr: gp})


@pytest.fixture(scope="module")
def problem():
    """Every case's JAX model, its inputs for the ranks and JAX's run."""
    rng = np.random.default_rng(0)
    coords = rng.uniform(-2, 2, (N, 2))
    counts = rng.poisson(2.0, (D, N)).astype(np.float64)
    groups = rng.integers(0, MGGP_SIZE["n_groups"], N)
    X, Y, G = jnp.asarray(coords), jnp.asarray(counts), jnp.asarray(groups, jnp.int32)
    nsf = gz.NSFConfig(D=D, N=N, L=L, M=M_NSF).build(jax.random.PRNGKey(7), X=X)
    mggp = gz.MGGPNSFConfig(D=D, N=N, L=L, batch_size=B, **MGGP_SIZE).build(
        jax.random.PRNGKey(9), X=coords, groups=groups)
    hybrid = gz.SlideseqHybridMGGPConfig(D=D, N=N, L=L, T=T, batch_size=B,
                                         **MGGP_SIZE).build(
        jax.random.PRNGKey(13), X=coords, groups=groups)
    vnngp = gz.VNNGPConfig(D=D, N=N, L=L, M=M_VNNGP, K=K).build(jax.random.PRNGKey(11),
                                                                 X=X)
    m_mggp = MGGP_SIZE["M_per_group"] * MGGP_SIZE["n_groups"]
    models = {
        "nsf_collapse_per_factor": _factor_leaves(nsf, "prior", rng, True, M_NSF),
        "nsf_collapse_shared_mu": _factor_leaves(nsf, "prior", rng, False, M_NSF),
        "mggp_per_factor": _factor_leaves(mggp, "gp", rng, True, m_mggp),
        "mggp_shared_mu": _factor_leaves(mggp, "gp", rng, False, m_mggp),
        "mggp_collapse": _factor_leaves(mggp, "gp", rng, True, m_mggp),
        "hybrid_mggp": hybrid,
        "vnngp_collapse": vnngp, "vnngp_per_factor_kernel": vnngp,
        "vnngp_precomputed": vnngp,
        "nsf_collapse_partial": _factor_leaves(nsf, "prior", rng, True, M_NSF),
    }
    specs = {
        "nsf_collapse_per_factor": ("nsf", dict(BLOCKWISE, shared_kernel=True)),
        "nsf_collapse_shared_mu": ("nsf", dict(BLOCKWISE, shared_kernel=True)),
        "mggp_per_factor": ("mggp", BLOCKWISE),
        "mggp_shared_mu": ("mggp", BLOCKWISE),
        "mggp_collapse": ("mggp", dict(BLOCKWISE, shared_kernel=True)),
        "hybrid_mggp": ("hybrid_mggp", BLOCKWISE),
        "vnngp_collapse": ("vnngp", {"shared_kernel": True}),
        "vnngp_per_factor_kernel": ("vnngp", {"shared_kernel": False}),
        "vnngp_precomputed": ("vnngp", {}),
        # the collapse bound into the loss by functools.partial: the step
        # routes σ and ℓ by what the loss read, not by its keywords
        "nsf_collapse_partial": ("nsf", dict(BLOCKWISE, shared_kernel=True)),
    }
    cases, ref = {}, {}
    for i, (name, jm) in enumerate(models.items()):
        family, loss_kw = specs[name]
        gp = jm.sf.prior if family == "hybrid_mggp" else jm.gp if family == "mggp" \
            else jm.prior
        hybrid_case = family == "hybrid_mggp"
        E = 3 if hybrid_case else 1
        frozen = (".kernel.",) if hybrid_case else ()
        feed = draws(SEED + i, L, E, STEPS, T if hybrid_case else None)
        case = dict(family=family, loss_kw=loss_kw, leaves=jax_leaves(jm),
                    jitter=gp.jitter, var_floor=gp.var_floor, x=coords, y=counts,
                    N=N, B=B, L=L, E=E, K=K, lr=LR, seed=SEED + i, steps=STEPS,
                    frozen=frozen, loss="precomputed" if "precomputed" in name
                    else "batched")
        if name == "nsf_collapse_partial":
            case["bound"] = ("shared_kernel",)
        jkw = dict(loss_kw, E=E)
        if family in ("mggp", "hybrid_mggp"):
            case["groups"] = groups
            jkw["groups"] = G
        if name == "vnngp_precomputed":
            loss, args = j_vnngp_precomputed, (j_vnngp_conditioning(jm, X), Y)
        elif family == "vnngp":
            loss, args = j_vnngp, (X, Y)
        else:
            loss, args = j_batched, (X, Y)
        cases[name] = case
        ref[name] = jax_run(loss, jm, args, feed, frozen, **jkw)
    x_post = rng.uniform(-2, 2, (N - 3, 2))
    g_post = rng.integers(0, MGGP_SIZE["n_groups"], N - 3)
    posteriors = {
        "posterior_nsf": dict(cases["nsf_collapse_per_factor"], x_post=x_post),
        "posterior_mggp": dict(cases["mggp_per_factor"], x_post=x_post,
                               groups_post=g_post),
    }
    ref["posterior_nsf"] = j_latent_posterior(
        models["nsf_collapse_per_factor"].prior, jnp.asarray(x_post))
    ref["posterior_mggp"] = j_latent_posterior(
        models["mggp_per_factor"].gp, jnp.asarray(x_post),
        groups=jnp.asarray(g_post, jnp.int32))
    return dict(inputs=dict(mesh=MESH, cases=cases, posteriors=posteriors), ref=ref,
                models=models)


@pytest.fixture(scope="module")
def ranks(problem, tmp_path_factory):
    return spawn("factor", 4, tmp_path_factory.mktemp("factor"), problem["inputs"])


def _tol(case):
    return TOL_VNNGP if case.startswith("vnngp") else TOL


def _whole(ranks, case, key, path):
    """The full value of ``path`` from the ranks: stacked from the factor
    blocks if the ranks split it, else rank 0's."""
    if path not in ranks[0][case]["split"]:
        return ranks[0][case][key][path]
    blocks = {}
    for out in ranks:
        blocks.setdefault(out["coords"]["factor"], out[case][key][path])
    return np.concatenate([blocks[i] for i in range(len(blocks))], axis=0)


CASES = ("nsf_collapse_per_factor", "nsf_collapse_shared_mu", "mggp_per_factor",
         "mggp_shared_mu", "mggp_collapse", "hybrid_mggp", "vnngp_collapse",
         "vnngp_per_factor_kernel", "vnngp_precomputed", "nsf_collapse_partial")


@pytest.mark.parametrize("case", CASES)
def test_factor_step_matches_jax(ranks, problem, case):
    """Losses, the first step's gradients after the step's reductions, and
    the leaves after three steps, against JAX's unsharded run."""
    losses, grads, jmodel = problem["ref"][case]
    tol = _tol(case)
    for out in ranks:
        assert out[case]["losses"] == pytest.approx(losses, rel=tol)
    got_grads = ranks[0][case]["grads"]
    for path, g in grads.items():
        if path in got_grads:
            _close(_whole(ranks, case, "grads", path), g, tol)
        elif np.issubdtype(g.dtype, np.floating):
            # a leaf the loss does not read, or a frozen one: no gradient in
            # the port, a zero one in JAX
            assert not np.any(g), path
    for path, value in jax_leaves(jmodel).items():
        if path in ranks[0][case]["leaves"]:
            _close(_whole(ranks, case, "leaves", path), value, tol)


@pytest.mark.parametrize("case", CASES)
def test_factor_split_and_whole_leaves(ranks, problem, case):
    """μ, Lu and σ, ℓ are split when per-factor; a shared μ/Lu, Z, α and the
    embedding stay whole, bit-identical on every rank, as is a factor
    block on the data ranks that hold it."""
    split = set(ranks[0][case]["split"])
    prefix = "sf.prior." if case == "hybrid_mggp" else "gp." if "mggp" in case \
        else "prior."
    kernel = {prefix + "kernel.sigma", prefix + "kernel.lengthscale"}
    assert kernel <= split
    assert not any(p.endswith(("Z", "group_diff_param", "embedding")) for p in split)
    per_factor = np.asarray(problem["inputs"]["cases"][case]["leaves"][prefix + "mu"]).ndim == 2
    assert (prefix + "mu" in split) == per_factor
    for out in ranks[1:]:
        twin = next(o for o in ranks if o["coords"]["factor"] == out["coords"]["factor"])
        for path, value in out[case]["leaves"].items():
            np.testing.assert_array_equal(value, twin[case]["leaves"][path])
            if path not in split:
                np.testing.assert_array_equal(value, ranks[0][case]["leaves"][path])


@pytest.mark.parametrize("case", COLLAPSED)
def test_collapse_routes_kernel_gradient_to_factor_zero(ranks, problem, case):
    """Through the collapse the whole σ/ℓ gradient lands in global factor 0:
    factor rank 0's first row holds the sum over the factor ranks, every
    other row, on every rank, exactly 0, as in JAX."""
    _, grads, _ = problem["ref"][case]
    prefix = "gp." if "mggp" in case else "prior."
    for name in ("kernel.sigma", "kernel.lengthscale"):
        path = prefix + name
        assert np.all(grads[path].reshape(L, -1)[1:] == 0) and np.any(grads[path] != 0)
        for out in ranks:
            g = out[case]["grads"][path].reshape(L // 2, -1)
            assert np.all(g[1:] == 0)
            if out["coords"]["factor"] == 1:
                assert np.all(g == 0)
            else:
                assert np.all(g[0] != 0)


@pytest.mark.parametrize("case", ["posterior_nsf", "posterior_mggp"])
def test_factor_split_posterior_matches_jax(ranks, problem, case):
    """latent_posterior(mesh=, shardings=) of a factor-split GP returns the
    whole (L, N − 3) on every rank, as JAX's replicated GP does; the whole
    GP on the same mesh, without shardings, gives the same."""
    jmean, jscale = problem["ref"][case]
    for out in ranks:
        for which in ("split", "whole"):
            mean, scale = out[case][which]
            assert mean.shape == (L, N - 3)
            _close(mean, jmean, 1e-12)
            _close(scale, jscale, 1e-12)


def test_jax_takes_the_mggp_loss_on_a_factor_mesh(problem):
    """The JAX package's side of the branch: a TrainState split by
    ``shard_factor_params`` on {"data": 4, "factor": 2} of the 8 virtual
    CPU devices runs the MGGP blockwise loss (σ and ℓ split, α whole) and
    matches the unsharded step."""
    model = problem["models"]["mggp_per_factor"]
    inp = problem["inputs"]["cases"]["mggp_per_factor"]
    X, Y = jnp.asarray(inp["x"]), jnp.asarray(inp["y"])
    mesh = create_mesh({"data": 4, "factor": 2})
    opt, key = optax.adam(LR), jax.random.PRNGKey(3)
    kwargs = dict(BLOCKWISE, E=1, groups=jnp.asarray(inp["groups"], jnp.int32))
    step_ref = make_batched_train_step(j_batched, opt, num_points=N, batch_size=B,
                                       static_kwargs=kwargs)
    s_ref = TrainState.create(model, opt, key)
    s_sh, shardings = shard_factor_params(mesh, TrainState.create(model, opt, key),
                                          num_factors=L)
    kernel = s_sh.model.gp.kernel
    assert kernel.sigma.sharding.is_equivalent_to(
        NamedSharding(mesh, P("factor", None, None)), 3)
    assert kernel.group_diff_param.sharding.is_equivalent_to(NamedSharding(mesh, P()), 3)
    step_sh = make_sharded_batched_train_step(
        j_batched, opt, num_points=N, batch_size=B, mesh=mesh,
        static_kwargs=dict(kwargs, groups=replicate(mesh, kwargs["groups"])),
        state_shardings=shardings)
    X_sh, Y_sh = replicate(mesh, X), shard_columns(mesh, Y)
    for _ in range(2):
        s_ref, l_ref = step_ref(s_ref, X, Y)
        s_sh, l_sh = step_sh(s_sh, X_sh, Y_sh)
        assert float(l_sh) == pytest.approx(float(l_ref), rel=TOL)
    for name in ("sigma", "group_diff_param", "embedding"):
        _close(np.asarray(getattr(s_sh.model.gp.kernel, name)),
               np.asarray(getattr(s_ref.model.gp.kernel, name)), TOL)
