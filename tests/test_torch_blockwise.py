"""The port's blockwise loss against the JAX package, on CPU: every branch of
``nsf_negative_elbo_batched`` (the shared-kernel collapse, the
shared-Cholesky K⁻¹ branch in both projection forms, the whitened factored
branch, the non-factored solves, the hybrid heads over SVGP, WSVGP and
MGGPSVGP), the linear algebra they rest on, the full-batch training step,
the hybrid configurations, the data simulator and the float32 error through
Kzz⁻¹.

Inputs are numpy arrays from a seed, fed to both packages in float64 and
compared at 1e-8; JAX models are carried over through
``gpzoo_tpu_torch.convert``. Both losses see the same idx and the same
draws: eps (and, for a hybrid, eps2) are the draws the JAX loss makes from
its key (a hybrid splits it: k1 → eps, k2 → eps2).
"""

import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gpzoo_tpu as gz
from gpzoo_tpu.data.metrics import poisson_deviance as j_poisson_deviance
from gpzoo_tpu.ops import linalg as jlinalg
from gpzoo_tpu.predict import latent_posterior as j_latent_posterior
from gpzoo_tpu.train import freeze_loss, partition_optimizer, trainable_mask
from gpzoo_tpu.train.fast import nsf_negative_elbo_batched as j_batched
from gpzoo_tpu.train.loop import _path_str, _value_and_grad

import gpzoo_tpu_torch as gt
from gpzoo_tpu_torch.convert import (hybrid_from_numpy, mggp_nsf_from_numpy,
                                     nbnsf_from_numpy, nsf_from_numpy,
                                     wsvgp_nsf_from_numpy)
from gpzoo_tpu_torch.ops import linalg

N, D, L, M, B, MB, T_MF, G = 120, 10, 3, 24, 40, 20, 2, 3
TOL = 1e-8
T = torch.tensor


def jax_leaves(model):
    return {_path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(model)[0]}


def _close(got, expect, rtol=TOL):
    """Max-normalized comparison: |got − expect| ≤ rtol · max|expect|."""
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    expect = np.asarray(expect)
    np.testing.assert_allclose(got, expect, rtol=0,
                               atol=rtol * max(np.max(np.abs(expect)), 1e-300))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    coords = rng.uniform(-2, 2, (N, 2))
    counts_t = rng.poisson(3.0, (N, D)).astype(np.float64)  # spot-major
    groups = rng.integers(0, G, N)
    return coords, counts_t, groups


# --- the JAX model of every case, and its port --------------------------------

def _jkernel(kind, rng, mggp):
    """The kernel of a case: "per_factor" distinct (L, 1, 1) σ, ℓ (and α),
    "equal" (L, 1, 1) with equal values (the collapse's premise),
    "scalar" one σ and ℓ (a shared Cholesky without the collapse), and
    "scalar_sigma" a scalar σ with an equal (L, 1, 1) ℓ."""
    def per(lo, hi):
        return jnp.asarray(rng.uniform(lo, hi, (L, 1, 1)))

    if mggp:
        k = gz.kernels.MGGPNSFRBF.create(sigma=1.1, lengthscale=1.3,
                                         group_diff_param=0.7, n_groups=G, L=L)
        if kind == "per_factor":
            k = k.replace(sigma=per(0.8, 1.3), lengthscale=per(1.0, 2.0),
                          group_diff_param=per(0.5, 1.5))
        return k
    k = gz.kernels.NSFRBF.create(L=L, sigma=1.1, lengthscale=0.9)
    if kind == "per_factor":
        return k.replace(sigma=per(0.8, 1.3), lengthscale=per(0.7, 1.2))
    if kind == "scalar":
        return k.replace(sigma=jnp.asarray(1.1), lengthscale=jnp.asarray(0.9))
    if kind == "scalar_sigma":
        return k.replace(sigma=jnp.asarray(1.1))
    return k


def _jgp(prior, kernel, layout, jitter, rng, coords, groups):
    """A JAX prior with non-trivial q(u): ``layout`` "shared" gives μ (M,)
    and Lu (M, M), "per_factor" (L, M) and (L, M, M), "shared_lu" (L, M)
    and (M, M)."""
    lead = (L,) if layout == "per_factor" else ()
    fields = dict(kernel=kernel, Z=jnp.asarray(rng.uniform(-2, 2, (M, 2))),
                  mu=jnp.asarray(0.5 * rng.standard_normal(
                      ((L,) if layout == "shared_lu" else lead) + (M,))),
                  Lu_raw=jnp.asarray(np.tril(0.2 * rng.standard_normal(lead + (M, M)))),
                  jitter=jitter)
    if prior.startswith("mggp"):
        take = rng.choice(N, M, replace=False)
        fields.update(Z=jnp.asarray(coords[take]), groupsZ=jnp.asarray(groups[take]))
        return (gz.gps.MGGPWSVGP if prior == "mggp_wsvgp" else gz.gps.MGGPSVGP)(**fields)
    return (gz.gps.WSVGP if prior == "wsvgp" else gz.gps.SVGP)(**fields)


#: case: (head, prior, kernel, layout, jitter, loss options)
CASES = {
    # the shared-kernel collapse
    "collapse_shared_mu": ("nsf", "svgp", "equal", "shared", 1e-1,
                           dict(shared_kernel=True)),
    "collapse_fast_leg": ("nsf", "svgp", "equal", "per_factor", 1e-1,
                          dict(shared_kernel=True, remat=False)),
    "collapse_scalar_sigma": ("nsf", "svgp", "scalar_sigma", "shared", 1e-1,
                              dict(shared_kernel=True)),
    "collapse_scalar_sigma_not_factored": ("nsf", "svgp", "scalar_sigma", "shared",
                                           1e-1, dict(shared_kernel=True,
                                                      factored=False)),
    "collapse_mggp_shared_mu": ("mggp", "mggp", "equal", "shared", 1e-1,
                                dict(shared_kernel=True)),
    "collapse_nb": ("nb", "svgp", "equal", "per_factor", 1e-1,
                    dict(shared_kernel=True)),
    # the shared-Cholesky K⁻¹ branch: the auto-gate at both jitters, forced
    "shared_chol_auto_big_jitter": ("nsf", "svgp", "scalar", "per_factor", 1e-1, {}),
    "shared_chol_auto_small_jitter": ("nsf", "svgp", "scalar", "per_factor", 1e-3, {}),
    "shared_chol_stable": ("nsf", "svgp", "scalar", "per_factor", 1e-1,
                           dict(stable_projection=True, remat=False)),
    "shared_chol_plain": ("nsf", "svgp", "scalar", "per_factor", 1e-3,
                          dict(stable_projection=False)),
    "shared_chol_shared_lu": ("nsf", "svgp", "scalar", "shared_lu", 1e-3, {}),
    # whitened factored
    "whitened_wsvgp": ("nsf", "wsvgp", "per_factor", "per_factor", 1e-1, {}),
    "whitened_wsvgp_collapse": ("nsf", "wsvgp", "equal", "per_factor", 1e-1,
                                dict(shared_kernel=True)),
    "whitened_wsvgp_shared_lu": ("nsf", "wsvgp", "per_factor", "shared", 1e-1,
                                 dict(stable_projection=False)),
    "whitened_mggp": ("mggp", "mggp_wsvgp", "per_factor", "shared", 1e-1, {}),
    # the non-factored solves
    "not_factored_svgp": ("nsf", "svgp", "per_factor", "per_factor", 1e-1,
                          dict(factored=False)),
    "not_factored_wsvgp": ("nsf", "wsvgp", "per_factor", "per_factor", 1e-1,
                           dict(factored=False, remat=False)),
    # hybrid heads
    "hybrid_svgp": ("hybrid", "svgp", "per_factor", "per_factor", 1e-3, {}),
    "exact_svgp": ("exact", "svgp", "per_factor", "per_factor", 1e-3, {}),
    "hybrid_wsvgp": ("hybrid", "wsvgp", "per_factor", "per_factor", 1e-1, {}),
    "exact_wsvgp": ("exact", "wsvgp", "per_factor", "per_factor", 1e-1, {}),
    "hybrid_mggp": ("hybrid", "mggp", "per_factor", "per_factor", 1e-2,
                    dict(remat=False)),
    "exact_mggp": ("exact", "mggp", "per_factor", "per_factor", 1e-2, {}),
    "hybrid_shared_chol": ("hybrid", "svgp", "equal", "per_factor", 1e-1,
                           dict(shared_kernel=True)),
    "hybrid_not_factored": ("hybrid", "svgp", "per_factor", "per_factor", 1e-1,
                            dict(factored=False)),
}


def build_case(case, coords, groups):
    """(JAX model, port model) of a case of :data:`CASES`."""
    head, prior, kind, layout, jitter, _ = CASES[case]
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    mggp = prior.startswith("mggp")
    gp = _jgp(prior, _jkernel(kind, rng, mggp), layout, jitter, rng, coords, groups)
    w_raw = jnp.asarray(rng.uniform(0, 1, (D, L)))
    v_raw = jnp.asarray(rng.normal(1.0, 0.2, N))
    if head in ("hybrid", "exact"):
        prior2 = gz.gps.GaussianPrior(
            mean=jnp.asarray(0.3 * rng.standard_normal((T_MF, N))),
            scale_raw=jnp.asarray(rng.uniform(-1, 0.5, (T_MF, N))), scale_pf=0.7)
        cls = gz.models.HybridNSFExact if head == "exact" else gz.models.HybridNSF
        jmodel = cls(sf=gz.models.PoissonFactorization(prior=gp, W_raw=w_raw),
                     cf=gz.models.PoissonFactorization(
                         prior=prior2, W_raw=jnp.asarray(rng.uniform(0, 1, (D, T_MF)))),
                     V_raw=v_raw)
        tmodel = hybrid_from_numpy(jax_leaves(jmodel), "cpu", torch.float64, prior=prior,
                                   exact=head == "exact", jitter=jitter,
                                   var_floor=getattr(gp, "var_floor", 1e-6),
                                   scale_pf=0.7)
    elif mggp:
        jmodel = gz.models.MGGPNSF(gp=gp, W_raw=w_raw, V_raw=v_raw)
        tmodel = mggp_nsf_from_numpy(jax_leaves(jmodel), "cpu", torch.float64,
                                     jitter=jitter, var_floor=getattr(gp, "var_floor", 0),
                                     whitened=prior == "mggp_wsvgp")
    elif head == "nb":
        jmodel = gz.models.NBNSF(prior=gp, W_raw=w_raw, V_raw=v_raw,
                                 r_raw=jnp.asarray(rng.uniform(0.5, 3.0, D)))
        tmodel = nbnsf_from_numpy(jax_leaves(jmodel), "cpu", torch.float64,
                                  jitter=jitter, var_floor=gp.var_floor)
    else:
        jmodel = gz.models.NSF(prior=gp, W_raw=w_raw, V_raw=v_raw)
        make = wsvgp_nsf_from_numpy if prior == "wsvgp" else functools.partial(
            nsf_from_numpy, var_floor=gp.var_floor)
        tmodel = make(jax_leaves(jmodel), "cpu", torch.float64, jitter=jitter)
    return jmodel, tmodel


def jax_draws(key, E, qf_rows, head):
    """(eps, eps2) as the JAX blockwise loss draws them from ``key``."""
    if head == "exact":
        return None, None
    key2 = None
    if head == "hybrid":
        key, key2 = jax.random.split(key)
    eps = np.asarray(jax.random.normal(key, (E, qf_rows, B), dtype=jnp.float64))
    eps2 = (None if key2 is None else
            np.asarray(jax.random.normal(key2, (E, T_MF, B), dtype=jnp.float64)))
    return eps, eps2


def _batch(seed):
    k_idx, key = jax.random.split(jax.random.PRNGKey(seed))
    return jax.random.choice(k_idx, N, (B,), replace=False), key


def _compare_case(data, case, E=2, **override):
    """The JAX loss and the gradient of every leaf against the port's."""
    coords, y, groups = data
    head, prior, *_, opts = CASES[case]
    kw = dict(dict(factored=True), **opts, **override)
    port_kw = dict(kw, E=E, microbatch=MB, y_transposed=True)
    jkw = dict(kw, E=E, microbatch=MB, y_transposed=True)
    if prior.startswith("mggp"):
        jkw["groups"] = jnp.asarray(groups)
        port_kw["groups"] = T(groups)
    jkw["remat"] = jkw.get("remat", True)
    jmodel, tmodel = build_case(case, coords, groups)
    idx, key = _batch(zlib.crc32(case.encode()) % 1000)
    jval, jgrad = _value_and_grad(lambda m: j_batched(
        m, jnp.asarray(coords), jnp.asarray(y), idx, key, **jkw), jmodel)
    eps, eps2 = jax_draws(key, E, L, head)
    tval = gt.nsf_negative_elbo_batched(
        tmodel, T(coords), T(y), T(np.asarray(idx)),
        None if eps is None else T(eps), None if eps2 is None else T(eps2), **port_kw)
    tval.backward()
    _close(tval, jval)
    jg = jax_leaves(jgrad)
    reached = 0
    for path, p in tmodel.named_parameters():
        if p.grad is None:
            assert not np.any(jg[path]), path
            continue
        _close(p.grad, jg[path])
        reached += 1
    assert reached >= 4
    return tmodel


@pytest.mark.parametrize("case", sorted(CASES))
def test_blockwise_branch_matches_jax(data, case):
    _compare_case(data, case)


def test_stable_projection_gate_follows_jax():
    """The shared-Cholesky projection form: stable below a jitter of 1e-2
    unless overridden, always for a whitened prior (train/policy.py)."""
    from gpzoo_tpu.train.policy import resolve_policy

    from gpzoo_tpu_torch.train.fast import WELL_JITTERED
    from gpzoo_tpu.train.policy import WELL_JITTERED as J_WELL_JITTERED

    assert WELL_JITTERED == J_WELL_JITTERED
    for jitter in (1e-1, 1e-2, 1e-3):
        for whitened in (False, True):
            pol = resolve_policy(jitter, whitened=whitened, factored=True,
                                 per_factor_chol=False)
            assert pol.stable_projection == (whitened or jitter < WELL_JITTERED)


# --- the linear algebra -------------------------------------------------------

def _spd(rng, lead, m):
    a = rng.standard_normal(lead + (m, m))
    return a @ np.swapaxes(a, -1, -2) / m + np.eye(m)


@pytest.mark.parametrize("m,block", [(20, 512), (100, 32), (130, 64), (300, 64)])
def test_tri_inverse_matches_jax(m, block):
    """Below ``block`` one solve; above it the recursion, split at a
    multiple of 128 (130, 300) or at m // 2 where that is not below m
    (100)."""
    lz = np.linalg.cholesky(_spd(np.random.default_rng(m), (2,), m))
    _close(linalg.tri_inverse(T(lz), block=block),
           jlinalg.tri_inverse(jnp.asarray(lz), block=block), 1e-10)
    _close(linalg.spd_inverse_from_cholesky(T(lz), block=block),
           jlinalg.spd_inverse_from_cholesky(jnp.asarray(lz), block=block), 1e-10)
    _close(linalg.spd_inverse_from_cholesky(T(lz)),
           jlinalg.spd_inverse_from_cholesky(jnp.asarray(lz)), 1e-10)


@pytest.mark.parametrize("m,block", [(20, 512), (300, 64)])
def test_cholesky_blocked_matches_jax(m, block):
    k = _spd(np.random.default_rng(m + 1), (2,), m)
    _close(linalg.cholesky_blocked(T(k), block=block),
           jlinalg.cholesky_blocked(jnp.asarray(k), block=block), 1e-10)


def test_cholesky_mm_gradient_matches_jax():
    """The value is the library Cholesky; the gradient of a linear
    functional of it matches ``jax.grad`` through ``gz.ops.cholesky_mm``."""
    rng = np.random.default_rng(4)
    k = _spd(rng, (2,), 40)
    g = np.tril(rng.standard_normal((2, 40, 40)))
    jk = jnp.asarray(k)
    jgrad = jax.grad(lambda a: jnp.sum(jnp.asarray(g) * gz.ops.cholesky_mm(a)))(jk)
    tk = T(k).requires_grad_()
    lz = linalg.cholesky_mm(tk)
    _close(lz, np.linalg.cholesky(k), 1e-12)
    torch.sum(T(g) * lz).backward()
    _close(tk.grad, jgrad)


# --- the full-batch step, the configurations, the simulator --------------------

def test_make_train_step_hybrid_matches_optax():
    """Five full-batch Adam steps of a small HybridNSFConfig (cell 15's
    trainables, two chunks, W clamped at 0 after each update, some of it
    starting below) against optax on the same draws: the losses and every
    leaf after the last step."""
    cfg = gz.HybridNSFConfig(D=12, N=60, L=2, T=2, M_grid=5, E=3, lr=1e-3)
    coords, counts, _ = gz.data.simulate_nsf_counts(N=cfg.N, D=cfg.D, L=cfg.L)
    x, y = jnp.asarray(coords, jnp.float64), jnp.asarray(counts, jnp.float64)
    n_train = 54
    idx_full = jnp.arange(n_train)
    jmodel = cfg.build(jax.random.PRNGKey(0))
    # a few loadings start below 0, so that the clamp has work to do
    jmodel = jmodel.replace(sf=jmodel.sf.replace(W_raw=jmodel.sf.W_raw - 0.05))
    assert float(jnp.min(jmodel.sf.W_raw)) < 0
    mask = trainable_mask(jmodel, cfg.trainable)
    opt = partition_optimizer(cfg.optimizer(), mask)
    kw = dict(E=cfg.E, microbatch=n_train // 2, factored=True)
    loss = freeze_loss(lambda m, key: j_batched(m, x, y, idx_full, key, **kw), mask)
    value_and_grad = jax.jit(lambda m, key: _value_and_grad(lambda m_: loss(m_, key), m))
    key = jax.random.PRNGKey(1)
    state, jlosses, draws = opt.init(jmodel), [], []
    tmodel = hybrid_from_numpy(jax_leaves(jmodel), "cpu", torch.float64,
                               jitter=cfg.jitter, scale_pf=cfg.scale_pf)
    tmodel = gt.freeze_(tmodel, gt.HybridNSFConfig.trainable.__get__(cfg))
    for _ in range(5):
        key, sub = jax.random.split(key)
        k1, k2 = jax.random.split(sub)
        draws.append((jax.random.normal(k1, (cfg.E, cfg.L, n_train)),
                      jax.random.normal(k2, (cfg.E, cfg.T, n_train))))
        val, grads = value_and_grad(jmodel, sub)
        updates, state = opt.update(grads, state, jmodel)
        jmodel = gz.train.clamp_nonnegative(optax.apply_updates(jmodel, updates))
        jlosses.append(float(val))
    feed = iter(draws)

    def loss_fed(model, x_, y_, idx, eps, eps2, **kw_):
        # the step's own draws are replaced by the JAX sequence
        assert eps.shape == (cfg.E, cfg.L, n_train) and eps2.shape == (cfg.E, cfg.T, n_train)
        jeps, jeps2 = next(feed)
        return gt.nsf_negative_elbo_batched(model, x_, y_, idx, T(np.asarray(jeps)),
                                            T(np.asarray(jeps2)), **kw_)

    step = gt.make_train_step(loss_fed, torch.optim.Adam(
        [p for p in tmodel.parameters() if p.requires_grad], lr=cfg.lr),
        n_train, cfg.L, torch.Generator().manual_seed(0), E=cfg.E,
        loss_kwargs=kw, project=gt.clamp_nonnegative)
    tlosses = gt.run_steps(step, tmodel, (T(coords, dtype=torch.float64),
                                          T(counts, dtype=torch.float64),
                                          torch.arange(n_train)), 5)
    np.testing.assert_allclose(tlosses.numpy(), jlosses, rtol=TOL)
    jl = jax_leaves(jmodel)
    for path, p in tmodel.named_parameters():
        _close(p, jl[path])


def _trainable_paths(jmodel, trainable):
    return {_path_str(p): bool(v) for p, v in
            jax.tree_util.tree_flatten_with_path(trainable_mask(jmodel, trainable))[0]}


def test_hybrid_configs_match_jax(data):
    """Each configuration's leaves (paths and shapes) and trainable rule
    against the JAX one's, path by path; the Hybrid-MGGP inducing subset
    is the same rows."""
    coords, _, groups = data
    cfg, jcfg = gt.HybridNSFConfig(D=12, N=60, M_grid=5), gz.HybridNSFConfig(
        D=12, N=60, M_grid=5)
    cases = [(cfg.build(torch.Generator().manual_seed(0), torch.float64),
              jcfg.build(jax.random.PRNGKey(0)), cfg, jcfg)]
    cfg, jcfg = (c(D=12, N=N, M_per_group=4, n_groups=G) for c in (
        gt.SlideseqHybridMGGPConfig, gz.SlideseqHybridMGGPConfig))
    cases.append((cfg.build(torch.Generator().manual_seed(0), T(coords), T(groups)),
                  jcfg.build(jax.random.PRNGKey(0), X=coords, groups=groups), cfg, jcfg))
    for tmodel, jmodel, cfg, jcfg in cases:
        jl = jax_leaves(jmodel)
        jtrain = _trainable_paths(jmodel, jcfg.trainable)
        tl = dict(tmodel.named_parameters())
        assert set(tl) | {"sf.prior.groupsZ"} >= set(jl) - {"sf.prior.groupsZ"}
        for path, p in tl.items():
            assert tuple(p.shape) == jl[path].shape, path
            assert p.requires_grad == cfg.trainable(path) == jtrain[path], path
        assert any(p.requires_grad for p in tl.values())
    tmodel, jmodel = cases[1][:2]
    _close(tmodel.sf.prior.Z, jmodel.sf.prior.Z, 0)
    assert np.array_equal(tmodel.sf.prior.groupsZ.numpy(), np.asarray(jmodel.sf.prior.groupsZ))


@pytest.mark.parametrize("name,kw", [
    ("simulate_nsf_counts", dict(seed=3, N=300, D=20, L=5)),
    ("simulate_nb_counts", dict(seed=4, N=200, D=15, L=3, total_count=2.0)),
    ("simulate_1d_regression", dict(key_or_seed=5, n=500)),
    ("simulate_shape_images", dict(seed=6, D=10, side=8)),
])
def test_simulators_bit_identical_to_jax(name, kw):
    from gpzoo_tpu.data import sim as jsim

    from gpzoo_tpu_torch.data import sim

    for got, expect in zip(getattr(sim, name)(**kw), getattr(jsim, name)(**kw)):
        assert got.dtype == expect.dtype and np.array_equal(got, expect)


# --- the whitened multi-group prior and the hybrid deviance with groups --------

def test_mggp_wsvgp_posterior_matches_jax(data):
    coords, _, groups = data
    jmodel, tmodel = build_case("whitened_mggp", coords, groups)
    jqf, _, _ = jmodel.gp(jnp.asarray(coords), groups_x=jnp.asarray(groups))
    mean, scale = gt.latent_posterior(tmodel.gp, T(coords), T(groups), chunk_size=50)
    _close(mean, jqf.mean)
    _close(scale, jqf.scale)


@pytest.mark.parametrize("case", ["hybrid_mggp", "hybrid_svgp"])
def test_hybrid_posterior_deviance_matches_jax(data, case):
    """bench.py's held-out hybrid deviance, with the spots' labels for the
    multi-group spatial half."""
    from gpzoo_tpu_torch.data import hybrid_posterior_deviance

    coords, y, groups = data
    jmodel, tmodel = build_case(case, coords, groups)
    vidx = np.arange(N - 30, N)
    gv = None if case == "hybrid_svgp" else jnp.asarray(groups[vidx])
    fmean, _ = j_latent_posterior(jmodel.sf.prior, jnp.asarray(coords[vidx]), groups=gv)
    sp = jax.nn.softplus
    rate = sp(jmodel.V_raw[vidx]) * (sp(jmodel.sf.W_raw) @ jnp.exp(fmean)
                                     + sp(jmodel.cf.W_raw) @ jnp.exp(
                                         jmodel.cf.prior.mean[:, vidx]))
    expect = j_poisson_deviance(jnp.asarray(y[vidx].T), rate)
    got = hybrid_posterior_deviance(tmodel, T(coords), T(y), T(vidx),
                                    None if gv is None else T(groups))
    _close(got, expect)


# --- float32 through Kzz⁻¹: the port against JAX's own float32 step -----------

F32_N, F32_L, F32_G, F32_MPER, F32_B = 400, 3, 4, 40, 200
#: below this relative error a leaf is at float32's own rounding of its
#: sums (~sqrt(B·D)·2⁻²⁴ ≈ 1e-5), where the ratio of two errors is chance
F32_FLOOR = 1e-5


def _f32_model(jitter):
    """MGGPNSFConfig's kernel at a reduced shape (M = 160 over 4 groups)
    with distinct per-factor hyperparameters, per-factor μ and Lu."""
    rng = np.random.default_rng(7)
    coords = rng.uniform(-2, 2, (F32_N, 2))
    groups = rng.integers(0, F32_G, F32_N)
    y = rng.poisson(3.0, (F32_N, D)).astype(np.float64)
    cfg = gz.MGGPNSFConfig(D=D, N=F32_N, L=F32_L, M_per_group=F32_MPER,
                           n_groups=F32_G, jitter=jitter)
    model = cfg.build(jax.random.PRNGKey(0), X=jnp.asarray(coords), groups=groups)
    m = cfg.M
    kernel = model.gp.kernel.replace(
        sigma=jnp.asarray(rng.uniform(0.8, 1.3, (F32_L, 1, 1))),
        lengthscale=jnp.asarray(rng.uniform(1.0, 2.0, (F32_L, 1, 1))),
        group_diff_param=jnp.asarray(rng.uniform(1.5, 2.5, (F32_L, 1, 1))))
    gp = model.gp.replace(kernel=kernel,
                          mu=jnp.asarray(0.3 * rng.standard_normal((F32_L, m))),
                          Lu_raw=jnp.asarray(np.tril(0.05 * rng.standard_normal(
                              (F32_L, m, m)))))
    return model.replace(gp=gp), coords, y, groups


F32_BATCHES = 4


@pytest.mark.parametrize("jitter", [1e-1, 1e-2])
def test_float32_through_kzz_inverse_no_worse_than_jax(jitter):
    """The MGGP W-form step in float32, the port's and JAX's (jitted, x64
    off), each against the float64 step on the same idx and draws (float64
    draws, cast): per leaf, the port's relative error is at most twice
    JAX's, or within float32's own rounding of the step's sums
    (F32_FLOOR). One step's error through Kzz⁻¹ is rounding noise whose
    size varies two- to threefold from batch to batch in either package,
    so each error is the root mean square over F32_BATCHES batches."""
    from unittest import mock

    jmodel, coords, y, groups = _f32_model(jitter)
    kw = dict(E=1, microbatch=F32_B // 2, factored=True, y_transposed=True,
              remat=False)

    def value_and_grad(model, x, y_, idx, groups_, eps):
        # the loss draws its eps from its key: these draws instead
        with mock.patch.object(jax.random, "normal",
                               lambda k, shape, dtype: eps.astype(dtype).reshape(shape)):
            return _value_and_grad(lambda m: j_batched(
                m, x, y_, idx, jax.random.PRNGKey(0), groups=groups_, **kw), model)

    jit64 = jax.jit(value_and_grad)
    with jax.enable_x64(False):
        jit32 = jax.jit(value_and_grad)
        jmodel32 = jax.tree_util.tree_map(lambda a: jnp.asarray(
            a, jnp.float32 if np.issubdtype(np.asarray(a).dtype, np.floating)
            else jnp.int32), jmodel)
    tmodel = mggp_nsf_from_numpy(jax_leaves(jmodel), "cpu", torch.float32, jitter=jitter)

    def err(got, expect):
        got, expect = np.asarray(got, np.float64), np.asarray(expect, np.float64)
        return float(np.max(np.abs(got - expect)) / max(np.max(np.abs(expect)), 1e-300))

    sq = {}
    for k in range(F32_BATCHES):
        idx = np.asarray(jax.random.choice(jax.random.PRNGKey(1 + k), F32_N, (F32_B,),
                                           replace=False))
        eps = np.asarray(jax.random.normal(jax.random.PRNGKey(10 + k), (1, F32_L, F32_B),
                                           dtype=jnp.float64))
        ref, ref_grad = jit64(jmodel, jnp.asarray(coords), jnp.asarray(y), jnp.asarray(idx),
                              jnp.asarray(groups), jnp.asarray(eps))
        ref_grad = jax_leaves(ref_grad)
        with jax.enable_x64(False):
            jval, jgrad = jit32(jmodel32, jnp.asarray(coords, jnp.float32),
                                jnp.asarray(y, jnp.float32), jnp.asarray(idx, jnp.int32),
                                jnp.asarray(groups, jnp.int32), jnp.asarray(eps, jnp.float32))
            jval, jgrad = float(jval), jax_leaves(jgrad)
        tmodel.zero_grad(set_to_none=True)
        tval = gt.nsf_negative_elbo_batched(
            tmodel, T(coords, dtype=torch.float32), T(y, dtype=torch.float32), T(idx),
            T(eps, dtype=torch.float32), groups=T(groups), **kw)
        tval.backward()
        pairs = {"loss": (float(tval.detach()), jval, float(ref))}
        for path, p in tmodel.named_parameters():
            # column 0 of the MDS embedding is the centring's null direction:
            # its reference gradient is 0, so both packages' is rounding noise
            cols = slice(1, None) if path.endswith("embedding") else slice(None)
            pairs[path] = (p.grad.numpy()[..., cols], jgrad[path][..., cols],
                           ref_grad[path][..., cols])
        for name, (got, jgot, expect) in pairs.items():
            acc = sq.setdefault(name, [0.0, 0.0])
            acc[0] += err(got, expect) ** 2 / F32_BATCHES
            acc[1] += err(jgot, expect) ** 2 / F32_BATCHES
    report = {name: (np.sqrt(a), np.sqrt(b)) for name, (a, b) in sq.items()}
    worse = {k: v for k, v in report.items() if v[0] > max(2 * v[1], F32_FLOOR)}
    assert not worse, (report, worse)


# --- what the blockwise loss refuses -----------------------------------------

@pytest.mark.parametrize("case", ["lowrank", "legacy_hybrid", "vnngp"])
def test_blockwise_refuses_what_jax_refuses(data, case):
    """LowRankWSVGP (its loss is the precomputed one), a LegacyHybridNSF's
    raw loadings (``W2_raw``) and a VNNGP prior (its losses are its own)."""
    coords, y, _ = data
    if case == "lowrank":
        model = gt.SlideseqNSFConfig(D=D, N=N, L=L, M=M, rank=2).build(
            torch.Generator().manual_seed(0), T(coords))
    elif case == "vnngp":
        model = gt.VNNGPConfig(D=D, N=N, L=L, M=M, K=4).build(
            torch.Generator().manual_seed(0), T(coords))
    else:
        model = build_case("hybrid_svgp", coords, np.zeros(N, int))[1]
        model.W2_raw = torch.nn.Parameter(torch.zeros((D, T_MF), dtype=torch.float64))
    with pytest.raises(NotImplementedError):
        gt.nsf_negative_elbo_batched(model, T(coords), T(y), torch.arange(B),
                                     torch.zeros((1, L, B), dtype=torch.float64),
                                     factored=True, y_transposed=True, microbatch=MB)


@pytest.mark.parametrize("case,draws", [
    ("hybrid_svgp", "no_eps2"), ("hybrid_svgp", "eps2_other_E"),
    ("exact_svgp", "eps"), ("collapse_fast_leg", "eps2"),
    ("collapse_fast_leg", "eps_shape")])
def test_blockwise_rejects_wrong_draws(data, case, draws):
    """eps (E, L, B) for the GP half, eps2 (E, T, B) for a HybridNSF's
    mean-field half with the same E, and neither for HybridNSFExact."""
    coords, y, groups = data
    _, tmodel = build_case(case, coords, groups)
    eps = torch.zeros((2, L, B), dtype=torch.float64)
    eps2 = torch.zeros((2, T_MF, B), dtype=torch.float64)
    args = {"no_eps2": (eps, None), "eps2_other_E": (eps, eps2[:1]),
            "eps": (eps, None), "eps2": (eps, eps2),
            "eps_shape": (eps[:, :, :MB], None)}[draws]
    with pytest.raises(ValueError):
        gt.nsf_negative_elbo_batched(tmodel, T(coords), T(y), torch.arange(B), *args,
                                     E=2, factored=True, y_transposed=True,
                                     microbatch=MB, shared_kernel=True)
