"""The port's generic ELBO path against gpzoo_tpu, in float64 on the CPU.

Every loss of ``train/elbo.py`` over every head with a generic forward
(NSF, NBNSF, LegacyNSF, MGGPNSF, HybridNSF, HybridNSFExact,
LegacyHybridNSF, PNMF, the Gaussian likelihoods) and over SVGP, WSVGP,
VNNGP and MGGPSVGP priors (BatchedRBF and Matern32 kernels too): the loss
and the gradient of every leaf at 1e-8, the same idx and draws fed to both
packages (JAX's ``jax.random.normal`` is patched to return the port's
draws, in the order the JAX heads draw them). Then five-step Adam
trajectories against ``optax.adam`` (NSFConfig, PNMFConfig, a
LegacyHybridNSF under ``clamp_nonnegative``), the configurations' leaves,
the host metrics and the converters' round-trips.
"""

from __future__ import annotations

import zlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gpzoo_tpu as gz
from gpzoo_tpu.train import elbo as jelbo
from gpzoo_tpu.train.loop import _path_str, _value_and_grad

import gpzoo_tpu_torch as gt
from gpzoo_tpu_torch import convert
from gpzoo_tpu_torch.train import elbo

N, D, L, M, B, T_MF, G, K, E = 60, 8, 3, 12, 20, 2, 3, 4, 2
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
    counts = rng.poisson(3.0, (D, N)).astype(np.float64)  # (D, N), as JAX takes it
    groups = rng.integers(0, G, N)
    return coords, counts, groups


# --- the JAX model of every case, and its port --------------------------------

def _jkernel(kernel, rng, prior):
    """An L-batched kernel with distinct per-factor hyperparameters:
    "rbf" NSFRBF (L, 1, 1), "batched" BatchedRBF (L,), "matern32" (L,); an
    MGGPNSFRBF for an MGGP prior."""
    if prior == "mggp":
        k = gz.kernels.MGGPNSFRBF.create(n_groups=G, L=L)
        return k.replace(sigma=jnp.asarray(rng.uniform(0.8, 1.3, (L, 1, 1))),
                         lengthscale=jnp.asarray(rng.uniform(1.0, 2.0, (L, 1, 1))),
                         group_diff_param=jnp.asarray(rng.uniform(0.5, 1.5, (L, 1, 1))))
    shape = (L, 1, 1) if kernel == "rbf" else (L,)
    cls = {"rbf": gz.kernels.NSFRBF, "batched": gz.kernels.BatchedRBF,
           "matern32": gz.kernels.Matern32}[kernel]
    return cls(sigma=jnp.asarray(rng.uniform(0.8, 1.3, shape)),
               lengthscale=jnp.asarray(rng.uniform(0.7, 1.2, shape)))


def _jgp(prior, kernel, rng, coords, groups, jitter=1e-1):
    """A JAX prior with a non-trivial per-factor q(u)."""
    fields = dict(kernel=kernel, Z=jnp.asarray(rng.uniform(-2, 2, (M, 2))),
                  mu=jnp.asarray(0.5 * rng.standard_normal((L, M))),
                  Lu_raw=jnp.asarray(np.tril(0.2 * rng.standard_normal((L, M, M)))),
                  jitter=jitter)
    if prior == "mggp":
        take = rng.choice(N, M, replace=False)
        return gz.gps.MGGPSVGP(**dict(fields, Z=jnp.asarray(coords[take]),
                                      groupsZ=jnp.asarray(groups[take])))
    if prior == "vnngp":
        return gz.gps.VNNGP(**fields, K=K)
    return (gz.gps.WSVGP if prior == "wsvgp" else gz.gps.SVGP)(**fields)


def _prior_kw(gp, prior):
    return dict(var_floor=gp.var_floor) if hasattr(gp, "var_floor") else {}


def _mean_field(rng, rows):
    return gz.gps.GaussianPrior(mean=jnp.asarray(0.3 * rng.standard_normal((rows, N))),
                                scale_raw=jnp.asarray(rng.uniform(-1, 0.5, (rows, N))),
                                scale_pf=0.7)


def build(head, prior, kernel, coords, groups, seed):
    """(JAX model, port model) of ``head`` over ``prior``."""
    rng = np.random.default_rng(seed)
    w_raw = jnp.asarray(rng.uniform(0, 1, (D, L)))
    v_raw = jnp.asarray(rng.normal(1.0, 0.2, N))
    if head == "pnmf":
        jmodel = gz.models.PNMF(prior=_mean_field(rng, L), W_raw=w_raw, V_raw=v_raw)
        tmodel = convert.pnmf_from_numpy(jax_leaves(jmodel), "cpu", torch.float64, 0.7)
        return jmodel, tmodel
    gp = _jgp(prior, _jkernel(kernel, rng, prior), rng, coords, groups)
    kw = dict(jitter=gp.jitter, K=K if prior == "vnngp" else None, **_prior_kw(gp, prior))
    if head in ("hybrid", "exact"):
        cls = gz.models.HybridNSFExact if head == "exact" else gz.models.HybridNSF
        jmodel = cls(sf=gz.models.PoissonFactorization(prior=gp, W_raw=w_raw),
                     cf=gz.models.PoissonFactorization(
                         prior=_mean_field(rng, T_MF),
                         W_raw=jnp.asarray(rng.uniform(0, 1, (D, T_MF)))),
                     V_raw=v_raw)
        tmodel = convert.hybrid_from_numpy(jax_leaves(jmodel), "cpu", torch.float64,
                                           prior=prior, exact=head == "exact",
                                           scale_pf=0.7, **kw)
    elif head == "legacy_hybrid":
        jmodel = gz.models.LegacyHybridNSF(
            gp=gp, W_raw=w_raw, W2_raw=jnp.asarray(rng.uniform(0, 1, (D, T_MF))),
            mF=jnp.asarray(0.3 * rng.standard_normal((T_MF, N))),
            scale_qF_raw=jnp.asarray(rng.uniform(-1, 0.5, (T_MF, N))), V_raw=v_raw)
        tmodel = convert.legacy_hybrid_from_numpy(jax_leaves(jmodel), "cpu",
                                                  torch.float64, prior=prior,
                                                  kernel=kernel, **kw)
    elif head == "legacy_nsf":
        jmodel = gz.models.LegacyNSF(gp=gp, W_raw=w_raw, V_raw=v_raw)
        tmodel = convert.legacy_nsf_from_numpy(jax_leaves(jmodel), "cpu", torch.float64,
                                               prior=prior, kernel=kernel, **kw)
    elif head == "mggp":
        jmodel = gz.models.MGGPNSF(gp=gp, W_raw=w_raw, V_raw=v_raw)
        tmodel = convert.mggp_nsf_from_numpy(jax_leaves(jmodel), "cpu", torch.float64,
                                             jitter=gp.jitter, var_floor=gp.var_floor)
    else:
        extra = {} if head == "nsf" else {"r_raw": jnp.asarray(rng.uniform(0.5, 3.0, D))}
        cls = gz.models.NSF if head == "nsf" else gz.models.NBNSF
        jmodel = cls(prior=gp, W_raw=w_raw, V_raw=v_raw, **extra)
        leaves = jax_leaves(jmodel)
        if prior == "vnngp":
            tmodel = convert.vnngp_from_numpy(leaves, "cpu", torch.float64,
                                              kernel=kernel, **kw)
        elif prior == "wsvgp":
            tmodel = convert.wsvgp_nsf_from_numpy(leaves, "cpu", torch.float64,
                                                  jitter=gp.jitter, kernel=kernel)
        else:
            tmodel = convert.nsf_from_numpy(leaves, "cpu", torch.float64, jitter=gp.jitter,
                                            var_floor=gp.var_floor, kernel=kernel)
    return jmodel, tmodel


def build_gaussian(prior, kernel, exact, seed):
    """A single-output GP under a Gaussian likelihood on 1-D inputs: JAX
    and port, with the 1-D data."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 6, (N, 1))
    y = 2 * np.sin(2 * x[:, 0]) + 0.3 * rng.standard_normal(N)
    cls = {"rbf": gz.kernels.RBF, "matern32": gz.kernels.Matern32}[kernel]
    kern = cls(sigma=jnp.asarray(1.2), lengthscale=jnp.asarray(0.8), input_dim=1)
    fields = dict(kernel=kern, Z=jnp.asarray(np.linspace(0, 6, M)[:, None]),
                  mu=jnp.asarray(0.5 * rng.standard_normal(M)),
                  Lu_raw=jnp.asarray(np.tril(0.2 * rng.standard_normal((M, M)))),
                  jitter=1e-3)
    gp = (gz.gps.WSVGP if prior == "wsvgp" else gz.gps.SVGP)(**fields)
    lik = gz.models.ExactLikelihood if exact else gz.models.GaussianLikelihood
    jmodel = lik.create(gp, noise=0.3)
    tmodel = convert.gaussian_from_numpy(jax_leaves(jmodel), "cpu", torch.float64,
                                         prior=prior, exact=exact, jitter=1e-3,
                                         kernel=kernel)
    return jmodel, tmodel, x, y


def _feed(*draws):
    """A patch of ``jax.random.normal`` returning ``draws`` in order."""
    it = iter([d for d in draws if d is not None])

    def normal(key, shape=(), dtype=None):
        out = next(it)
        assert tuple(shape) == out.shape, (shape, out.shape)
        return jnp.asarray(out, dtype)

    return mock.patch.object(jax.random, "normal", normal)


def _compare(jloss, tloss, jmodel, tmodel, draws, min_reached=3):
    """The JAX loss (draws fed) and every leaf's gradient against the port's."""
    with _feed(*draws):
        jval, jgrad = _value_and_grad(jloss, jmodel)
    tmodel.zero_grad(set_to_none=True)
    tval = tloss(tmodel)
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
    assert reached >= min_reached


def _draws(rng, rows, n, head):
    eps = None if head == "exact" else rng.standard_normal((E, rows, n))
    eps2 = (rng.standard_normal((E, T_MF, n))
            if head in ("hybrid", "legacy_hybrid") else None)
    return eps, eps2


# head, prior, kernel of each GP-head case; every one runs the full-batch and
# the minibatch loss of its kind
GP_CASES = [
    ("nsf", "svgp", "rbf"), ("nsf", "wsvgp", "rbf"), ("nsf", "vnngp", "rbf"),
    ("nsf", "svgp", "batched"), ("nsf", "svgp", "matern32"), ("nsf", "vnngp", "matern32"),
    ("nb", "svgp", "rbf"), ("nb", "vnngp", "rbf"),
    ("legacy_nsf", "svgp", "rbf"), ("legacy_nsf", "wsvgp", "rbf"),
    ("legacy_nsf", "vnngp", "rbf"),
    ("mggp", "mggp", "rbf"),
    ("hybrid", "svgp", "rbf"), ("hybrid", "wsvgp", "rbf"), ("hybrid", "vnngp", "rbf"),
    ("hybrid", "mggp", "rbf"),
    ("exact", "svgp", "rbf"), ("exact", "wsvgp", "rbf"), ("exact", "vnngp", "rbf"),
    ("exact", "mggp", "rbf"),
    ("legacy_hybrid", "svgp", "rbf"), ("legacy_hybrid", "wsvgp", "rbf"),
    ("legacy_hybrid", "vnngp", "rbf"),
]


def _case_id(case):
    return "-".join(case)


@pytest.mark.parametrize("batched", [False, True], ids=["full", "batched"])
@pytest.mark.parametrize("case", GP_CASES, ids=_case_id)
def test_gp_head_loss_matches_jax(data, case, batched):
    """negative_elbo(_batched) for the one-GP heads, negative_elbo_hybrid
    (_batched) for the hybrids: loss and every leaf's gradient."""
    coords, y, groups = data
    head, prior, kernel = case
    seed = zlib.crc32(_case_id(case).encode())
    jmodel, tmodel = build(head, prior, kernel, coords, groups, seed)
    rng = np.random.default_rng(seed + 1)
    idx = rng.choice(N, B, replace=False)
    eps, eps2 = _draws(rng, L, B if batched else N, head)
    hybrid = head in ("hybrid", "exact", "legacy_hybrid")
    jkw, tkw = {}, {}
    if prior == "mggp":
        jkw["groups_x"], tkw["groups_x"] = jnp.asarray(groups), T(groups)
    jx, jy, tx, ty = jnp.asarray(coords), jnp.asarray(y), T(coords), T(y)
    td = [None if d is None else T(d) for d in (eps, eps2)]
    key = jax.random.PRNGKey(0)
    if hybrid and batched:
        def jloss(m):
            return jelbo.negative_elbo_hybrid_batched(m, jx, jy, jnp.asarray(idx), key,
                                                      E=E, **jkw)

        def tloss(m):
            return elbo.negative_elbo_hybrid_batched(m, tx, ty, T(idx), *td, **tkw)
    elif hybrid:
        def jloss(m):
            return jelbo.negative_elbo_hybrid(m, jx, jy, key, E=E, **jkw)

        def tloss(m):
            return elbo.negative_elbo_hybrid(m, tx, ty, *td, **tkw)
    elif batched:
        def jloss(m):
            return jelbo.negative_elbo_batched(m, jx, jy, jnp.asarray(idx), key, E=E, **jkw)

        def tloss(m):
            return elbo.negative_elbo_batched(m, tx, ty, T(idx), td[0], E=E, **tkw)
    else:
        def jloss(m):
            return jelbo.negative_elbo(m, jx, jy, key, E=E, **jkw)

        def tloss(m):
            return elbo.negative_elbo(m, tx, ty, td[0], E=E, **tkw)
    _compare(jloss, tloss, jmodel, tmodel, (eps, eps2))


@pytest.mark.parametrize("unnormalized", [False, True])
@pytest.mark.parametrize("case", [("nsf", "svgp", "rbf"), ("mggp", "mggp", "rbf"),
                                  ("nb", "svgp", "rbf")], ids=_case_id)
def test_batched_remat_and_normalization_match_jax(data, case, unnormalized):
    """negative_elbo_batched with ``remat=True`` (torch.utils.checkpoint)
    under both Poisson conventions."""
    coords, y, groups = data
    seed = zlib.crc32(_case_id(case).encode()) + 7
    jmodel, tmodel = build(*case, coords, groups, seed)
    rng = np.random.default_rng(seed)
    idx = rng.choice(N, B, replace=False)
    eps = rng.standard_normal((E, L, B))
    jkw, tkw = {}, {}
    if case[1] == "mggp":
        jkw["groups_x"], tkw["groups_x"] = jnp.asarray(groups), T(groups)
    _compare(lambda m: jelbo.negative_elbo_batched(
                 m, jnp.asarray(coords), jnp.asarray(y), jnp.asarray(idx),
                 jax.random.PRNGKey(0), E=E, unnormalized=unnormalized, remat=True, **jkw),
             lambda m: elbo.negative_elbo_batched(
                 m, T(coords), T(y), T(idx), T(eps), unnormalized=unnormalized,
                 remat=True, **tkw),
             jmodel, tmodel, (eps,))


@pytest.mark.parametrize("batched", [False, True], ids=["full", "batched"])
@pytest.mark.parametrize("unnormalized", [False, True])
def test_pnmf_loss_matches_jax(data, batched, unnormalized):
    _, y, _ = data
    jmodel, tmodel = build("pnmf", None, None, None, None, 11)
    rng = np.random.default_rng(12)
    idx = rng.choice(N, B, replace=False)
    eps = rng.standard_normal((E, L, B if batched else N))
    key = jax.random.PRNGKey(0)
    if batched:
        jloss = lambda m: jelbo.pnmf_negative_elbo_batched(  # noqa: E731
            m, jnp.asarray(y), jnp.asarray(idx), key, E=E, unnormalized=unnormalized)
        tloss = lambda m: elbo.pnmf_negative_elbo_batched(  # noqa: E731
            m, T(y), T(idx), T(eps), E=E, unnormalized=unnormalized)
    else:
        jloss = lambda m: jelbo.pnmf_negative_elbo(  # noqa: E731
            m, jnp.asarray(y), key, E=E, unnormalized=unnormalized)
        tloss = lambda m: elbo.pnmf_negative_elbo(  # noqa: E731
            m, T(y), T(eps), E=E, unnormalized=unnormalized)
    _compare(jloss, tloss, jmodel, tmodel, (eps,))


@pytest.mark.parametrize("loss,prior,kernel", [
    (loss, prior, kernel) for loss in ("negative_elbo", "gaussian_exact", "whitened")
    for prior in ("svgp", "wsvgp") for kernel in ("rbf", "matern32")
    if loss != "whitened" or prior == "wsvgp"])
def test_gaussian_likelihood_losses_match_jax(loss, prior, kernel):
    """The Gaussian likelihoods over a single-output SVGP or WSVGP: the
    sampled ELBO, the analytic one of ExactLikelihood and the whitened
    ELBO (over a WSVGP, the prior it pairs with)."""
    exact = loss == "gaussian_exact"
    jmodel, tmodel, x, y = build_gaussian(prior, kernel, exact, zlib.crc32(
        f"{loss}{prior}{kernel}".encode()))
    eps = None if exact else np.random.default_rng(3).standard_normal((E, N))
    jfn = {"negative_elbo": jelbo.negative_elbo,
           "gaussian_exact": jelbo.gaussian_exact_negative_elbo,
           "whitened": jelbo.whitened_negative_elbo}[loss]
    tfn = {"negative_elbo": elbo.negative_elbo,
           "gaussian_exact": elbo.gaussian_exact_negative_elbo,
           "whitened": elbo.whitened_negative_elbo}[loss]
    _compare(lambda m: jfn(m, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0), E=E),
             lambda m: tfn(m, T(x), T(y), None if eps is None else T(eps)),
             jmodel, tmodel, (eps,))


def test_posterior_nll_matches_jax(data):
    coords, y, groups = data
    jmodel, tmodel = build("nsf", "svgp", "rbf", coords, groups, 21)
    y_latent = np.random.default_rng(22).standard_normal((L, N))
    qf, _, _ = jmodel.prior(jnp.asarray(coords))
    expect = jelbo.posterior_nll(qf, jnp.asarray(y_latent))
    tqf, _, _ = tmodel.prior(T(coords))
    _close(elbo.posterior_nll(tqf, T(y_latent)), expect)


@pytest.mark.parametrize("kernel", ["matern32", "rbf"])
def test_gram_gradient_with_z_a_subset_of_x_matches_jax(kernel):
    """Z = rows of X exactly (d = 0), both arguments trained: Matern32
    (plain, its safe square root's gradient 0 at d = 0) and the RBF Gram as
    the port's kernels call it (kernel 3's closed-form backward on the
    CPU). No clamp's gradient reaches d = 0 in either, so this holds with
    any clamp; ``test_torch_ties.py`` guards the clamps."""
    rng = np.random.default_rng(1)
    x = rng.uniform(-2, 2, (30, 2))
    sigma, ell = np.array([1.1, 0.9]), np.array([0.8, 1.2])
    cot = rng.standard_normal((2, 30, 8))
    take = rng.choice(30, 8, replace=False)
    jcls = gz.kernels.Matern32 if kernel == "matern32" else gz.kernels.BatchedRBF
    tcls = gt.Matern32 if kernel == "matern32" else gt.BatchedRBF

    def jloss(a, s, l_):
        return jnp.sum(cot * jcls(sigma=s, lengthscale=l_).gram(a, a[take]))

    expect = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, sigma, ell)))
    tx = T(x).requires_grad_()
    k = tcls(T(sigma), T(ell))
    gram = k.gram(tx, tx[T(take)])
    torch.sum(T(cot) * gram).backward()
    for got, e in zip((tx.grad, k.sigma.grad, k.lengthscale.grad), expect):
        _close(got, e)


@pytest.mark.parametrize("case", ["exact_draws", "e_mismatch", "y_misaligned"])
def test_losses_reject_what_they_cannot_take(data, case):
    coords, y, groups = data
    if case == "exact_draws":
        _, tmodel = build("exact", "svgp", "rbf", coords, groups, 31)
        with pytest.raises(ValueError):
            elbo.negative_elbo_hybrid(tmodel, T(coords), T(y), torch.zeros((E, L, N)),
                                      torch.zeros((E, T_MF, N)))
        return
    _, tmodel = build("nsf", "svgp", "rbf", coords, groups, 32)
    if case == "e_mismatch":
        with pytest.raises(ValueError):
            elbo.negative_elbo(tmodel, T(coords), T(y), torch.zeros((E, L, N),
                                                                     dtype=torch.float64),
                               E=E + 1)
    else:
        with pytest.raises(ValueError):
            elbo.negative_elbo_batched(tmodel, T(coords), T(y[:, :-1]), torch.arange(B),
                                       torch.zeros((E, L, B), dtype=torch.float64))


# --- five-step Adam trajectories against optax ---------------------------------

def _trajectory(jmodel, tmodel, jloss, tloss, lr, draws, project=None, jproject=None,
                batch=N, n_factors=L, args=()):
    """Five Adam steps of both packages on the same draws: the losses, and
    every leaf after the last step. The port's step is ``make_train_step``
    with ``tloss`` fed the JAX draws in place of its own."""
    opt = optax.adam(lr)
    state, jlosses = opt.init(jmodel), []
    for eps, eps2 in draws:
        with _feed(eps, eps2):
            val, grads = _value_and_grad(jloss, jmodel)
        updates, state = opt.update(grads, state, jmodel)
        jmodel = optax.apply_updates(jmodel, updates)
        if jproject is not None:
            jmodel = jproject(jmodel)
        jlosses.append(float(val))
    feed = iter(draws)

    def loss_fed(model, *a, eps=None, eps2=None):
        jeps, jeps2 = next(feed)
        assert eps.shape == jeps.shape
        return tloss(model, *a, T(jeps), None if jeps2 is None else T(jeps2))

    step = gt.make_train_step(loss_fed, torch.optim.Adam(tmodel.parameters(), lr=lr),
                              batch, n_factors, torch.Generator().manual_seed(0), E=E,
                              project=project)
    _, tlosses = gt.train(tmodel, step, *args, steps=len(draws)) if len(args) == 2 else (
        None, gt.run_steps(step, tmodel, args, len(draws)).tolist())
    np.testing.assert_allclose(tlosses, jlosses, rtol=TOL)
    jl = jax_leaves(jmodel)
    for path, p in tmodel.named_parameters():
        _close(p, jl[path])


def test_nsf_config_trajectory_matches_optax():
    """NSFConfig, full batch, every leaf trained (Z and the kernel too)."""
    cfg = gz.NSFConfig(D=D, N=N, L=2, M=10, E=E)
    coords, counts, _ = gz.data.simulate_nsf_counts(N=N, D=D, L=2)
    x, y = np.asarray(coords, np.float64), np.asarray(counts, np.float64)
    jmodel = cfg.build(jax.random.PRNGKey(0), X=jnp.asarray(x))
    tmodel = convert.nsf_from_numpy(jax_leaves(jmodel), "cpu", torch.float64,
                                    jitter=cfg.jitter)
    rng = np.random.default_rng(5)
    draws = [(rng.standard_normal((E, cfg.L, N)), None) for _ in range(5)]
    _trajectory(jmodel, tmodel,
                lambda m: jelbo.negative_elbo(m, jnp.asarray(x), jnp.asarray(y),
                                              jax.random.PRNGKey(0), E=E),
                lambda m, x_, y_, eps, _: elbo.negative_elbo(m, x_, y_, eps),
                cfg.lr, draws, n_factors=cfg.L, args=(T(x), T(y)))


def test_pnmf_config_trajectory_matches_optax():
    cfg = gz.PNMFConfig(D=D, N=N, L=3, E=E)
    _, counts, _ = gz.data.simulate_nsf_counts(N=N, D=D, L=3)
    y = np.asarray(counts, np.float64)
    jmodel = cfg.build(jax.random.PRNGKey(0))
    tmodel = convert.pnmf_from_numpy(jax_leaves(jmodel), "cpu", torch.float64)
    rng = np.random.default_rng(6)
    draws = [(rng.standard_normal((E, cfg.L, N)), None) for _ in range(5)]
    _trajectory(jmodel, tmodel,
                lambda m: jelbo.pnmf_negative_elbo(m, jnp.asarray(y), jax.random.PRNGKey(0),
                                                   E=E),
                lambda m, y_, eps, _: elbo.pnmf_negative_elbo(m, y_, eps),
                cfg.lr, draws, n_factors=cfg.L, args=(T(y),))


def test_legacy_hybrid_trajectory_under_clamp_matches_optax(data):
    """LegacyHybridNSF's raw loadings, some starting below 0, clamped at 0
    after each update by ``clamp_nonnegative`` in both packages."""
    coords, y, groups = data
    jmodel, _ = build("legacy_hybrid", "svgp", "rbf", coords, groups, 41)
    jmodel = jmodel.replace(W_raw=jmodel.W_raw - 0.2, W2_raw=jmodel.W2_raw - 0.2)
    assert float(jnp.min(jmodel.W_raw)) < 0 and float(jnp.min(jmodel.W2_raw)) < 0
    jmodel = gz.train.clamp_nonnegative(jmodel)
    tmodel = convert.legacy_hybrid_from_numpy(jax_leaves(jmodel), "cpu", torch.float64,
                                              jitter=jmodel.gp.jitter,
                                              var_floor=jmodel.gp.var_floor)
    rng = np.random.default_rng(7)
    draws = [(rng.standard_normal((E, L, N)), rng.standard_normal((E, T_MF, N)))
             for _ in range(5)]
    _trajectory(jmodel, tmodel,
                lambda m: jelbo.negative_elbo_hybrid(m, jnp.asarray(coords), jnp.asarray(y),
                                                     jax.random.PRNGKey(0), E=E),
                lambda m, x_, y_, eps, eps2: elbo.negative_elbo_hybrid(m, x_, y_, eps, eps2),
                1e-2, draws, project=gt.clamp_nonnegative,
                jproject=gz.train.clamp_nonnegative, args=(T(coords), T(y)))
    assert float(tmodel.W_raw.detach().min()) >= 0 and float(tmodel.W2_raw.detach().min()) >= 0


def test_train_step_draws_match_each_head():
    """``make_train_step``'s draws: (E, L, n) eps, (E, n) with n_factors
    None, eps2 (E, T, n) for both hybrids, none for the exact heads."""
    from gpzoo_tpu_torch.train.loop import _draws

    rng = np.random.default_rng(0)
    coords, groups = rng.uniform(-2, 2, (N, 2)), rng.integers(0, G, N)
    draw = _draws(torch.Generator().manual_seed(0), E, L, 7)
    for head, expect in (("nsf", {"eps": (E, L, 7)}),
                         ("hybrid", {"eps": (E, L, 7), "eps2": (E, T_MF, 7)}),
                         ("legacy_hybrid", {"eps": (E, L, 7), "eps2": (E, T_MF, 7)}),
                         ("exact", {})):
        _, tmodel = build(head, "svgp", "rbf", coords, groups, 51)
        assert {k: tuple(v.shape) for k, v in draw(tmodel).items()} == expect, head
    _, tmodel, _, _ = build_gaussian("svgp", "rbf", False, 52)
    assert tuple(_draws(torch.Generator(), E, None, 7)(tmodel)["eps"].shape) == (E, 7)
    _, tmodel, _, _ = build_gaussian("svgp", "rbf", True, 53)
    assert _draws(torch.Generator(), E, None, 7)(tmodel) == {}


# --- the configurations --------------------------------------------------------

@pytest.mark.parametrize("name", ["NSFConfig", "NSFConfig_nb", "PNMFConfig",
                                  "SVGPRegressionConfig", "SVGPRegressionConfig_whitened"])
def test_configs_match_jax(name):
    """Each configuration's leaves, paths and shapes, against the JAX one's;
    NSFConfig's Z rows are rows of X (distinct where X has M rows)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, (N, 2))
    base, _, variant = name.partition("_")
    kw = {"nb": dict(likelihood="nb"), "whitened": dict(whitened=True)}.get(variant, {})
    small = {"NSFConfig": dict(D=D, N=N, L=L, M=M), "PNMFConfig": dict(D=D, N=N, L=L),
             "SVGPRegressionConfig": dict(n=N, M=M)}[base]
    jcfg, tcfg = getattr(gz, base)(**small, **kw), getattr(gt, base)(**small, **kw)
    gen = torch.Generator().manual_seed(0)
    if base == "NSFConfig":
        jmodel, tmodel = jcfg.build(jax.random.PRNGKey(0), X=jnp.asarray(x)), tcfg.build(
            gen, T(x))
        zs = tmodel.prior.Z.detach().numpy()
        assert all(any(np.array_equal(z, r) for r in x) for z in zs)
        assert len({tuple(z) for z in zs}) == M
    else:
        jmodel, tmodel = jcfg.build(jax.random.PRNGKey(0)), tcfg.build(gen, torch.float64)
    jl = jax_leaves(jmodel)
    tl = dict(tmodel.named_parameters())
    assert set(tl) == set(jl)
    for path, p in tl.items():
        assert tuple(p.shape) == jl[path].shape, path
        assert p.requires_grad, path
    assert type(tmodel).__name__ == type(jmodel).__name__


# --- host metrics ----------------------------------------------------------------

def test_spatial_metrics_match_jax():
    """dims_autocorr, morans_i (vector and scalar) and best_match_correlation
    against the JAX package's numpy copies."""
    from gpzoo_tpu.data import metrics as jm

    from gpzoo_tpu_torch.data import metrics as tm

    rng = np.random.default_rng(3)
    coords = rng.uniform(-2, 2, (200, 2))
    factors = np.stack([np.sin(coords[:, 0]), rng.standard_normal(200),
                        coords[:, 1] ** 2, np.cos(3 * coords[:, 1])], axis=1)
    for sort in (True, False):
        got, expect = tm.dims_autocorr(factors, coords, sort=sort), jm.dims_autocorr(
            factors, coords, sort=sort)
        assert np.array_equal(got[0], expect[0])
        _close(got[1], expect[1], 1e-12)
    _close(tm.morans_i(factors[:, 0], coords, n_neighs=4),
           jm.morans_i(factors[:, 0], coords, n_neighs=4), 1e-12)
    truth = rng.standard_normal((3, 50))
    fac = np.concatenate([truth[::-1] + 0.1 * rng.standard_normal((3, 50)),
                          rng.standard_normal((2, 50))])
    _close(tm.best_match_correlation(truth, fac), jm.best_match_correlation(truth, fac),
           1e-12)


# --- converters ------------------------------------------------------------------

@pytest.mark.parametrize("case", [("pnmf", None, None), ("legacy_nsf", "svgp", "rbf"),
                                  ("legacy_nsf", "vnngp", "matern32"),
                                  ("legacy_hybrid", "wsvgp", "batched"),
                                  ("hybrid", "vnngp", "rbf"), ("nsf", "svgp", "matern32"),
                                  ("gaussian", "svgp", "rbf"),
                                  ("gaussian_exact", "wsvgp", "matern32")],
                         ids=lambda c: "-".join(str(v) for v in c))
def test_converters_round_trip(data, case):
    """JAX leaves → the port's model → ``to_numpy``: the same leaves, and the
    kernel of the class asked for."""
    coords, _, groups = data
    head, prior, kernel = case
    if head.startswith("gaussian"):
        jmodel, tmodel, _, _ = build_gaussian(prior, kernel, head.endswith("exact"), 61)
    else:
        jmodel, tmodel = build(head, prior, kernel, coords, groups, 61)
    jl, tl = jax_leaves(jmodel), convert.to_numpy(tmodel)
    assert set(jl) == set(tl)
    for path in jl:
        assert np.array_equal(jl[path], tl[path]), path
    assert type(tmodel).__name__ == type(jmodel).__name__
    if kernel is not None:
        gp = tmodel.gp_prior if hasattr(tmodel, "gp_prior") else tmodel.gp
        assert type(gp.kernel).__name__ == {"rbf": "RBF", "batched": "BatchedRBF",
                                            "matern32": "Matern32"}[kernel]
