"""The port's other heads of the precomputed loss against the JAX package,
on CPU in float64: the negative binomial (also over a VNNGP and through
the blockwise W-form loss), the whitened and low-rank priors, the
normalized Poisson log-likelihood and the hybrid heads.

Inputs are numpy arrays from a seed, fed to both packages; JAX models are
carried over through ``gpzoo_tpu_torch.convert``. Both losses see the same
idx and the same draws: eps (and, for a hybrid, eps2) are the draws the
JAX loss makes from its key (a hybrid splits it into the GP half's key
and the mean-field half's).
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
from gpzoo_tpu import dists as jdists
from gpzoo_tpu.bijectors import init_softplus as j_init_softplus
from gpzoo_tpu.ops.linalg import (lowrank_whitened_kl as j_lowrank_kl,
                                  whitened_kl as j_whitened_kl)
from gpzoo_tpu.predict import latent_posterior as j_latent_posterior
from gpzoo_tpu.train import partition_optimizer, trainable_mask
from gpzoo_tpu.train.fast import (nsf_negative_elbo_batched as j_batched,
                                  nsf_negative_elbo_precomputed as j_loss,
                                  precompute_nsf_projection as j_precompute)
from gpzoo_tpu.train.fast_vnngp import (
    precompute_vnngp_conditioning as j_vnngp_precompute,
    vnngp_nsf_negative_elbo_batched as j_vnngp_batched,
    vnngp_nsf_negative_elbo_precomputed as j_vnngp_precomputed)
from gpzoo_tpu.train.loop import _path_str

import gpzoo_tpu_torch as gt
from gpzoo_tpu_torch import dists
from gpzoo_tpu_torch.bijectors import init_softplus
from gpzoo_tpu_torch.convert import (hybrid_from_numpy, lowrank_nsf_from_numpy,
                                     nbnsf_from_numpy, nsf_from_numpy,
                                     to_numpy, vnngp_from_numpy,
                                     wsvgp_nsf_from_numpy)
from gpzoo_tpu_torch.data.metrics import (held_out_deviance,
                                          hybrid_posterior_deviance)
from gpzoo_tpu_torch.ops.linalg import lowrank_whitened_kl, whitened_kl

N, D, L, M, B, T_MF, R = 200, 12, 3, 24, 48, 2, 5
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
    return coords, counts_t


def _draws(key, E, hybrid):
    """(eps, eps2) as the JAX precomputed loss draws them from ``key``."""
    key2 = None
    if hybrid:
        key, key2 = jax.random.split(key)
    eps = np.asarray(jax.random.normal(key, (E, L, B), dtype=jnp.float64))
    eps2 = (None if key2 is None else
            np.asarray(jax.random.normal(key2, (E, T_MF, B), dtype=jnp.float64)))
    return eps, eps2


def _batch(seed, n_train=N):
    k_idx, key = jax.random.split(jax.random.PRNGKey(seed))
    return jax.random.choice(k_idx, n_train, (B,), replace=False), key


# --- the JAX models of every head, and their ports ---------------------------

def _nsf_gp(kind, key, rng, shared=False):
    """A JAX spatial prior of ``kind`` with non-trivial q(u)."""
    kernel = gz.kernels.NSFRBF.create(L=L, sigma=1.1, lengthscale=0.9)
    lead = () if shared else (L,)
    coords = rng.uniform(-2, 2, (M, 2))
    if kind == "lowrank":
        gp = gz.gps.LowRankWSVGP.create(key, kernel, dim=2, M=M, rank=R,
                                        jitter=1e-1)
        return gp.replace(Z=jnp.asarray(coords),
                          mu=jnp.asarray(0.5 * rng.standard_normal(lead + (M,))),
                          V=jnp.asarray(0.3 * rng.standard_normal(lead + (M, R))),
                          d_raw=jnp.asarray(rng.normal(size=lead + (M,))))
    cls = gz.gps.WSVGP if kind == "wsvgp" else gz.gps.SVGP
    gp = cls.create(key, kernel, dim=2, M=M, jitter=1e-1)
    return gp.replace(Z=jnp.asarray(coords),
                      mu=jnp.asarray(0.5 * rng.standard_normal(lead + (M,))),
                      Lu_raw=jnp.asarray(np.tril(0.2 * rng.standard_normal(
                          lead + (M, M)))))


def _jmodel(case):
    """(JAX model, port model) for a named case: the head and prior kind
    are read off its name."""
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    key = jax.random.PRNGKey(3)
    kind = case.split("_")[-1] if case.split("_")[-1] in (
        "svgp", "wsvgp", "lowrank") else "svgp"
    shared = "shared" in case
    gp = _nsf_gp(kind, key, rng, shared)
    w_raw = jnp.asarray(rng.uniform(0, 1, (D, L)))
    v_raw = jnp.asarray(rng.normal(1.0, 0.2, N))
    if case.startswith(("hybrid", "exact")):
        prior2 = gz.gps.GaussianPrior(
            mean=jnp.asarray(0.3 * rng.standard_normal((T_MF, N))),
            scale_raw=jnp.asarray(rng.uniform(-1, 0.5, (T_MF, N))),
            scale_pf=0.7)
        sf = gz.models.PoissonFactorization(prior=gp, W_raw=w_raw)
        cf = gz.models.PoissonFactorization(
            prior=prior2, W_raw=jnp.asarray(rng.uniform(0, 1, (D, T_MF))))
        exact = case.startswith("exact")
        cls = gz.models.HybridNSFExact if exact else gz.models.HybridNSF
        jmodel = cls(sf=sf, cf=cf, V_raw=v_raw)
        port = hybrid_from_numpy(jax_leaves(jmodel), "cpu", torch.float64,
                                 prior=kind, exact=exact, jitter=gp.jitter,
                                 scale_pf=0.7)
        return jmodel, port
    if case.startswith("nb"):
        jmodel = gz.models.NBNSF(
            prior=gp, W_raw=w_raw, V_raw=v_raw,
            r_raw=jnp.asarray(j_init_softplus(rng.uniform(2, 20, D))))
    else:
        jmodel = gz.models.NSF(prior=gp, W_raw=w_raw, V_raw=v_raw)
    params = jax_leaves(jmodel)
    if kind == "lowrank":
        port = lowrank_nsf_from_numpy(params, "cpu", torch.float64, gp.jitter)
    elif kind == "wsvgp":
        port = wsvgp_nsf_from_numpy(params, "cpu", torch.float64, gp.jitter)
    else:
        port = nsf_from_numpy(params, "cpu", torch.float64, gp.jitter,
                              gp.var_floor)
    return jmodel, port


# --- distributions and KLs ------------------------------------------------------

def _grid():
    r, mu, x = np.meshgrid([0.3, 1.0, 4.5, 60.0], [0.0, 0.05, 1.0, 8.0, 120.0],
                           [0.0, 1.0, 7.0, 40.0], indexing="ij")
    return r, mu, x


@pytest.mark.parametrize("method", ["log_prob", "unnormalized_log_prob"])
def test_negative_binomial_matches_jax(method):
    r, mu, x = _grid()
    jd = jdists.NegativeBinomial(jnp.asarray(r), jnp.asarray(mu))
    td = dists.NegativeBinomial(T(r), T(mu))
    expect = np.asarray(getattr(jd, method)(jnp.asarray(x)))
    got = getattr(td, method)(T(x)).numpy()
    finite = np.isfinite(expect)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_allclose(got[finite], expect[finite], rtol=1e-12, atol=1e-12)
    _close(td.variance(), jd.variance(), 1e-14)
    assert td.mean is td.rate


def test_negative_binomial_zero_mean_limit():
    """P(x = 0 | μ = 0) = 1: log-prob 0, where torch.distributions'
    logits form gives NaN; a positive count at μ = 0 is −inf, not NaN."""
    nb = dists.NegativeBinomial(T([2.0, 50.0, 2.0]), T([0.0, 0.0, 0.0]))
    x = T([0.0, 0.0, 3.0])
    for lp in (nb.log_prob(x), nb.unnormalized_log_prob(x)):
        assert lp[:2].tolist() == [0.0, 0.0]
        assert not bool(torch.isnan(lp).any())


def test_negative_binomial_poisson_limit():
    mu, x = T([0.3, 2.0, 9.0]), T([0.0, 2.0, 14.0])
    nb = dists.NegativeBinomial(torch.full((3,), 1e8, dtype=torch.float64), mu)
    _close(nb.log_prob(x), dists.Poisson(mu).log_prob(x), 1e-6)


def test_poisson_log_prob_matches_jax():
    _, mu, x = _grid()
    expect = jdists.Poisson(jnp.asarray(mu)).log_prob(jnp.asarray(x))
    got = dists.Poisson(T(mu)).log_prob(T(x))
    finite = np.isfinite(np.asarray(expect))
    np.testing.assert_allclose(got.numpy()[finite], np.asarray(expect)[finite],
                               rtol=1e-12, atol=1e-12)
    gap = dists.Poisson(T(mu)).unnormalized_log_prob(T(x)) - got
    _close(gap[finite], np.asarray(jax.lax.lgamma(jnp.asarray(x) + 1.0))[finite],
           1e-14)


def test_kl_normal_normal_and_lowrank_mvn_match_jax():
    rng = np.random.default_rng(2)
    a, b, c, d = (rng.standard_normal((3, 7)) for _ in range(4))
    expect = jdists.kl_normal_normal(jdists.Normal(a, np.exp(b)),
                                     jdists.Normal(c, np.exp(d)))
    got = dists.kl_normal_normal(dists.Normal(T(a), T(np.exp(b))),
                                 dists.Normal(T(c), T(np.exp(d))))
    _close(got, expect, 1e-13)
    loc, v, diag = rng.standard_normal(6), rng.standard_normal((6, 2)), rng.uniform(0.5, 2, 6)
    jq = jdists.LowRankMultivariateNormal(loc, v, diag)
    tq = dists.LowRankMultivariateNormal(T(loc), T(v), T(diag))
    _close(tq.variance(), jq.variance(), 1e-14)
    assert tq.mean is tq.loc


@pytest.mark.parametrize("lead", [(), (3,)])
def test_whitened_kl_matches_jax(lead):
    rng = np.random.default_rng(3)
    mz = rng.standard_normal(lead + (9,))
    lz = np.tril(rng.standard_normal(lead + (9, 9)))
    idx = np.arange(9)
    lz[..., idx, idx] = np.abs(lz[..., idx, idx]) + 0.5
    _close(whitened_kl(T(mz), T(lz)), j_whitened_kl(mz, lz), 1e-12)


@pytest.mark.parametrize("mu_lead,v_lead,r", [((), (), 1), ((), (3,), 4),
                                              ((3,), (3,), 7), ((3,), (), 12)])
def test_lowrank_whitened_kl_matches_jax(mu_lead, v_lead, r):
    rng = np.random.default_rng(4)
    mz = rng.standard_normal(mu_lead + (9,))
    v = rng.standard_normal(v_lead + (9, r))
    var = rng.uniform(0.3, 2.0, v_lead + (9,))
    _close(lowrank_whitened_kl(T(mz), T(v), T(var)), j_lowrank_kl(mz, v, var), 1e-12)


# --- the precomputed projection ---------------------------------------------------

@pytest.mark.parametrize("kind", ["svgp", "wsvgp", "lowrank"])
def test_projection_matches_jax(data, kind):
    coords = data[0]
    jmodel, tmodel = _jmodel(f"nsf_{kind}")
    jp = j_precompute(jmodel, jnp.asarray(coords))
    tp = gt.precompute_nsf_projection(tmodel, T(coords))
    assert tp.whitened == jp.whitened == (kind != "svgp")
    for field in ("proj_t", "a2", "kxx", "k_inv", "logdet_lzz"):
        expect = getattr(jp, field)
        if expect is None:
            assert getattr(tp, field) is None, field
        else:
            _close(getattr(tp, field), expect)
    assert tp.kxx.shape == (L, 1)


@pytest.mark.parametrize("kind", ["svgp", "wsvgp"])
@pytest.mark.parametrize("block", [1, 37, N - 1, N, 10 * N])
def test_projection_block_matches_unblocked(data, kind, block):
    """Solving the spots in blocks bounds the working set and changes no
    value beyond rounding: each column's Gram and solves are the same
    arithmetic, though BLAS may take another code path for a block of one
    or of N − 1 columns (1e-14 relative was seen)."""
    coords = T(data[0])
    tmodel = _jmodel(f"nsf_{kind}")[1]
    whole = gt.precompute_nsf_projection(tmodel, coords)
    part = gt.precompute_nsf_projection(tmodel, coords, block=block)
    for field in ("proj_t", "a2", "kxx", "k_inv", "logdet_lzz"):
        a, b = getattr(whole, field), getattr(part, field)
        if a is None:
            assert b is None, field
        else:
            _close(b, a, 1e-13)
    assert part.proj_t.is_contiguous() and part.proj_t.shape == (N, M)


# --- the precomputed loss, every head -------------------------------------------

CASES = [
    # (case, E, unnormalized)
    ("nb_svgp", 1, True), ("nb_svgp", 2, True), ("nb_svgp", 2, False),
    ("nsf_svgp", 2, False),  # the normalized Poisson log-likelihood
    ("nsf_wsvgp", 1, True), ("nsf_wsvgp", 2, False),
    ("nsf_shared_wsvgp", 2, True),
    ("nsf_lowrank", 1, True), ("nsf_lowrank", 2, True),
    ("nsf_shared_lowrank", 1, True), ("nsf_shared_lowrank", 2, True),
    ("nb_lowrank", 2, True),
    ("hybrid_svgp", 1, True), ("hybrid_svgp", 2, True),
    ("hybrid_wsvgp", 2, True), ("hybrid_lowrank", 2, True),
    ("hybrid_svgp", 2, False),
    ("exact_svgp", 2, True), ("exact_wsvgp", 2, True), ("exact_lowrank", 1, True),
]


@pytest.mark.parametrize("case,E,unnormalized", CASES)
def test_loss_and_gradients_match_jax(data, case, E, unnormalized):
    """The loss value and the gradient of every leaf that reaches it; every
    leaf the JAX loss gives no gradient (Z, the kernel) gets none here."""
    coords, y = data
    jmodel, tmodel = _jmodel(case)
    hybrid = case.startswith("hybrid")
    exact = case.startswith("exact")
    idx, key = _batch(len(case) + E)
    jproj = j_precompute(jmodel, jnp.asarray(coords))
    jval, jgrad = jax.value_and_grad(j_loss)(
        jmodel, jproj, jnp.asarray(y), idx, key, E=E, y_transposed=True,
        unnormalized=unnormalized)
    tproj = gt.precompute_nsf_projection(tmodel, T(coords))
    eps, eps2 = _draws(key, E, hybrid)
    draws = {} if exact else {"eps": T(eps)}
    if hybrid:
        draws["eps2"] = T(eps2)
    tval = gt.nsf_negative_elbo_precomputed(
        tmodel, tproj, T(y), T(np.asarray(idx)), y_transposed=True,
        unnormalized=unnormalized, **draws)
    tval.backward()
    _close(tval, jval)
    jg = jax_leaves(jgrad)
    reached = set()
    for path, p in tmodel.named_parameters():
        if p.grad is None:
            assert not np.any(jg[path]), path
        else:
            reached.add(path)
            _close(p.grad, jg[path])
    assert {p.rsplit(".", 1)[-1] for p in reached} >= {"mu", "W_raw", "V_raw"}
    if case.startswith("nb"):
        assert "r_raw" in reached and bool(torch.any(tmodel.r_raw.grad != 0))


def test_unnormalized_gap_is_the_data_term(data):
    """The normalized and unnormalized losses differ by Σ lgamma(y + 1)
    over the batch, for NB as for Poisson."""
    coords, y = data
    for case in ("nsf_svgp", "nb_svgp"):
        tmodel = _jmodel(case)[1]
        proj = gt.precompute_nsf_projection(tmodel, T(coords))
        idx = torch.arange(B)
        eps = torch.randn((1, L, B), generator=torch.Generator().manual_seed(0),
                          dtype=torch.float64)
        with torch.no_grad():
            a, b = (gt.nsf_negative_elbo_precomputed(
                tmodel, proj, T(y), idx, eps, y_transposed=True, unnormalized=u)
                for u in (True, False))
        _close(b - a, torch.sum(torch.lgamma(T(y)[:B] + 1)), 1e-12)


def test_hybrid_draws_are_checked(data):
    coords, y = data
    hybrid, exact = _jmodel("hybrid_svgp")[1], _jmodel("exact_svgp")[1]
    proj = gt.precompute_nsf_projection(hybrid, T(coords))
    idx = torch.arange(B)
    eps = torch.zeros((1, L, B), dtype=torch.float64)
    eps2 = torch.zeros((1, T_MF, B), dtype=torch.float64)
    for model, kw in ((hybrid, {"eps": eps}), (hybrid, {"eps2": eps2}),
                      (hybrid, {"eps": eps, "eps2": eps2[:, :1]}),
                      (exact, {"eps": eps}),
                      (_jmodel("nsf_svgp")[1], {"eps": eps, "eps2": eps2})):
        with pytest.raises(ValueError):
            gt.nsf_negative_elbo_precomputed(model, proj, T(y), idx,
                                             y_transposed=True, **kw)


def test_legacy_hybrid_rejected(data):
    """The JAX package's LegacyHybridNSF (raw loadings W2_raw) is refused
    by every fast loss, as there."""
    coords, y = data
    jgp = _nsf_gp("svgp", jax.random.PRNGKey(0), np.random.default_rng(0))
    legacy = gz.models.LegacyHybridNSF.create(jax.random.PRNGKey(1), jgp, D=D,
                                              N=N, L=L, non_spatial_factors=2)
    with pytest.raises(NotImplementedError):
        j_loss(legacy, None, None, None, jax.random.PRNGKey(0))

    class LegacyLike(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.gp = _jmodel("nsf_svgp")[1].prior
            self.W_raw = torch.nn.Parameter(torch.rand(D, L, dtype=torch.float64))
            self.W2_raw = torch.nn.Parameter(torch.rand(D, 2, dtype=torch.float64))

    model = LegacyLike()
    eps = torch.zeros((1, L, B), dtype=torch.float64)
    for call in (lambda: gt.precompute_nsf_projection(model, T(coords)),
                 lambda: gt.nsf_negative_elbo_precomputed(model, None, T(y),
                                                          torch.arange(B), eps),
                 lambda: gt.nsf_negative_elbo_batched(model, T(coords), T(y),
                                                      torch.arange(B), eps),
                 lambda: gt.vnngp_nsf_negative_elbo_batched(model, T(coords), T(y),
                                                            torch.arange(B), eps)):
        with pytest.raises(NotImplementedError, match="LegacyHybridNSF"):
            call()


# --- the posteriors of the whitened priors and the deviances ------------------------

@pytest.mark.parametrize("case", ["nsf_svgp", "nsf_wsvgp", "nsf_lowrank",
                                  "nsf_shared_lowrank"])
def test_latent_posterior_matches_jax(data, case):
    """The priors' own posteriors at all spots, through kernel 3's plain
    version (Kzx) here."""
    coords = data[0]
    jmodel, tmodel = _jmodel(case)
    jmean, jscale = j_latent_posterior(jmodel.prior, jnp.asarray(coords))
    with torch.no_grad():
        mean, scale = gt.latent_posterior(tmodel.prior, T(coords), chunk_size=70)
    assert mean.shape == (L, N)
    _close(mean, jmean)
    _close(scale, jscale)
    qf, qu, pu = tmodel.prior(T(coords[:5]))
    assert pu is None or case == "nsf_svgp"
    if case.endswith("lowrank"):
        assert qu.cov_factor is tmodel.prior.V and tmodel.prior.rank == R


@pytest.mark.parametrize("case", ["nb_svgp", "nsf_wsvgp", "nsf_lowrank"])
def test_held_out_deviance_pairs_projection_with_mu(data, case):
    """held_out_deviance is unchanged for NBNSF and the whitened priors: the
    whitened projection a = Lzz⁻¹Kzx pairs with the whitened μ, so μ aᵀ is
    E[F] of the prior's own posterior at those spots."""
    from bench import _val_poisson_deviance

    coords, y = data
    jmodel, tmodel = _jmodel(case)
    vidx = np.arange(N - 30, N)
    jproj = j_precompute(jmodel, jnp.asarray(coords))
    expect = _val_poisson_deviance(jmodel, jproj, jnp.asarray(y), vidx)
    proj = gt.precompute_nsf_projection(tmodel, T(coords))
    got = held_out_deviance(tmodel, proj, T(y), T(vidx))
    _close(got, expect)
    jmean, _ = j_latent_posterior(jmodel.prior, jnp.asarray(coords[vidx]))
    _close(tmodel.prior.mu @ proj.proj_t[T(vidx)].T, jmean)


@pytest.mark.parametrize("case", ["hybrid_svgp", "hybrid_wsvgp", "exact_lowrank"])
def test_hybrid_deviance_matches_bench(data, case):
    from bench import _hybrid_val_deviance

    coords, y = data
    jmodel, tmodel = _jmodel(case)
    expect = _hybrid_val_deviance(jmodel, jnp.asarray(coords),
                                  jnp.asarray(y), N - 30, N, y_transposed=True)
    got = hybrid_posterior_deviance(tmodel, T(coords), T(y), T(np.arange(N - 30, N)))
    _close(got, expect)


# --- NB over a VNNGP, both tiers, and through the blockwise W-form loss -------------

@pytest.fixture(scope="module")
def nb_vnngp(data):
    coords = data[0]
    cfg = gz.VNNGPConfig(D=D, N=N, L=L, M=M, K=4)
    base = cfg.build(jax.random.PRNGKey(5), X=jnp.asarray(coords))
    rng = np.random.default_rng(11)
    gp = base.prior.replace(
        mu=jnp.asarray(0.3 * rng.standard_normal((L, M))),
        Lu_raw=jnp.asarray(0.2 * rng.standard_normal((L, M, M))))
    return gz.models.NBNSF(prior=gp, W_raw=base.W_raw, V_raw=base.V_raw,
                           r_raw=jnp.asarray(j_init_softplus(rng.uniform(2, 20, D))))


def _port_vnngp(jmodel):
    gp = jmodel.prior
    return vnngp_from_numpy(jax_leaves(jmodel), "cpu", torch.float64, K=gp.K,
                            jitter=gp.jitter, var_floor=gp.var_floor)


@pytest.mark.parametrize("shared_kernel,unnormalized", [(False, True), (True, True),
                                                        (True, False)])
def test_nb_vnngp_all_trainable_matches_jax(data, nb_vnngp, shared_kernel,
                                            unnormalized):
    coords, y = data
    idx, key = _batch(40)
    jval, jgrad = jax.value_and_grad(functools.partial(
        j_vnngp_batched, E=2, shared_kernel=shared_kernel, y_transposed=True,
        unnormalized=unnormalized))(nb_vnngp, jnp.asarray(coords),
                                    jnp.asarray(y), idx, key)
    tmodel = _port_vnngp(nb_vnngp)
    assert type(tmodel) is gt.NBNSF
    eps, _ = _draws(key, 2, False)
    tval = gt.vnngp_nsf_negative_elbo_batched(
        tmodel, T(coords), T(y), T(np.asarray(idx)), T(eps),
        shared_kernel=shared_kernel, y_transposed=True, unnormalized=unnormalized)
    tval.backward()
    _close(tval, jval)
    jg = jax_leaves(jgrad)
    for path, p in tmodel.named_parameters():
        _close(p.grad, jg[path])


@pytest.mark.parametrize("unnormalized", [True, False])
def test_nb_vnngp_frozen_tier_matches_jax(data, nb_vnngp, unnormalized):
    coords, y = data
    idx, key = _batch(41)
    jcond = j_vnngp_precompute(nb_vnngp, jnp.asarray(coords))
    jval, jgrad = jax.value_and_grad(functools.partial(
        j_vnngp_precomputed, E=1, y_transposed=True, unnormalized=unnormalized))(
        nb_vnngp, jcond, jnp.asarray(y), idx, key)
    tmodel = _port_vnngp(nb_vnngp)
    cond = gt.precompute_vnngp_conditioning(tmodel, T(coords))
    eps, _ = _draws(key, 1, False)
    tval = gt.vnngp_nsf_negative_elbo_precomputed(
        tmodel, cond, T(y), T(np.asarray(idx)), T(eps), y_transposed=True,
        unnormalized=unnormalized)
    tval.backward()
    _close(tval, jval)
    jg = jax_leaves(jgrad)
    for path in ("prior.mu", "prior.Lu_raw", "W_raw", "V_raw", "r_raw"):
        _close(dict(tmodel.named_parameters())[path].grad, jg[path])


@pytest.mark.parametrize("unnormalized", [True, False])
def test_nb_blockwise_w_form_matches_jax(data, unnormalized):
    """NBNSF over an SVGP with per-factor kernels through the blockwise
    W-form loss, two chunks; every leaf trains, Z and the kernel included."""
    coords, y = data
    rng = np.random.default_rng(13)
    cfg = gz.SlideseqNSFConfig(D=D, N=N, L=L, M=M, likelihood="nb")
    jmodel = cfg.build(jax.random.PRNGKey(0), jnp.asarray(coords))
    kernel = jmodel.prior.kernel.replace(
        sigma=jnp.asarray(rng.uniform(0.8, 1.3, (L, 1, 1))),
        lengthscale=jnp.asarray(rng.uniform(0.8, 1.5, (L, 1, 1))))
    jmodel = jmodel.replace(
        prior=jmodel.prior.replace(
            kernel=kernel, Lu_raw=jnp.asarray(0.2 * rng.standard_normal((L, M, M)))),
        r_raw=jnp.asarray(j_init_softplus(rng.uniform(2, 20, D))))
    idx, key = _batch(42)
    jval, jgrad = jax.value_and_grad(functools.partial(
        j_batched, E=2, microbatch=B // 2, factored=True, y_transposed=True,
        unnormalized=unnormalized))(jmodel, jnp.asarray(coords), jnp.asarray(y),
                                    idx, key)
    tmodel = nbnsf_from_numpy(jax_leaves(jmodel), "cpu", torch.float64,
                              jitter=jmodel.prior.jitter,
                              var_floor=jmodel.prior.var_floor)
    eps, _ = _draws(key, 2, False)
    tval = gt.nsf_negative_elbo_batched(
        tmodel, T(coords), T(y), T(np.asarray(idx)), T(eps), E=2,
        microbatch=B // 2, factored=True, y_transposed=True,
        unnormalized=unnormalized)
    tval.backward()
    _close(tval, jval)
    jg = jax_leaves(jgrad)
    for path, p in tmodel.named_parameters():
        _close(p.grad, jg[path])


def test_blockwise_still_refuses_whitened_and_hybrid_heads(data):
    """The blockwise loss refuses the low-rank prior, as the JAX one does;
    the whitened and hybrid heads, once refused, now run and are held
    against the JAX loss (the value and every leaf's gradient)."""
    coords, y = data
    with pytest.raises(NotImplementedError):
        gt.nsf_negative_elbo_batched(_jmodel("nsf_lowrank")[1], T(coords), T(y),
                                     torch.arange(B),
                                     torch.zeros((1, L, B), dtype=torch.float64),
                                     factored=True, y_transposed=True)
    for case in ("nsf_wsvgp", "hybrid_svgp"):
        jmodel, tmodel = _jmodel(case)
        idx, key = _batch(21)
        jval, jgrad = jax.value_and_grad(functools.partial(
            j_batched, E=2, microbatch=B // 2, factored=True, y_transposed=True))(
                jmodel, jnp.asarray(coords), jnp.asarray(y), idx, key)
        eps, eps2 = _draws(key, 2, case.startswith("hybrid"))
        tval = gt.nsf_negative_elbo_batched(
            tmodel, T(coords), T(y), T(np.asarray(idx)), T(eps),
            None if eps2 is None else T(eps2), E=2, microbatch=B // 2,
            factored=True, y_transposed=True)
        tval.backward()
        _close(tval, jval)
        jg = jax_leaves(jgrad)
        for path, p in tmodel.named_parameters():
            _close(p.grad, jg[path])


# --- the configuration, the training step and the converters ------------------------

@pytest.mark.parametrize("rank,likelihood", [(0, "nb"), (4, "poisson"), (4, "nb")])
def test_config_build_matches_jax_structure(rank, likelihood):
    x = torch.rand((60, 2), generator=torch.Generator().manual_seed(0),
                   dtype=torch.float64)
    kw = dict(D=7, N=60, L=3, M=12, batch_size=16, rank=rank, likelihood=likelihood)
    model = gt.SlideseqNSFConfig(**kw).build(torch.Generator().manual_seed(1), x)
    jmodel = gz.SlideseqNSFConfig(**kw).build(jax.random.PRNGKey(0), jnp.asarray(x.numpy()))
    jl = jax_leaves(jmodel)
    params = dict(model.named_parameters())
    assert set(params) == set(jl)
    for path, p in params.items():
        assert p.shape == jl[path].shape and p.dtype == torch.float64, path
        assert p.requires_grad == gz.SlideseqNSFConfig(**kw).trainable(path), path
    if likelihood == "nb":
        _close(model.r_raw, jl["r_raw"], 1e-15)
        _close(init_softplus(np.full(3, 10.0)), j_init_softplus(np.full(3, 10.0)), 0)
    if rank:
        _close(model.prior.d_raw, jl["prior.d_raw"], 1e-15)
        assert 0 < float(model.prior.V.detach().abs().max()) < 0.1
    with pytest.raises(ValueError):
        gt.SlideseqNSFConfig(**dict(kw, likelihood="gamma")).build(
            torch.Generator(), x)


def test_train_step_draws_per_head(data):
    """A HybridNSF step gets eps (E, L, B) and eps2 (E, T, B) from the one
    generator, in that order after idx; HybridNSFExact gets no draws."""
    coords, y = data
    seen = {}

    def spy(model, proj, y_, idx, **kw):
        seen.update(kw, idx=idx)
        return gt.nsf_negative_elbo_precomputed(model, proj, y_, idx, **kw)

    for case in ("hybrid_svgp", "exact_svgp"):
        seen.clear()
        model = _jmodel(case)[1]
        proj = gt.precompute_nsf_projection(model, T(coords))
        gen = torch.Generator().manual_seed(4)
        step = gt.make_batched_train_step(
            spy, torch.optim.Adam(model.parameters(), lr=1e-3), N - 30, B, L,
            gen, E=2, loss_kwargs={"y_transposed": True})
        assert torch.isfinite(step(model, proj, T(y)))
        ref = torch.Generator().manual_seed(4)
        idx = torch.randperm(N - 30, generator=ref)[:B]
        assert torch.equal(seen["idx"], idx)
        if case == "exact_svgp":
            assert set(seen) == {"idx", "y_transposed"}
            continue
        eps = torch.randn((2, L, B), generator=ref, dtype=torch.float64)
        eps2 = torch.randn((2, T_MF, B), generator=ref, dtype=torch.float64)
        assert torch.equal(seen["eps"], eps) and torch.equal(seen["eps2"], eps2)


@pytest.mark.parametrize("rank,likelihood", [(0, "nb"), (64, "poisson")])
def test_adam_trajectory_matches_optax(data, rank, likelihood):
    """Five Adam(2e-3) steps of the NB and rank-64 configurations at reduced
    width on the same idx/eps sequence: the port's step against optax
    through the JAX package's trainable mask."""
    coords, y = data
    m = 70 if rank else M
    kw = dict(D=D, N=N, L=L, M=m, batch_size=B, rank=rank, likelihood=likelihood)
    cfg = gz.SlideseqNSFConfig(**kw)
    jmodel = cfg.build(jax.random.PRNGKey(2), jnp.asarray(coords))
    if not rank:  # a non-identity q(u)
        jmodel = jmodel.replace(prior=jmodel.prior.replace(Lu_raw=jnp.asarray(
            np.tril(0.1 * np.random.default_rng(6).standard_normal((L, m, m))))))
    jproj = j_precompute(jmodel, jnp.asarray(coords))
    n_train = N - 30
    batches = [_batch(200 + t, n_train) for t in range(5)]
    opt = partition_optimizer(optax.adam(cfg.lr), trainable_mask(jmodel, cfg.trainable))
    opt_state = opt.init(jmodel)

    @jax.jit
    def jstep(model, opt_state, idx, key):
        loss, grads = jax.value_and_grad(j_loss)(
            model, jproj, jnp.asarray(y), idx, key, E=1, y_transposed=True)
        updates, opt_state = opt.update(grads, opt_state, model)
        return optax.apply_updates(model, updates), opt_state, loss

    start = jax_leaves(jmodel)
    jlosses = []
    for idx, key in batches:
        jmodel, opt_state, loss = jstep(jmodel, opt_state, idx, key)
        jlosses.append(float(loss))

    from_numpy = lowrank_nsf_from_numpy if rank else nbnsf_from_numpy
    tmodel = from_numpy(start, "cpu", torch.float64, jitter=cfg.jitter)
    tcfg = gt.SlideseqNSFConfig(**kw)
    gt.freeze_(tmodel, tcfg.trainable)
    feed = iter(batches)

    def loss_fed(model, proj, y_, idx, eps, **kw):
        # the step's own draws are replaced by the JAX sequence
        jidx, key = next(feed)
        return gt.nsf_negative_elbo_precomputed(
            model, proj, y_, T(np.asarray(jidx)), T(_draws(key, 1, False)[0]), **kw)

    proj = gt.precompute_nsf_projection(tmodel, T(coords))
    step = gt.make_batched_train_step(
        loss_fed, tcfg.optimizer(tmodel), n_train, B, L,
        torch.Generator().manual_seed(0), E=1, loss_kwargs={"y_transposed": True})
    tlosses = gt.run_steps(step, tmodel, (proj, T(y)), 5)
    np.testing.assert_allclose(tlosses.numpy(), jlosses, rtol=TOL)
    jl = jax_leaves(jmodel)
    for path, p in tmodel.named_parameters():
        _close(p, jl[path])


@pytest.mark.parametrize("case", ["nb_svgp", "nsf_wsvgp", "nsf_lowrank",
                                  "nb_lowrank", "hybrid_svgp", "exact_wsvgp",
                                  "hybrid_lowrank"])
def test_converters_round_trip(case):
    jmodel, tmodel = _jmodel(case)
    params = jax_leaves(jmodel)
    back = to_numpy(tmodel)
    assert set(back) == set(params)
    for path, value in params.items():
        assert back[path].dtype == np.float64
        np.testing.assert_array_equal(back[path], value)
    head = tmodel.sf if case.startswith(("hybrid", "exact")) else tmodel
    assert head.prior.jitter == 0.1
    if case.startswith(("hybrid", "exact")):
        assert tmodel.cf.prior.scale_pf == 0.7
        assert isinstance(tmodel, gt.HybridNSFExact) == case.startswith("exact")
        assert tmodel.gp_prior is tmodel.sf.prior


def test_nbnsf_converter_requires_r_raw():
    params = to_numpy(_jmodel("nsf_svgp")[1])
    with pytest.raises(KeyError):
        nbnsf_from_numpy(params, "cpu", torch.float64)
