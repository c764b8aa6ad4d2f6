"""The port's natural-gradient VI (``gpzoo_tpu_torch.train.ngd``) against
the JAX package's ``train/ngd.py``, on CPU in float64.

A JAX ``SlideseqNSFConfig`` model (Poisson or NB, with a non-identity q(u)
factor) is carried over through ``gpzoo_tpu_torch.convert``. The port's
step core (``ngd_step``) is fed the minibatch and draws the JAX step makes
from its key: ``split(key, 3)`` into the next key, the index key and the
sample key, ``choice`` without replacement, then ``normal`` (E, L, B).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gpzoo_tpu as gz
from gpzoo_tpu.bijectors import lower_cholesky as j_lower_cholesky
from gpzoo_tpu.ops.linalg import tril_logdet as j_tril_logdet
from gpzoo_tpu.train.fast import (nsf_negative_elbo_precomputed as j_loss,
                                  precompute_nsf_projection as j_precompute)
from gpzoo_tpu.train.loop import _path_str
from gpzoo_tpu.train.ngd import (_ngd_negative_elbo_nologdet as j_nologdet,
                                 make_ngd_train_step as j_make_step,
                                 natural_update as j_natural_update,
                                 natural_update_guarded as j_guarded,
                                 ngd_create as j_create,
                                 ngd_to_model as j_to_model)

import gpzoo_tpu_torch as gt
from gpzoo_tpu_torch.bijectors import lower_cholesky
from gpzoo_tpu_torch.convert import ngd_state_from_numpy, nsf_from_numpy
from gpzoo_tpu_torch.ops.linalg import tril_logdet
from gpzoo_tpu_torch.train.ngd import (HeadAdam, _ngd_negative_elbo_nologdet,
                                       make_ngd_train_step, natural_update,
                                       natural_update_guarded, ngd_create,
                                       ngd_step, ngd_to_model)

N, D, L, M, B = 200, 20, 3, 16, 64
TOL = 1e-8
NAT_LR, RAMP = 0.05, 10
T = torch.tensor


def jax_leaves(model):
    return {_path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(model)[0]}


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, expect, rtol=TOL):
    got, expect = _np(got), np.asarray(expect)
    np.testing.assert_allclose(got, expect, rtol=0,
                               atol=rtol * max(np.max(np.abs(expect)), 1e-300))


def _jax_model(likelihood, seed=0):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-2, 2, (N, 2))
    counts = rng.poisson(3.0, (D, N)).astype(np.float64)  # gene-major
    cfg = gz.SlideseqNSFConfig(D=D, N=N, L=L, M=M, batch_size=B,
                               likelihood=likelihood)
    jmodel = cfg.build(jax.random.PRNGKey(3), jnp.asarray(coords))
    lu_raw = np.tril(0.2 * rng.standard_normal((L, M, M)))
    jmodel = jmodel.replace(prior=jmodel.prior.replace(Lu_raw=jnp.asarray(lu_raw)))
    return coords, counts, jmodel


@pytest.fixture(scope="module", params=["poisson", "nb"])
def setup(request):
    coords, counts, jmodel = _jax_model(request.param)
    tmodel = nsf_from_numpy(jax_leaves(jmodel), "cpu", torch.float64,
                            jitter=jmodel.prior.jitter,
                            var_floor=jmodel.prior.var_floor)
    return dict(likelihood=request.param, coords=coords, counts=counts,
                jmodel=jmodel, tmodel=tmodel,
                jproj=j_precompute(jmodel, jnp.asarray(coords)),
                tproj=gt.precompute_nsf_projection(tmodel, T(coords)))


def _jax_draws(key, E=1):
    """The JAX step's draws from its state key: (next key, idx, eps)."""
    next_key, k_idx, k_sample = jax.random.split(key, 3)
    idx = jax.random.choice(k_idx, N, shape=(B,), replace=False)
    eps = jax.random.normal(k_sample, (E, L, B), dtype=jnp.float64)
    return next_key, np.asarray(idx), np.asarray(eps)


def _port_state(jstate, lr):
    return ngd_state_from_numpy(
        jax_leaves(jstate.model), np.asarray(jstate.prec),
        np.asarray(jstate.prec_chol), HeadAdam(lr), torch.Generator(), "cpu",
        torch.float64, jitter=jstate.model.prior.jitter,
        var_floor=jstate.model.prior.var_floor, step=int(jstate.step))


def test_natural_update_conjugate_exact():
    """Gaussian likelihood y = Au + ε: one ρ = 1 natural step from an
    arbitrary PD start is the exact posterior S* = (K⁻¹ + AᵀA/σ²)⁻¹,
    m* = S*Aᵀy/σ², and the JAX step's result."""
    rng = np.random.default_rng(0)
    m_dim, n_obs, sigma2 = 6, 9, 0.3
    a = rng.normal(size=(n_obs, m_dim))
    y = rng.normal(size=(n_obs,))
    k = rng.normal(size=(m_dim, m_dim))
    k = k @ k.T + m_dim * np.eye(m_dim)
    k_inv = np.linalg.inv(k)
    m0 = rng.normal(size=(m_dim,))
    ls = rng.normal(size=(m_dim, m_dim))
    s0 = ls @ ls.T + np.eye(m_dim)
    p0 = np.linalg.inv(s0)

    def neg_elbo(m, s, xp):
        slogdet = torch.linalg.slogdet if xp is torch else jnp.linalg.slogdet
        at, yt, kt, ki = (xp.asarray(v) if xp is jnp else T(v) for v in (a, y, k, k_inv))
        fit = 0.5 / sigma2 * (xp.sum(xp.square(yt - at @ m)) + xp.trace(at.T @ at @ s))
        kl = 0.5 * (xp.trace(ki @ s) + m @ ki @ m - m_dim - slogdet(s)[1]
                    + slogdet(kt)[1])
        return fit + kl

    m_t = T(m0).requires_grad_(True)
    s_t = T(s0).requires_grad_(True)
    g_m, g_s = torch.autograd.grad(neg_elbo(m_t, s_t, torch), [m_t, s_t])
    m1, p1, _ = natural_update(T(m0)[None], T(p0)[None], g_m[None], g_s[None], 1.0)

    p_star = k_inv + a.T @ a / sigma2
    m_star = np.linalg.solve(p_star, a.T @ y / sigma2)
    np.testing.assert_allclose(_np(p1[0]), p_star, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(_np(m1[0]), m_star, rtol=1e-9, atol=1e-9)

    jg_m, jg_s = jax.grad(lambda m, s: neg_elbo(m, s, jnp), argnums=(0, 1))(
        jnp.asarray(m0), jnp.asarray(s0))
    jm1, jp1, jc1 = j_natural_update(jnp.asarray(m0)[None], jnp.asarray(p0)[None],
                                     jg_m[None], jg_s[None], 1.0)
    _, _, c1 = natural_update(T(m0)[None], T(p0)[None], g_m[None], g_s[None], 1.0)
    for got, expect in ((m1, jm1), (p1, jp1), (c1, jc1)):
        np.testing.assert_allclose(_np(got), np.asarray(expect), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("E", [1, 2])
def test_elbo_with_logdet_is_the_precomputed_loss(setup, E):
    """The (m, S) ELBO at S = LuLuᵀ plus its −½log|S| term equals the
    precomputed loss (the port's and JAX's), and the port's (m, S) ELBO
    equals JAX's, for the Poisson and the NB head."""
    jmodel, tmodel = setup["jmodel"], setup["tmodel"]
    y = setup["counts"]
    _, idx, eps = _jax_draws(jax.random.PRNGKey(5), E)
    key = jax.random.split(jax.random.PRNGKey(5), 3)[2]
    lu = lower_cholesky(tmodel.prior.Lu_raw.detach())
    s = lu @ lu.mT
    with torch.no_grad():
        val = _ngd_negative_elbo_nologdet(tmodel, s, setup["tproj"], T(y), T(idx),
                                          T(eps))
        ref = gt.nsf_negative_elbo_precomputed(tmodel, setup["tproj"], T(y),
                                               T(idx), T(eps))
    full = val - torch.sum(tril_logdet(lu))
    assert float(full) == pytest.approx(float(ref), rel=1e-9)

    jlu = j_lower_cholesky(jmodel.prior.Lu_raw)
    js = jnp.einsum("lmk,lnk->lmn", jlu, jlu)
    jval = j_nologdet(jmodel, js, setup["jproj"], jnp.asarray(y), jnp.asarray(idx),
                      key, E)
    assert float(val) == pytest.approx(float(jval), rel=1e-9)
    jref = j_loss(jmodel, setup["jproj"], jnp.asarray(y), jnp.asarray(idx), key, E=E)
    assert float(full) == pytest.approx(float(jref), rel=1e-9)
    assert float(jval - jnp.sum(j_tril_logdet(jlu))) == pytest.approx(float(jref),
                                                                      rel=1e-9)


def _pd_case():
    """Natural-update inputs whose factor 1 leaves the PD cone: its
    S-gradient is −(λ_max(P) + 1)/(2ρ)·I, so P′ = P − (λ_max + 1)I."""
    rng = np.random.default_rng(7)
    m_dim, rho = 8, 0.5
    ls = rng.normal(size=(L, m_dim, m_dim))
    prec = ls @ np.swapaxes(ls, -1, -2) + m_dim * np.eye(m_dim)
    chol = np.linalg.cholesky(prec)
    m = rng.normal(size=(L, m_dim))
    g_m = rng.normal(size=(L, m_dim))
    g_s = 0.01 * rng.normal(size=(L, m_dim, m_dim))
    g_s[1] = -(np.linalg.eigvalsh(prec[1]).max() + 1.0) / (2 * rho) * np.eye(m_dim)
    return m, prec, chol, g_m, g_s, rho


def test_guard_rejects_a_factor_off_the_pd_cone():
    """Factor 1's P′ is indefinite: ``cholesky_ex`` returns a finite partial
    factor for it (the trap), the guard rejects it all the same, keeps its
    (m, P, chol P), moves the others, and matches JAX's guard."""
    m, prec, chol, g_m, g_s, rho = _pd_case()
    p_new = prec + 2 * rho * 0.5 * (g_s + np.swapaxes(g_s, -1, -2))
    partial, info = torch.linalg.cholesky_ex(T(p_new))
    assert info.tolist()[1] > 0 and bool(torch.isfinite(partial).all())

    args = [T(v) for v in (m, prec, chol, g_m, g_s)]
    m1, p1, c1, n_bad = natural_update_guarded(*args, rho)
    assert int(n_bad) == 1
    for got, old in ((m1, m), (p1, prec), (c1, chol)):
        np.testing.assert_array_equal(_np(got)[1], old[1])
        assert not np.array_equal(_np(got)[0], old[0])
    jm1, jp1, jc1, jn = j_guarded(*(jnp.asarray(v) for v in (m, prec, chol, g_m, g_s)),
                                  rho)
    assert int(jn) == 1
    for got, expect in ((m1, jm1), (p1, jp1), (c1, jc1)):
        _close(got, expect, 1e-12)


def _jax_state(jmodel, lr=1e-2):
    return j_create(jmodel, optax.adam(lr), jax.random.PRNGKey(1))


def test_max_f_rejects_every_factor(setup):
    """With max_f below the mean function's size every factor's natural
    update is rejected (μ, P, chol P bit-unchanged) while the head still
    trains and the loss is finite, as in JAX; at the default the same
    step moves μ."""
    jstate, jopt = _jax_state(setup["jmodel"])
    _, idx, eps = _jax_draws(jstate.key)
    args = (setup["tproj"], T(setup["counts"]), T(idx), T(eps), NAT_LR, RAMP)
    tstate = _port_state(jstate, 1e-2)
    mu0, prec0, chol0 = (t.detach().clone() for t in
                         (tstate.model.prior.mu, tstate.prec, tstate.prec_chol))
    w0 = tstate.model.W_raw.detach().clone()
    loss, rejected = ngd_step(tstate, HeadAdam(1e-2), *args, max_f=1e-9)
    assert torch.isfinite(loss) and int(rejected) == L
    torch.testing.assert_close(tstate.model.prior.mu.detach(), mu0, rtol=0, atol=0)
    torch.testing.assert_close(tstate.prec, prec0, rtol=0, atol=0)
    torch.testing.assert_close(tstate.prec_chol, chol0, rtol=0, atol=0)
    assert not torch.equal(tstate.model.W_raw.detach(), w0)

    j_tiny = j_make_step(jopt, num_points=N, batch_size=B, nat_lr=NAT_LR,
                         ramp_steps=RAMP, static_kwargs={"E": 1}, max_f=1e-9)
    js, jl = j_tiny(jstate, setup["jproj"], jnp.asarray(setup["counts"]))
    assert float(loss) == pytest.approx(float(jl), rel=1e-10)
    _close(tstate.model.W_raw, js.model.W_raw)

    tdef = _port_state(jstate, 1e-2)
    ngd_step(tdef, HeadAdam(1e-2), *args)
    assert not torch.equal(tdef.model.prior.mu.detach(), mu0)


def test_five_step_trajectory_matches_jax(setup):
    """Five NGD + Adam steps (ρ 0.05 ramped over 10 steps) on JAX's draws:
    the losses, μ, P, chol P and every head leaf within 1e-8 of JAX."""
    jstate, jopt = _jax_state(setup["jmodel"])
    jstep = j_make_step(jopt, num_points=N, batch_size=B, nat_lr=NAT_LR,
                        ramp_steps=RAMP, static_kwargs={"E": 1})
    tstate = _port_state(jstate, 1e-2)
    y = jnp.asarray(setup["counts"])
    for _ in range(5):
        _, idx, eps = _jax_draws(jstate.key)
        jstate, jl = jstep(jstate, setup["jproj"], y)
        tl, _ = ngd_step(tstate, HeadAdam(1e-2), setup["tproj"], T(setup["counts"]),
                         T(idx), T(eps), NAT_LR, RAMP)
        assert float(tl) == pytest.approx(float(jl), rel=TOL)
    assert tstate.step == int(jstate.step) == 5
    _close(tstate.prec, jstate.prec)
    _close(tstate.prec_chol, jstate.prec_chol)
    jl_leaves = jax_leaves(jstate.model)
    for path, p in tstate.model.named_parameters():
        _close(p, jl_leaves[path])
    assert int(tstate.opt_state["count"]) == 5


def test_step_draws_then_runs_the_core(setup):
    """``make_ngd_train_step`` draws idx then eps from the state's generator
    and runs ``ngd_step`` on them: bit-identical to the core fed the same
    draws, and the generator ends where those draws leave it."""
    jstate, _ = _jax_state(setup["jmodel"])
    a, b = _port_state(jstate, 1e-2), _port_state(jstate, 1e-2)
    a.generator.manual_seed(11)
    b.generator.manual_seed(11)
    step = make_ngd_train_step(HeadAdam(1e-2), N, B, NAT_LR, RAMP)
    y = T(setup["counts"])
    la = step(a, setup["tproj"], y)
    idx = torch.randperm(N, generator=b.generator)[:B]
    eps = torch.randn((1, L, B), generator=b.generator, dtype=torch.float64)
    lb, _ = ngd_step(b, HeadAdam(1e-2), setup["tproj"], y, idx, eps, NAT_LR, RAMP)
    assert float(la) == float(lb) and a.step == b.step == 1
    assert torch.equal(a.prec_chol, b.prec_chol)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert int(step.rejected) >= 0


def test_poisoned_step_skips_everything(setup):
    """A non-finite loss (infinite counts) leaves the model, the Adam
    moments and count, P and chol P bit-unchanged; only the step count and
    the generator advance, and the next clean step is finite."""
    jstate, _ = _jax_state(setup["jmodel"])
    state = _port_state(jstate, 1e-3)
    step = make_ngd_train_step(HeadAdam(1e-3), N, B, NAT_LR, RAMP)
    y = T(setup["counts"])
    step(state, setup["tproj"], y)  # a clean step first: moments not zero
    before = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    prec, chol = state.prec.clone(), state.prec_chol.clone()
    moments = {m: {k: v.clone() for k, v in state.opt_state[m].items()}
               for m in ("mu", "nu")}
    count, gen = state.opt_state["count"].clone(), state.generator.get_state()
    loss = step(state, setup["tproj"], torch.full_like(y, torch.inf))
    assert not torch.isfinite(loss)
    assert state.step == 2
    assert not torch.equal(state.generator.get_state(), gen)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert torch.equal(state.prec, prec) and torch.equal(state.prec_chol, chol)
    assert torch.equal(state.opt_state["count"], count)
    for m in ("mu", "nu"):
        for k, v in state.opt_state[m].items():
            assert torch.equal(v, moments[m][k]), (m, k)
    assert torch.isfinite(step(state, setup["tproj"], y))


def test_refusals():
    """Hybrid heads, mean-field and low-rank priors and a shared (non
    per-factor) q(u) are refused, as by JAX's ngd_create."""
    gen = torch.Generator().manual_seed(0)
    hybrid = gt.HybridNSFConfig(D=8, N=200, L=2, T=2, M_grid=4).build(gen)
    with pytest.raises(ValueError, match="Hybrid"):
        ngd_create(hybrid, HeadAdam(1e-3), gen)
    pnmf = gt.PNMFConfig(D=8, N=200, L=2).build(gen)
    with pytest.raises(ValueError):
        ngd_create(pnmf, HeadAdam(1e-3), gen)
    x = torch.rand((60, 2), generator=gen, dtype=torch.float64)
    lowrank = gt.SlideseqNSFConfig(D=5, N=60, L=2, M=8, rank=3).build(gen, x)
    with pytest.raises(ValueError):
        ngd_create(lowrank, HeadAdam(1e-3), gen)
    shared = gt.SlideseqNSFConfig(D=5, N=60, L=2, M=8).build(gen, x)
    shared.prior.mu = torch.nn.Parameter(shared.prior.mu.detach()[0])
    with pytest.raises(ValueError, match="per-factor"):
        ngd_create(shared, HeadAdam(1e-3), gen)
    with pytest.raises(NotImplementedError):
        make_ngd_train_step(HeadAdam(1e-3), 60, 16, 0.01, mesh=object())


def test_ngd_to_model(setup):
    """After five steps the written-back Lu gives S with S·P = I, its
    Lu_raw equals JAX's, and the precomputed loss of the written-back model
    equals the NGD loss on the same draws."""
    jstate, jopt = _jax_state(setup["jmodel"])
    jstep = j_make_step(jopt, num_points=N, batch_size=B, nat_lr=NAT_LR,
                        ramp_steps=RAMP, static_kwargs={"E": 1})
    tstate = _port_state(jstate, 1e-2)
    y = jnp.asarray(setup["counts"])
    for _ in range(5):
        _, idx, eps = _jax_draws(jstate.key)
        jstate, _ = jstep(jstate, setup["jproj"], y)
        ngd_step(tstate, HeadAdam(1e-2), setup["tproj"], T(setup["counts"]),
                 T(idx), T(eps), NAT_LR, RAMP)
    model = ngd_to_model(tstate)
    assert model is tstate.model
    lu = lower_cholesky(model.prior.Lu_raw.detach())
    s = lu @ lu.mT
    np.testing.assert_allclose(_np(s @ tstate.prec), np.broadcast_to(np.eye(M), (L, M, M)),
                               atol=1e-7)
    _close(model.prior.Lu_raw, j_to_model(jstate).prior.Lu_raw)
    _, idx, eps = _jax_draws(jax.random.PRNGKey(5), 2)
    with torch.no_grad():
        val = _ngd_negative_elbo_nologdet(model, s, setup["tproj"], T(setup["counts"]),
                                          T(idx), T(eps)) - torch.sum(tril_logdet(lu))
        ref = gt.nsf_negative_elbo_precomputed(model, setup["tproj"], T(setup["counts"]),
                                               T(idx), T(eps))
    assert float(val) == pytest.approx(float(ref), rel=1e-8)


def test_ngd_state_from_numpy_round_trip(setup):
    """The converter carries a JAX NGD state's model, P, chol P and step
    count exactly; the head's Adam starts from zeros."""
    jstate, _ = _jax_state(setup["jmodel"])
    tstate = _port_state(jstate, 1e-2)
    np.testing.assert_array_equal(_np(tstate.prec), np.asarray(jstate.prec))
    np.testing.assert_array_equal(_np(tstate.prec_chol), np.asarray(jstate.prec_chol))
    head = set(tstate.opt_state["mu"])
    assert head == ({"W_raw", "V_raw", "r_raw"} if setup["likelihood"] == "nb"
                    else {"W_raw", "V_raw"})
    assert all(not v.any() for v in tstate.opt_state["nu"].values())
