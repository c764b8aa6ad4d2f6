"""The port's north-star slice against the JAX package, on CPU in float64.

A JAX ``SlideseqNSFConfig`` model is carried over through
``gpzoo_tpu_torch.convert``; both packages then see the same idx and the
same eps (the draws of ``jax.random.normal(key, (E, L, B))`` that the JAX
loss makes from ``key``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gpzoo_tpu as gz
from gpzoo_tpu.data.metrics import poisson_deviance as jdeviance
from gpzoo_tpu.train import partition_optimizer, trainable_mask
from gpzoo_tpu.train.fast import (nsf_negative_elbo_precomputed as j_loss,
                                  precompute_nsf_projection as j_precompute)
from gpzoo_tpu.train.loop import _path_str

import gpzoo_tpu_torch as gt
from gpzoo_tpu_torch.bijectors import lower_cholesky
from gpzoo_tpu_torch.convert import nsf_from_numpy, to_numpy
from gpzoo_tpu_torch.data.metrics import held_out_deviance

N, D, L, M, B = 300, 20, 3, 40, 64
TOL = 1e-8
TRAINED = ("prior.mu", "prior.Lu_raw", "W_raw", "V_raw")


def jax_leaves(model):
    return {_path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(model)[0]}


def _close(got, expect, rtol=TOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    expect = np.asarray(expect)
    np.testing.assert_allclose(got, expect, rtol=0,
                               atol=rtol * max(np.max(np.abs(expect)), 1e-300))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    coords = rng.uniform(-2, 2, (N, 2))
    counts_t = rng.poisson(3.0, (N, D)).astype(np.float64)  # spot-major
    cfg = gz.SlideseqNSFConfig(D=D, N=N, L=L, M=M, batch_size=B)
    jmodel = cfg.build(jax.random.PRNGKey(0), jnp.asarray(coords))
    # a non-identity q(u) so the trace and logdet terms are exercised
    lu_raw = np.tril(0.2 * rng.standard_normal((L, M, M)))
    jmodel = jmodel.replace(prior=jmodel.prior.replace(Lu_raw=jnp.asarray(lu_raw)))
    tmodel = nsf_from_numpy(jax_leaves(jmodel), "cpu", torch.float64,
                            jitter=jmodel.prior.jitter,
                            var_floor=jmodel.prior.var_floor)
    return dict(cfg=cfg, coords=coords, counts_t=counts_t, jmodel=jmodel,
                tmodel=tmodel, jproj=j_precompute(jmodel, jnp.asarray(coords)),
                tproj=gt.precompute_nsf_projection(tmodel, torch.tensor(coords)))


def _batch(seed, n_train, E):
    key = jax.random.PRNGKey(seed)
    k_idx, k_eps = jax.random.split(key)
    idx = jax.random.choice(k_idx, n_train, (B,), replace=False)
    eps = jax.random.normal(k_eps, (E, L, B), dtype=jnp.float64)
    return idx, k_eps, eps


def test_projection_matches_jax(setup):
    jp, tp = setup["jproj"], setup["tproj"]
    for field in ("proj_t", "a2", "kxx", "k_inv", "logdet_lzz"):
        _close(getattr(tp, field), getattr(jp, field))
    assert tp.kxx.shape == (L, 1)


@pytest.mark.parametrize("E", [1, 2])
def test_loss_and_gradients_match_jax(setup, E):
    jmodel, tmodel = setup["jmodel"], setup["tmodel"]
    y = setup["counts_t"]
    idx, key, eps = _batch(5 + E, N, E)
    jval, jgrad = jax.value_and_grad(j_loss)(
        jmodel, setup["jproj"], jnp.asarray(y), idx, key, E=E,
        y_transposed=True)
    tmodel.zero_grad(set_to_none=True)
    tval = gt.nsf_negative_elbo_precomputed(
        tmodel, setup["tproj"], torch.tensor(y),
        torch.tensor(np.asarray(idx)), torch.tensor(np.asarray(eps)),
        y_transposed=True)
    tval.backward()
    _close(tval, jval)
    jg = jax_leaves(jgrad)
    params = dict(tmodel.named_parameters())
    for path in TRAINED:
        _close(params[path].grad, jg[path])


def test_loss_counts_gene_major_like_spot_major(setup):
    tmodel, tproj = setup["tmodel"], setup["tproj"]
    y = torch.tensor(setup["counts_t"])
    idx, _, eps = _batch(3, N, 1)
    idx, eps = torch.tensor(np.asarray(idx)), torch.tensor(np.asarray(eps))
    with torch.no_grad():
        a = gt.nsf_negative_elbo_precomputed(tmodel, tproj, y, idx, eps,
                                             y_transposed=True)
        b = gt.nsf_negative_elbo_precomputed(tmodel, tproj, y.T.contiguous(),
                                             idx, eps)
    assert float(a) == float(b)


def test_adam_trajectory_matches_optax(setup):
    """Five Adam(2e-3) steps on the same idx/eps sequence: the port's
    ``make_batched_train_step`` against optax through the JAX package's
    trainable mask."""
    cfg, y = setup["cfg"], setup["counts_t"]
    n_train = N - 30
    batches = [_batch(100 + t, n_train, cfg.E) for t in range(5)]

    jmodel, jproj = setup["jmodel"], setup["jproj"]
    opt = partition_optimizer(optax.adam(cfg.lr),
                              trainable_mask(jmodel, cfg.trainable))
    opt_state = opt.init(jmodel)

    @jax.jit
    def jstep(model, opt_state, idx, key):
        loss, grads = jax.value_and_grad(j_loss)(
            model, jproj, jnp.asarray(y), idx, key, E=cfg.E, y_transposed=True)
        updates, opt_state = opt.update(grads, opt_state, model)
        return optax.apply_updates(model, updates), opt_state, loss

    jlosses = []
    for idx, key, _ in batches:
        jmodel, opt_state, loss = jstep(jmodel, opt_state, idx, key)
        jlosses.append(float(loss))

    tmodel = nsf_from_numpy(jax_leaves(setup["jmodel"]), "cpu", torch.float64,
                            jitter=cfg.jitter)
    gt.freeze_(tmodel, cfg.trainable)
    tcfg = gt.SlideseqNSFConfig(D=D, N=N, L=L, M=M, batch_size=B)
    feed = iter(batches)

    def loss_fed(model, proj, y_, idx, eps, **kw):
        # the step's own draws are replaced by the JAX sequence
        jidx, _, jeps = next(feed)
        return gt.nsf_negative_elbo_precomputed(
            model, proj, y_, torch.tensor(np.asarray(jidx)),
            torch.tensor(np.asarray(jeps)), **kw)

    step = gt.make_batched_train_step(
        loss_fed, tcfg.optimizer(tmodel), n_train, B, L,
        torch.Generator().manual_seed(0), E=cfg.E,
        loss_kwargs={"y_transposed": True})
    tlosses = gt.run_steps(step, tmodel, (setup["tproj"], torch.tensor(y)), 5)
    np.testing.assert_allclose(tlosses.numpy(), jlosses, rtol=TOL)
    jl = jax_leaves(jmodel)
    for path, p in tmodel.named_parameters():
        _close(p, jl[path])


def test_train_step_draws(setup):
    """idx without replacement from the first n_train spots; eps (E, L, B)."""
    seen = {}

    def spy(model, proj, y, idx, eps, **kw):
        seen["idx"], seen["eps"] = idx, eps
        return gt.nsf_negative_elbo_precomputed(model, proj, y, idx, eps, **kw)

    tmodel = nsf_from_numpy(to_numpy(setup["tmodel"]), "cpu", torch.float64)
    step = gt.make_batched_train_step(
        spy, torch.optim.Adam(tmodel.parameters(), lr=2e-3), 250, B, L,
        torch.Generator().manual_seed(1), E=2,
        loss_kwargs={"y_transposed": True})
    loss = step(tmodel, setup["tproj"], torch.tensor(setup["counts_t"]))
    assert torch.isfinite(loss)
    idx = seen["idx"]
    assert idx.shape == (B,) and len(set(idx.tolist())) == B
    assert int(idx.min()) >= 0 and int(idx.max()) < 250
    assert seen["eps"].shape == (2, L, B)


def test_held_out_deviance_matches_jax(setup):
    jmodel = setup["jmodel"]
    vidx = np.arange(N - 30, N)
    y = setup["counts_t"]
    gp = jmodel.prior
    fmean = jnp.einsum("lm,bm->lb", gp.mu, setup["jproj"].proj_t[vidx])
    rate = (gz.bijectors.softplus(jmodel.V_raw[vidx])
            * (gz.bijectors.softplus(jmodel.W_raw) @ jnp.exp(fmean)))
    expect = jdeviance(jnp.asarray(y[vidx].T), rate)
    got = held_out_deviance(setup["tmodel"], setup["tproj"], torch.tensor(y),
                            torch.tensor(vidx))
    _close(got, expect)


def test_config_build_init():
    g = torch.Generator().manual_seed(0)
    x = torch.rand((50, 2), generator=g, dtype=torch.float64)
    cfg = gt.SlideseqNSFConfig(D=7, N=50, L=3, M=12, batch_size=16)
    model = cfg.build(g, x)
    lu = lower_cholesky(model.prior.Lu_raw)
    assert torch.equal(lu, torch.eye(12, dtype=torch.float64).expand(3, 12, 12))
    z = model.prior.Z.detach()
    assert all(any(torch.equal(r, xr) for xr in x) for r in z)
    assert len({tuple(r.tolist()) for r in z}) == 12
    w = model.W_raw.detach()
    assert w.shape == (7, 3) and bool((w >= 0).all() and (w < 1).all())
    assert torch.equal(model.V_raw.detach(), torch.ones(50, dtype=torch.float64))
    assert model.prior.mu.shape == (3, 12) and model.prior.jitter == 0.1
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    assert frozen == {"prior.Z", "prior.kernel.sigma", "prior.kernel.lengthscale"}
    opt = cfg.optimizer(model)
    assert sum(len(gr["params"]) for gr in opt.param_groups) == 4
    assert opt.defaults["lr"] == 2e-3


def test_trainable_rule_matches_jax():
    jcfg, tcfg = gz.SlideseqNSFConfig(), gt.SlideseqNSFConfig()
    for path in ("prior.Z", "prior.mu", "prior.Lu_raw", "prior.kernel.sigma",
                 "prior.kernel.lengthscale", "W_raw", "V_raw"):
        assert tcfg.trainable(path) == jcfg.trainable(path)


def test_unported_heads_raise(setup):
    from gpzoo_tpu_torch.models import NSF

    class WhitenedLike(torch.nn.Module):
        pass

    bad = NSF(WhitenedLike(), torch.zeros(2, 1), torch.zeros(3))
    with pytest.raises(NotImplementedError):
        gt.precompute_nsf_projection(bad, torch.zeros(3, 2))
    with pytest.raises(NotImplementedError):
        gt.nsf_negative_elbo_precomputed(bad, setup["tproj"], None, None, None)
