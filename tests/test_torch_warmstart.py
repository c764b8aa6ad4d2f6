"""The port's PNMF warm start of the Hybrid-MGGP model against gpzoo_tpu,
in float64 on the CPU: the same trained-PNMF leaves, the port's inducing
subset fed to JAX (``jax.random.choice`` patched to return it), then the
Moran ranking, every leaf of the assembled hybrid (the group embedding
through its squared distances: an MDS basis is not unique) and the
fine-tune loss with its gradients. Last, the whole pipeline of
``examples/slideseq_mggp_hybrid.py`` at a small size on the port alone.
"""

from __future__ import annotations

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpzoo_tpu as gz
from gpzoo_tpu.train.elbo import negative_elbo_hybrid_batched as j_hybrid_batched
from gpzoo_tpu.train.loop import _path_str, _value_and_grad

import gpzoo_tpu_torch as gt
from gpzoo_tpu_torch import convert

N, D, L_TOTAL, L_SP, M_PER, G, B, E = 80, 10, 5, 2, 4, 3, 30, 2
TOL = 1e-8
T = torch.tensor


def jax_leaves(model):
    return {_path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(model)[0]}


def _close(got, expect, rtol=TOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    expect = np.asarray(expect)
    np.testing.assert_allclose(got, expect, rtol=0,
                               atol=rtol * max(np.max(np.abs(expect)), 1e-300))


def _sq_rows(e):
    e = np.asarray(e)
    return np.sum((e[:, None] - e[None]) ** 2, axis=-1)


@pytest.fixture(scope="module")
def warm():
    """(JAX model, port model, JAX ranking, port ranking, data) of the
    warm start of one PNMF."""
    rng = np.random.default_rng(0)
    coords, counts, _ = gz.data.simulate_nsf_counts(N=N, D=D, L=L_SP, seed=0)
    x, y = np.asarray(coords, np.float64), np.asarray(counts, np.float64)
    groups = rng.integers(0, G, N)
    jpnmf = gz.models.PNMF(
        prior=gz.gps.GaussianPrior(mean=jnp.asarray(rng.standard_normal((L_TOTAL, N))),
                                   scale_raw=jnp.asarray(rng.uniform(-2, 1, (L_TOTAL, N)))),
        W_raw=jnp.asarray(rng.uniform(-0.5, 1, (D, L_TOTAL))),
        V_raw=jnp.asarray(rng.normal(1, 0.2, N)))
    tpnmf = convert.pnmf_from_numpy(jax_leaves(jpnmf), "cpu", torch.float64)
    kw = dict(L_spatial=L_SP, m_per_group=M_PER, n_groups=G)
    subset = torch.randperm(N, generator=torch.Generator().manual_seed(3))[:G * M_PER]
    tmodel, tidx, ti = gt.warmstart.hybrid_mggp_from_pnmf(
        torch.Generator().manual_seed(3), tpnmf, T(x), T(groups), **kw)
    with mock.patch.object(jax.random, "choice",
                           lambda *a, **k: jnp.asarray(subset.numpy())):
        jmodel, jidx, ji = gz.warmstart.hybrid_mggp_from_pnmf(
            jax.random.PRNGKey(0), jpnmf, jnp.asarray(x), jnp.asarray(groups), **kw)
    return jmodel, tmodel, (jidx, ji), (tidx, ti), (x, y, groups)


def test_warmstart_assembly_matches_jax(warm):
    jmodel, tmodel, (jidx, ji), (tidx, ti), _ = warm
    assert np.array_equal(jidx, tidx)
    _close(ti, ji, 1e-12)
    jl, tl = jax_leaves(jmodel), convert.to_numpy(tmodel)
    assert set(jl) == set(tl)
    for path in jl:
        if path.endswith("embedding"):
            _close(_sq_rows(tl[path]), _sq_rows(jl[path]), 1e-12)
        else:
            _close(tl[path], jl[path], 1e-12)


def test_warmstart_fine_tune_loss_matches_jax(warm):
    """negative_elbo_hybrid_batched over the assembled models, full-length
    groups_x, the same idx, eps and eps2: the loss and the gradient of
    every leaf but the embedding (its basis differs)."""
    jmodel, tmodel, _, _, (x, y, groups) = warm
    rng = np.random.default_rng(9)
    idx = rng.choice(N, B, replace=False)
    eps, eps2 = rng.standard_normal((E, L_SP, B)), rng.standard_normal(
        (E, L_TOTAL - L_SP, B))
    draws = iter([eps, eps2])
    with mock.patch.object(jax.random, "normal",
                           lambda k, shape, dtype=None: jnp.asarray(next(draws), dtype)):
        jval, jgrad = _value_and_grad(lambda m: j_hybrid_batched(
            m, jnp.asarray(x), jnp.asarray(y), jnp.asarray(idx), jax.random.PRNGKey(0),
            E=E, groups_x=jnp.asarray(groups)), jmodel)
    tval = gt.negative_elbo_hybrid_batched(tmodel, T(x), T(y), T(idx), T(eps), T(eps2),
                                           groups_x=T(groups))
    tval.backward()
    _close(tval, jval)
    jg = jax_leaves(jgrad)
    for path, p in tmodel.named_parameters():
        if not path.endswith("embedding"):
            _close(p.grad, jg[path])


def test_warmstart_pipeline_on_the_port():
    """PNMF (PNMFConfig, full batch), the Moran ranking, the warm start and
    a kernel-frozen minibatch fine-tune, through the port's entry points:
    the losses finite, the kernel unchanged, the PNMF loss falling."""
    coords, counts, _ = gt.data.simulate_nsf_counts(N=N, D=D, L=L_SP, seed=0)
    x, y = T(coords, dtype=torch.float64), T(counts, dtype=torch.float64)
    groups = torch.as_tensor(np.random.default_rng(0).integers(0, G, N))
    gen = torch.Generator().manual_seed(0)
    cfg = gt.PNMFConfig(D=D, N=N, L=L_TOTAL, E=1)
    pnmf = cfg.build(gen, torch.float64)
    step = gt.make_train_step(gt.pnmf_negative_elbo, cfg.optimizer(pnmf), N, L_TOTAL,
                              gen, E=1, loss_kwargs={"unnormalized": True})
    losses = gt.run_steps(step, pnmf, (y,), 30)
    assert losses[-1] < losses[0]
    model, order, moran = gt.warmstart.hybrid_mggp_from_pnmf(
        gen, pnmf, x, groups, L_spatial=L_SP, m_per_group=M_PER, n_groups=G)
    assert sorted(order.tolist()) == list(range(L_TOTAL)) and np.all(np.diff(moran) <= 0)
    gt.freeze_(model, lambda p: ".kernel." not in p)
    kernel_before = {k: v.clone() for k, v in model.sf.prior.kernel.named_parameters()}
    opt = torch.optim.Adam([p for p in model.parameters() if p.requires_grad], lr=1e-3)
    step2 = gt.make_batched_train_step(gt.negative_elbo_hybrid_batched, opt, N, B, L_SP,
                                       gen, E=3, loss_kwargs={"groups_x": groups})
    _, losses2 = gt.train_hybrid_batched(model, step2, x, y, steps=5)
    assert len(losses2) == 5 and np.all(np.isfinite(losses2))
    for k, v in model.sf.prior.kernel.named_parameters():
        assert torch.equal(v, kernel_before[k]), k
