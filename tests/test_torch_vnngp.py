"""The port's VNNGP slice against the JAX package, on CPU.

Inputs are numpy arrays from a seed, fed to both packages; float64 unless a
JAX Pallas kernel (interpret mode) computes in float32. A JAX
``VNNGPConfig`` model is carried over through ``gpzoo_tpu_torch.convert``,
and both losses see the same idx and the same eps (the draws of
``jax.random.normal(key, (E, L, B))`` that the JAX loss makes from ``key``).
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gpzoo_tpu as gz
from gpzoo_tpu.gps.vnngp import gather_blocks as j_gather_blocks
from gpzoo_tpu.ops import vnngp_pallas
from gpzoo_tpu.predict import latent_posterior as j_latent_posterior
from gpzoo_tpu.train.fast import _collapse_shared_kernel as j_collapse
from gpzoo_tpu.train.fast_vnngp import (
    precompute_vnngp_conditioning as j_precompute,
    vnngp_nsf_negative_elbo_batched as j_batched,
    vnngp_nsf_negative_elbo_precomputed as j_precomputed)
from gpzoo_tpu.train.loop import _path_str

import gpzoo_tpu_torch as gt
from gpzoo_tpu_torch.bijectors import lower_cholesky
from gpzoo_tpu_torch.convert import NSF_PATHS, to_numpy, vnngp_from_numpy
from gpzoo_tpu_torch.data.metrics import posterior_mean_deviance
from gpzoo_tpu_torch.gps.vnngp import gather_blocks
from gpzoo_tpu_torch.kernels import NSFRBF
from gpzoo_tpu_torch.ops import vnngp_cuda
from gpzoo_tpu_torch.train.fast import _collapse_shared_kernel

N, D, L, M, K, B = 300, 20, 3, 40, 4, 64
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


def _port(jmodel):
    gp = jmodel.prior
    return vnngp_from_numpy(jax_leaves(jmodel), "cpu", torch.float64, K=gp.K,
                            jitter=gp.jitter, var_floor=gp.var_floor)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    coords = rng.uniform(-2, 2, (N, 2))
    counts_t = rng.poisson(3.0, (N, D)).astype(np.float64)  # spot-major
    return coords, counts_t


def _jmodel(coords, layout):
    """VNNGPConfig's model; ``shared`` keeps its (M,) mu and (M, M) Lu with
    random values, ``per_factor`` gives every factor its own."""
    cfg = gz.VNNGPConfig(D=D, N=N, L=L, M=M, K=K)
    model = cfg.build(jax.random.PRNGKey(5), X=jnp.asarray(coords))
    rng = np.random.default_rng(11)
    lead = (L,) if layout == "per_factor" else ()
    gp = model.prior.replace(
        mu=jnp.asarray(0.3 * rng.standard_normal(lead + (M,))),
        Lu_raw=jnp.asarray(0.2 * rng.standard_normal(lead + (M, M))))
    return model.replace(prior=gp)


@pytest.fixture(scope="module")
def models(data):
    return {layout: _jmodel(data[0], layout)
            for layout in ("shared", "per_factor")}


def _batch(seed, n_train, E):
    k_idx, k_eps = jax.random.split(jax.random.PRNGKey(seed))
    idx = jax.random.choice(k_idx, n_train, (B,), replace=False)
    eps = jax.random.normal(k_eps, (E, L, B), dtype=jnp.float64)
    return idx, k_eps, eps


# --- the shared-kernel collapse ----------------------------------------------

def test_collapse_routes_kernel_gradient_to_factor_zero():
    """The collapsed σ and ℓ are views of factor 0 of the original
    parameters: their whole gradient lands there, as through the JAX
    package's ``kernel.replace``, and the other factors get 0."""
    rng = np.random.default_rng(1)
    x, z = rng.uniform(-2, 2, (17, 2)), rng.uniform(-2, 2, (9, 2))
    g, h = rng.standard_normal((17, 9)), rng.standard_normal(17)

    def f_jax(kernel):
        k = j_collapse(kernel)
        return (jnp.sum(k.gram(jnp.asarray(x), jnp.asarray(z)) * g)
                + jnp.sum(k.diag(jnp.asarray(x)) * h))

    jk = gz.kernels.NSFRBF.create(sigma=1.3, lengthscale=0.8, L=L)
    jgrad = jax.grad(f_jax)(jk)
    tk = NSFRBF.create(sigma=1.3, lengthscale=0.8, L=L, dtype=torch.float64)
    k = _collapse_shared_kernel(tk)
    (torch.sum(k.gram(T(x), T(z)) * T(g)) + torch.sum(k.diag(T(x)) * T(h))).backward()
    for name in ("sigma", "lengthscale"):
        got, expect = getattr(tk, name).grad, np.asarray(getattr(jgrad, name))
        assert got is not None, f"{name}: no gradient reached the parameter"
        _close(got, expect)
        assert float(expect[0, 0, 0]) != 0.0
        assert np.all(got.numpy()[1:] == 0.0) and np.all(expect[1:] == 0.0)


# --- kernel 5: the plain form against the JAX package ------------------------

def _block_operands(rng, n, k, dtype):
    """SPD blocks as in tests/test_pallas.py."""
    a = rng.standard_normal((n, k, k))
    kzz = a @ np.swapaxes(a, -1, -2) + 3 * np.eye(k)
    b = rng.standard_normal((n, k, k)) * 0.3
    s = b @ np.swapaxes(b, -1, -2)
    kxz = rng.standard_normal((n, k))
    mu = rng.standard_normal((n, k))
    kxx = rng.uniform(0.5, 2.0, n)
    return [v.astype(dtype) for v in (kzz, s, kxz, mu, kxx)]


@pytest.mark.parametrize("k", [1, 5, 8, 16])
def test_block_conditional_plain_matches_xla_reference(k):
    ops = _block_operands(np.random.default_rng(k), 300, k, np.float64)
    mean, cov = vnngp_cuda.block_conditional_plain(*map(T, ops), 1e-2)
    jmean, jcov = vnngp_pallas._xla_reference(*map(jnp.asarray, ops), 1e-2)
    _close(mean, jmean, 1e-12)
    _close(cov, jcov, 1e-12)


@pytest.mark.parametrize("k", [1, 5, 8])
def test_block_conditional_plain_matches_pallas_interpret(k):
    """float32 against the TPU kernel in interpret mode at a ragged n, with
    the tolerance of tests/test_pallas.py."""
    ops = _block_operands(np.random.default_rng(20 + k), 300, k, np.float32)
    mean, cov = vnngp_cuda.block_conditional_fwd(*map(T, ops), 1e-2)
    jmean, jcov = vnngp_pallas.block_conditional(*map(jnp.asarray, ops), 1e-2,
                                                 True)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(cov.numpy(), np.asarray(jcov), rtol=2e-4,
                               atol=1e-5)


def test_block_conditional_gradients_match_custom_vjp():
    ops = _block_operands(np.random.default_rng(3), 64, 3, np.float64)
    rng = np.random.default_rng(4)
    gm, gc = rng.standard_normal(64), rng.standard_normal(64)

    def f_jax(*a):
        m, c = vnngp_pallas.block_conditional(*a, 1e-2, True)
        return jnp.sum(m * gm) + jnp.sum(c * gc)

    expect = jax.grad(f_jax, tuple(range(5)))(*map(jnp.asarray, ops))
    ts = [T(v, requires_grad=True) for v in ops]
    m, c = vnngp_cuda.block_conditional(*ts, 1e-2)
    (torch.sum(m * T(gm)) + torch.sum(c * T(gc))).backward()
    for t, e in zip(ts, expect):
        _close(t.grad, e)


def test_block_conditional_wrapper_contract():
    """CPU tensors take the plain form without counting a launch; a tensor
    on a device with no kernel raises; wrong shapes raise."""
    ops = [T(v) for v in _block_operands(np.random.default_rng(5), 10, 2,
                                         np.float64)]
    before = vnngp_cuda.block_conditional_fwd.launches
    vnngp_cuda.block_conditional_fwd(*ops, 0.1)
    assert vnngp_cuda.block_conditional_fwd.launches == before
    with pytest.raises(ValueError):
        vnngp_cuda.block_conditional_fwd(*[t.to("meta") for t in ops], 0.1)
    with pytest.raises(ValueError):
        vnngp_cuda.block_conditional_fwd(ops[0], ops[1], ops[2][:5], ops[3],
                                         ops[4], 0.1)


# --- the VNNGP prior ----------------------------------------------------------

def test_gather_blocks_matches_jax():
    rng = np.random.default_rng(6)
    mat = rng.standard_normal((2, 12, 12))
    idx = rng.integers(0, 12, (7, 3))
    _close(gather_blocks(T(mat), T(idx)),
           j_gather_blocks(jnp.asarray(mat), jnp.asarray(idx)), 0)


@pytest.mark.parametrize("layout", ["shared", "per_factor"])
def test_vnngp_forward_matches_jax(data, models, layout):
    coords = data[0]
    jgp, tgp = models[layout].prior, _port(models[layout]).prior
    jqf, jqu, jpu = jgp(jnp.asarray(coords))
    qf, qu, pu = tgp(T(coords))
    assert qf.loc.shape == (L, N)
    _close(qf.loc, jqf.loc)
    _close(qf.scale, jqf.scale)
    _close(qu.scale_tril, jqu.scale_tril)
    _close(pu.scale_tril, jpu.scale_tril)
    nbr = np.sort(tgp.neighbor_indices(T(coords)).numpy(), axis=-1)
    np.testing.assert_array_equal(
        nbr, np.sort(np.asarray(jgp.neighbor_indices(jnp.asarray(coords))), -1))


# --- the all-trainable step ----------------------------------------------------

@functools.lru_cache(maxsize=None)
def _j_value_and_grad(E, shared_kernel, kl_form):
    return jax.jit(jax.value_and_grad(functools.partial(
        j_batched, E=E, shared_kernel=shared_kernel, y_transposed=True,
        kl_form=kl_form)))


@pytest.mark.parametrize("kl_form", ["matmul", "solve"])
@pytest.mark.parametrize("shared_kernel", [False, True])
@pytest.mark.parametrize("E", [1, 2])
def test_batched_loss_and_gradients_match_jax(data, models, kl_form,
                                              shared_kernel, E):
    """Every leaf's gradient, Z and the kernel included. E=1 runs the
    shared-mu layout of VNNGPConfig, E=2 the per-factor one."""
    coords, y = data
    jmodel = models["shared" if E == 1 else "per_factor"]
    idx, key, eps = _batch(7 + E, N, E)
    jval, jgrad = _j_value_and_grad(E, shared_kernel, kl_form)(
        jmodel, jnp.asarray(coords), jnp.asarray(y), idx, key)
    tmodel = _port(jmodel)
    tval = gt.vnngp_nsf_negative_elbo_batched(
        tmodel, T(coords), T(y), T(np.asarray(idx)), T(np.asarray(eps)),
        shared_kernel=shared_kernel, y_transposed=True, kl_form=kl_form)
    tval.backward()
    _close(tval, jval)
    jg = jax_leaves(jgrad)
    for path, p in tmodel.named_parameters():
        _close(p.grad, jg[path])


def test_batched_loss_rejects_unknown_kl_form(data, models):
    coords, y = data
    with pytest.raises(ValueError):
        gt.vnngp_nsf_negative_elbo_batched(
            _port(models["shared"]), T(coords), T(y), torch.arange(B),
            torch.zeros((1, L, B), dtype=torch.float64), y_transposed=True,
            kl_form="cholesky")


def test_adam_trajectory_matches_optax(data, models):
    """Five Adam(5e-3) steps over every leaf of the bench configuration
    (shared kernel, matmul KL, E=1) on the same idx/eps sequence."""
    coords, y = data
    cfg = gt.VNNGPConfig(D=D, N=N, L=L, M=M, K=K, E=1)
    n_train = N - 30
    batches = [_batch(100 + t, n_train, cfg.E) for t in range(5)]
    jmodel = models["shared"]
    opt = optax.adam(cfg.lr)
    opt_state = opt.init(jmodel)
    vg = _j_value_and_grad(cfg.E, True, "matmul")
    jlosses = []
    for idx, key, _ in batches:
        loss, grads = vg(jmodel, jnp.asarray(coords), jnp.asarray(y), idx, key)
        updates, opt_state = opt.update(grads, opt_state, jmodel)
        jmodel = optax.apply_updates(jmodel, updates)
        jlosses.append(float(loss))

    tmodel = _port(models["shared"])
    gt.freeze_(tmodel, cfg.trainable)
    feed = iter(batches)

    def loss_fed(model, x, y_, idx, eps, **kw):
        # the step's own draws are replaced by the JAX sequence
        jidx, _, jeps = next(feed)
        return gt.vnngp_nsf_negative_elbo_batched(
            model, x, y_, T(np.asarray(jidx)), T(np.asarray(jeps)), **kw)

    step = gt.make_batched_train_step(
        loss_fed, cfg.optimizer(tmodel), n_train, B, L,
        torch.Generator().manual_seed(0), E=cfg.E,
        loss_kwargs={"shared_kernel": True, "y_transposed": True})
    tlosses = gt.run_steps(step, tmodel, (T(coords), T(y)), 5)
    np.testing.assert_allclose(tlosses.numpy(), jlosses, rtol=TOL)
    jl = jax_leaves(jmodel)
    for path, p in tmodel.named_parameters():
        _close(p, jl[path])


# --- the frozen tier -------------------------------------------------------------

@pytest.fixture(scope="module")
def frozen(data, models):
    coords = data[0]
    out = {}
    for layout, jmodel in models.items():
        tmodel = _port(jmodel)
        out[layout] = (jmodel, j_precompute(jmodel, jnp.asarray(coords)),
                       tmodel, gt.precompute_vnngp_conditioning(tmodel, T(coords)))
    return out


@pytest.mark.parametrize("layout", ["shared", "per_factor"])
def test_conditioning_matches_jax(frozen, layout):
    _, jc, _, tc = frozen[layout]
    order_t = np.argsort(tc.idx.numpy(), axis=-1)
    order_j = np.argsort(np.asarray(jc.idx), axis=-1)
    np.testing.assert_array_equal(
        np.take_along_axis(tc.idx.numpy(), order_t, -1),
        np.take_along_axis(np.asarray(jc.idx), order_j, -1))
    # w is per neighbour: compare it in the sorted-neighbour order
    _close(np.take_along_axis(tc.w.numpy(), order_t, -1),
           np.take_along_axis(np.asarray(jc.w), order_j, -1))
    for field in ("c0", "kxx", "k_inv", "logdet_lzz"):
        _close(getattr(tc, field), getattr(jc, field))
    assert tc.kxx.shape == (L, 1)


@pytest.mark.parametrize("layout", ["shared", "per_factor"])
@pytest.mark.parametrize("E", [1, 2])
def test_precomputed_loss_and_gradients_match_jax(data, frozen, layout, E):
    y = data[1]
    jmodel, jc, tmodel, tc = frozen[layout]
    idx, key, eps = _batch(30 + E, N, E)
    jval, jgrad = jax.jit(jax.value_and_grad(functools.partial(
        j_precomputed, E=E, y_transposed=True)))(
        jmodel, jc, jnp.asarray(y), idx, key)
    tmodel.zero_grad(set_to_none=True)
    tval = gt.vnngp_nsf_negative_elbo_precomputed(
        tmodel, tc, T(y), T(np.asarray(idx)), T(np.asarray(eps)),
        y_transposed=True)
    tval.backward()
    _close(tval, jval)
    jg = jax_leaves(jgrad)
    params = dict(tmodel.named_parameters())
    for path in ("prior.mu", "prior.Lu_raw", "W_raw", "V_raw"):
        _close(params[path].grad, jg[path])


def test_precompute_rejects_unequal_factor_kernels(data, models):
    tmodel = _port(models["shared"])
    with torch.no_grad():
        tmodel.prior.kernel.sigma[1] += 0.1
    with pytest.raises(ValueError):
        gt.precompute_vnngp_conditioning(tmodel, T(data[0]))


# --- the full posterior and the held-out deviance -------------------------------

@pytest.mark.parametrize("chunk_size", [None, 70])
def test_latent_posterior_matches_jax(data, models, chunk_size):
    coords = data[0]
    jmodel = models["per_factor"]
    jmean, jscale = j_latent_posterior(jmodel.prior, jnp.asarray(coords),
                                       chunk_size=chunk_size)
    with torch.no_grad():
        mean, scale = gt.latent_posterior(_port(jmodel).prior, T(coords),
                                          chunk_size=chunk_size)
    assert mean.shape == (L, N)
    _close(mean, jmean)
    _close(scale, jscale)
    with pytest.raises(ValueError, match="no 'data' axis"):
        gt.latent_posterior(_port(jmodel).prior, T(coords),
                            mesh=types.SimpleNamespace(mesh_dim_names=("factor",)))


def test_posterior_mean_deviance_matches_bench(data, models):
    from bench import _plugin_rate_deviance

    coords, y = data
    jmodel = models["shared"]
    vidx = np.arange(N - 30, N)
    jmean, _ = j_latent_posterior(jmodel.prior, jnp.asarray(coords))
    expect = _plugin_rate_deviance(jmodel.V_raw[vidx],
                                   [(jmodel.W_raw, jmean[..., vidx])],
                                   jnp.asarray(y[vidx].T))
    got = posterior_mean_deviance(_port(jmodel), T(np.asarray(jmean)), T(y),
                                  T(vidx))
    _close(got, expect)


# --- conversion and config -------------------------------------------------------

def test_vnngp_round_trip_is_exact(models):
    jmodel = models["per_factor"]
    params = jax_leaves(jmodel)
    assert set(params) == set(NSF_PATHS)
    port = _port(jmodel)
    assert {n for n, _ in port.named_parameters()} == set(NSF_PATHS)
    back = to_numpy(port)
    for path in NSF_PATHS:
        assert back[path].dtype == np.float64
        np.testing.assert_array_equal(back[path], params[path])
    gp = port.prior
    assert (gp.K, gp.jitter, gp.var_floor) == (
        jmodel.prior.K, jmodel.prior.jitter, jmodel.prior.var_floor)


def test_vnngp_config_build_init():
    g = torch.Generator().manual_seed(0)
    x = torch.rand((50, 2), generator=g, dtype=torch.float64)
    cfg = gt.VNNGPConfig(D=7, N=50, L=3, M=12, K=4)
    model = cfg.build(g, x)
    gp = model.prior
    assert torch.equal(lower_cholesky(gp.Lu_raw),
                       torch.eye(12, dtype=torch.float64))
    assert torch.equal(gp.mu.detach(), torch.zeros(12, dtype=torch.float64))
    assert len({tuple(r.tolist()) for r in gp.Z}) == 12
    assert all(any(torch.equal(r, xr) for xr in x) for r in gp.Z.detach())
    assert gp.kernel.sigma.shape == (3, 1, 1)
    assert torch.equal(gp.kernel.lengthscale.detach(),
                       torch.ones((3, 1, 1), dtype=torch.float64))
    assert (gp.K, gp.jitter, gp.var_floor) == (4, 0.1, 5e-2)
    w = model.W_raw.detach()
    assert w.shape == (7, 3) and bool((w >= 0).all() and (w < 1).all())
    assert torch.equal(model.V_raw.detach(), torch.ones(50, dtype=torch.float64))
    assert all(p.requires_grad for p in model.parameters())
    opt = cfg.optimizer(model)
    assert sum(len(gr["params"]) for gr in opt.param_groups) == 7
    assert opt.defaults["lr"] == 5e-3
    assert gt.VNNGP_SHAPES == gz.configs.VNNGP_SHAPES


def test_count_likelihood_is_poisson_only():
    from types import SimpleNamespace

    from gpzoo_tpu_torch.train.fast import _count_py

    from gpzoo_tpu_torch.bijectors import softplus
    from gpzoo_tpu_torch.dists import NegativeBinomial, Poisson

    rate = torch.ones(3, dtype=torch.float64)
    py = _count_py(SimpleNamespace(), rate)
    assert type(py) is Poisson and py.rate is rate
    # a head with a per-gene dispersion r_raw is negative binomial
    r_raw = torch.zeros(3, dtype=torch.float64)
    nb = _count_py(SimpleNamespace(r_raw=r_raw), rate)
    assert type(nb) is NegativeBinomial and nb.rate is rate
    assert torch.equal(nb.total_count, softplus(r_raw)[:, None])


def test_vnngp_losses_reject_other_heads(data):
    from gpzoo_tpu_torch.models import NSF

    svgp_like = NSF(gt.SVGP(NSFRBF.create(L=2), torch.zeros(3, 2),
                            torch.zeros(3), torch.zeros(3, 3)),
                    torch.zeros(2, 2), torch.zeros(4))
    with pytest.raises(NotImplementedError):
        gt.precompute_vnngp_conditioning(svgp_like, torch.zeros(4, 2))
    with pytest.raises(NotImplementedError):
        gt.vnngp_nsf_negative_elbo_batched(svgp_like, None, None, None, None)
