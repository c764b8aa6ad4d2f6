"""The port's MGGP slice against the JAX package, on CPU.

Inputs are numpy arrays from a seed, fed to both packages; float64 unless a
JAX Pallas kernel (interpret mode) computes in float32. A JAX
``MGGPNSFConfig`` model is carried over through ``gpzoo_tpu_torch.convert``
(its MDS embedding included: an embedding is not unique, so the tests
compare Grams and g², never two embeddings built apart), and both losses
see the same idx and the same eps (the draws of
``jax.random.normal(key, (E, L, B))`` that the JAX loss makes from
``key``).
"""

import ast
import functools
import importlib.util
import os
import pkgutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gpzoo_tpu as gz
from gpzoo_tpu.bijectors import GroupDiffConvention as JConvention
from gpzoo_tpu.ops import gram_pallas
from gpzoo_tpu.ops import linalg as jlinalg
from gpzoo_tpu.ops import tri_blocked as jtri
from gpzoo_tpu.ops.distance import squared_dist as j_squared_dist
from gpzoo_tpu.predict import latent_posterior as j_latent_posterior
from gpzoo_tpu.train import freeze_loss, partition_optimizer, trainable_mask
from gpzoo_tpu.train.fast import nsf_negative_elbo_batched as j_batched
from gpzoo_tpu.train.loop import _path_str, _value_and_grad

import gpzoo_tpu_torch as gt
from gpzoo_tpu_torch.bijectors import GroupDiffConvention
from gpzoo_tpu_torch.convert import (MGGP_PATHS, mggp_nsf_from_numpy,
                                     nsf_from_numpy, to_numpy,
                                     vnngp_from_numpy)
from gpzoo_tpu_torch.data.metrics import posterior_deviance
from gpzoo_tpu_torch.kernels import mggp as tmggp
from gpzoo_tpu_torch.ops import linalg, mggp_cuda, tri_blocked, tri_cuda
from gpzoo_tpu_torch.ops.distance import squared_dist

N, D, L, G, M_PER, B, MB = 300, 20, 3, 3, 8, 64, 32
M = G * M_PER
TOL = 1e-8
T = torch.tensor
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _jmodel(coords, groups, layout):
    """MGGPNSFConfig's model with distinct per-factor kernels; ``shared``
    keeps the config's (M,) mu and (M, M) Lu layout, ``per_factor`` is the
    benchmark's (L, M) / (L, M, M) layout, both with small random values."""
    cfg = gz.MGGPNSFConfig(D=D, N=N, L=L, M_per_group=M_PER, n_groups=G,
                           batch_size=B)
    model = cfg.build(jax.random.PRNGKey(3), X=jnp.asarray(coords),
                      groups=groups)
    rng = np.random.default_rng(11)
    lead = (L,) if layout == "per_factor" else ()
    kernel = model.gp.kernel.replace(
        sigma=jnp.asarray(rng.uniform(0.8, 1.3, (L, 1, 1))),
        lengthscale=jnp.asarray(rng.uniform(1.0, 2.0, (L, 1, 1))),
        group_diff_param=jnp.asarray(rng.uniform(1.5, 2.5, (L, 1, 1))))
    gp = model.gp.replace(
        kernel=kernel,
        mu=jnp.asarray(0.3 * rng.standard_normal(lead + (M,))),
        Lu_raw=jnp.asarray(0.2 * rng.standard_normal(lead + (M, M))))
    return model.replace(gp=gp)


@pytest.fixture(scope="module")
def models(data):
    coords, _, groups = data
    return {layout: _jmodel(coords, groups, layout)
            for layout in ("shared", "per_factor")}


def _port(jmodel):
    gp = jmodel.gp
    return mggp_nsf_from_numpy(jax_leaves(jmodel), "cpu", torch.float64,
                               jitter=gp.jitter, var_floor=gp.var_floor)


def _batch(seed, n_train, E):
    k_idx, k_eps = jax.random.split(jax.random.PRNGKey(seed))
    idx = jax.random.choice(k_idx, n_train, (B,), replace=False)
    eps = jax.random.normal(k_eps, (E, L, B), dtype=jnp.float64)
    return idx, k_eps, eps


# --- conventions, embeddings, kernels -----------------------------------------

@pytest.mark.parametrize("name", ["ABS", "RAW", "SQUARED"])
def test_group_diff_conventions(name):
    alpha = np.random.default_rng(1).standard_normal((4, 1, 1))
    _close(GroupDiffConvention[name].apply(T(alpha)),
           JConvention[name].apply(jnp.asarray(alpha)), 0)


@pytest.mark.parametrize("source", ["complete_graph", "group_means"])
def test_embedding_squared_distances_match_jax(data, source):
    """The embeddings may differ by a rotation inside the repeated
    eigenspace; their g² may not."""
    coords, _, groups = data
    if source == "complete_graph":
        dist = np.ones((5, 5)) - np.eye(5)
    else:
        dist = np.asarray(jlinalg.build_group_distances(
            jnp.asarray(coords), jnp.asarray(groups), G))
        _close(linalg.build_group_distances(T(coords), T(groups), G), dist, 1e-12)
    emb = linalg.embed_distance_matrix(T(dist))
    jemb = jlinalg.embed_distance_matrix(jnp.asarray(dist))
    _close(squared_dist(emb, emb), j_squared_dist(jemb, jemb), 1e-10)


KERNELS = {"MGGPRBF": ((), GroupDiffConvention.RAW),
           "MGGPNSFRBF": ((L, 1, 1), GroupDiffConvention.SQUARED),
           "BatchedMGGPRBF": ((), GroupDiffConvention.ABS)}


@pytest.mark.parametrize("n_groups", [4, 14])
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_mggp_kernels_match_jax(name, n_groups):
    shape, convention = KERNELS[name]
    rng = np.random.default_rng(2)
    x, z = rng.uniform(-2, 2, (37, 2)), rng.uniform(-2, 2, (23, 2))
    gx, gz_ = rng.integers(0, n_groups, 37), rng.integers(0, n_groups, 23)
    hp = {k: rng.uniform(0.5, 1.5, shape) * s for k, s in
          (("sigma", 1), ("lengthscale", 1), ("group_diff_param", -1))}
    jk = getattr(gz.kernels, name).create(n_groups=n_groups).replace(
        **{k: jnp.asarray(v) for k, v in hp.items()})
    tk = getattr(tmggp, name)(*(T(hp[k]) for k in hp),
                              T(np.asarray(jk.embedding)))
    assert tk.convention is convention
    _close(tk.gram(T(x), T(z), T(gx), T(gz_)),
           jk.gram(jnp.asarray(x), jnp.asarray(z), jnp.asarray(gx),
                   jnp.asarray(gz_)), 1e-10)
    _close(tk.diag(T(x), T(gx)), jk.diag(jnp.asarray(x), jnp.asarray(gx)), 0)
    assert tk.batch_shape() == (L,) * (len(shape) > 0)
    gram, dist = tk.gram_and_distance(T(x), T(z), T(gx), T(gz_))
    jgram, jdist = jk.gram_and_distance(jnp.asarray(x), jnp.asarray(z),
                                        jnp.asarray(gx), jnp.asarray(gz_))
    _close(gram, jgram, 1e-10)
    _close(dist, jdist, 1e-12)


def test_with_group_distances_and_default_embedding():
    dist = np.abs(np.random.default_rng(3).standard_normal((4, 4)))
    dist = dist + dist.T
    np.fill_diagonal(dist, 0)
    tk = tmggp.MGGPNSFRBF.create(n_groups=4, L=2, dtype=torch.float64)
    jk = gz.kernels.MGGPNSFRBF.create(n_groups=4, L=2)
    _close(squared_dist(tk.embedding, tk.embedding),
           j_squared_dist(jk.embedding, jk.embedding), 1e-10)
    tk2 = tk.with_group_distances(T(dist))
    jk2 = jk.with_group_distances(jnp.asarray(dist))
    _close(squared_dist(tk2.embedding, tk2.embedding),
           j_squared_dist(jk2.embedding, jk2.embedding), 1e-10)
    assert tk2.embedding.requires_grad and tk2 is not tk


# --- kernel 4: the plain form against the JAX package ------------------------

def _mggp_operands(rng, n, m, g, l_dim, dtype):
    emb = rng.standard_normal((g, g))
    return [v.astype(dtype) for v in (
        rng.uniform(-2, 2, (n, 2)), rng.uniform(-2, 2, (m, 2)),
        emb[rng.integers(0, g, n)], emb[rng.integers(0, g, m)],
        rng.uniform(0.5, 1.5, l_dim), rng.uniform(0.5, 2.0, l_dim),
        rng.uniform(0.2, 3.0, l_dim))]


@pytest.mark.parametrize("n_groups", [1, 5, 17])
@pytest.mark.parametrize("input_dim", [2, 3])
def test_mggp_gram_plain_matches_pallas_interpret(input_dim, n_groups):
    """float32 at a ragged 300×270 against the TPU kernel in interpret
    mode, with the tolerance of tests/test_pallas.py; 17 groups is an
    embedding wider than the card kernel's 16-column pass."""
    ops = _mggp_operands(np.random.default_rng(4), 300, 270, n_groups, 3,
                         np.float32)
    got = mggp_cuda.mggp_gram_fwd(*map(T, ops), input_dim)
    expect = gram_pallas.mggp_gram(*map(jnp.asarray, ops), input_dim, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=2e-5,
                               atol=1e-6)


@pytest.mark.parametrize("n_groups", [4, 17])
@pytest.mark.parametrize("input_dim", [2, 3])
def test_mggp_gram_gradients_match_jax_vjp(input_dim, n_groups):
    """The seven gradients of MGGPGram against jax.vjp of _mggp_gram_xla."""
    ops = _mggp_operands(np.random.default_rng(5), 40, 30, n_groups, 3,
                         np.float64)
    g = np.random.default_rng(6).standard_normal((3, 40, 30))
    out, vjp = jax.vjp(
        lambda *a: gram_pallas._mggp_gram_xla(*a, input_dim=input_dim),
        *map(jnp.asarray, ops))
    ts = [T(v, requires_grad=True) for v in ops]
    got = mggp_cuda.mggp_gram(*ts, input_dim)
    _close(got, out, 1e-12)
    got.backward(T(g))
    for t, e in zip(ts, vjp(jnp.asarray(g))):
        _close(t.grad, e)


def test_mggp_gram_wrapper_contract():
    """CPU tensors take the plain form without counting a launch; a tensor
    on a device with no kernel raises; wrong shapes raise."""
    ops = [T(v) for v in _mggp_operands(np.random.default_rng(7), 9, 7, 3, 2,
                                        np.float32)]
    before = mggp_cuda.mggp_gram_fwd.launches
    mggp_cuda.mggp_gram_fwd(*ops, 2)
    assert mggp_cuda.mggp_gram_fwd.launches == before
    with pytest.raises(ValueError):
        mggp_cuda.mggp_gram_fwd(*[t.to("meta") for t in ops], 2)
    for bad in (2, 3, 6):  # ex rows, ez width, alpha length
        broken = list(ops)
        broken[bad] = broken[bad][:-1] if bad != 3 else broken[bad][:, :-1]
        with pytest.raises(ValueError):
            mggp_cuda.mggp_gram_fwd(*broken, 2)


# --- linalg and the triangular products ------------------------------------

@pytest.mark.parametrize("shape", [(20, 20), (2, 20, 20), (3, 1, 1),
                                   (4, 64, 64)])
def test_cholesky_inverse_mm_matches_jax(shape):
    rng = np.random.default_rng(8)
    m_dim = shape[-1]
    a = rng.standard_normal(shape)
    k = a @ np.swapaxes(a, -1, -2) + m_dim * np.eye(m_dim)
    gl, gw = rng.standard_normal((2,) + shape)

    def f_jax(k_):
        lzz, w = jlinalg.cholesky_inverse_mm(k_, "default")
        return jnp.sum(lzz * gl) + jnp.sum(w * gw), (lzz, w)

    (_, (jl, jw)), jgrad = jax.value_and_grad(f_jax, has_aux=True)(jnp.asarray(k))
    kt = T(k, requires_grad=True)
    lzz, w = linalg.cholesky_inverse_mm(kt)
    _close(lzz, jl, 1e-12)
    _close(w, jw, 1e-10)
    (torch.sum(lzz * T(gl)) + torch.sum(w * T(gw))).backward()
    _close(kt.grad, jgrad)


def test_svgp_forward_matches_jax():
    rng = np.random.default_rng(9)
    ops = (rng.uniform(1, 2, (2, 7)), rng.standard_normal((2, 5, 5)),
           rng.standard_normal((2, 7, 5)), rng.standard_normal(5),
           rng.standard_normal((2, 5, 5)))
    for got, expect in zip(linalg.svgp_forward(*map(T, ops)),
                           jlinalg.svgp_forward(*map(jnp.asarray, ops))):
        _close(got, expect, 1e-13)


@pytest.mark.parametrize("m_dim", [40, 1100])
def test_tri_matmul_and_tri_tri_matmul_match_jax(m_dim):
    """M=40 runs as one panel, M=1100 (≥ MIN_DIM) as six; values and
    gradients, W per factor and Lu shared (broadcast)."""
    rng = np.random.default_rng(10)
    w = np.tril(rng.standard_normal((2, m_dim, m_dim))) / np.sqrt(m_dim)
    lu = np.tril(rng.standard_normal((1, m_dim, m_dim))) / np.sqrt(m_dim)
    rhs = rng.standard_normal((2, m_dim, 9))
    g_a, g_c = rng.standard_normal((2, m_dim, 9)), rng.standard_normal((2, m_dim, m_dim))

    def f_jax(w_, lu_, rhs_):
        return (jnp.sum(jtri.tri_matmul(w_, rhs_) * g_a)
                + jnp.sum(jtri.tri_tri_matmul(w_, lu_) * g_c))

    jval, jgrads = jax.value_and_grad(f_jax, (0, 1, 2))(
        jnp.asarray(w), jnp.asarray(lu), jnp.asarray(rhs))
    ts = [T(v, requires_grad=True) for v in (w, lu, rhs)]
    a = tri_blocked.tri_matmul(ts[0], ts[2])
    c = tri_blocked.tri_tri_matmul(ts[0], ts[1])
    _close(a, jtri.tri_matmul(jnp.asarray(w), jnp.asarray(rhs)), 1e-12)
    _close(c, jtri.tri_tri_matmul(jnp.asarray(w), jnp.asarray(lu)), 1e-12)
    val = torch.sum(a * T(g_a)) + torch.sum(c * T(g_c))
    val.backward()
    _close(val, jval, 1e-12)
    for t, e in zip(ts, jgrads):
        _close(t.grad, e, 1e-10)


@pytest.mark.parametrize("m_dim", [40, 1100])
def test_tri_sq_colsum_per_factor_a(m_dim):
    """TriSqColsum with a per-factor a (L, M, B): value, dLu (tril) and
    da_l = Lu_l·dc_l against jax.grad through tri_sq_colsum(tril(lu), a);
    the CPU wrappers take the plain forms and count no launch."""
    rng = np.random.default_rng(12)
    lu = rng.standard_normal((2, m_dim, m_dim)) / np.sqrt(m_dim)
    a = rng.standard_normal((2, m_dim, 11))
    g = rng.standard_normal((2, 11))
    f = lambda l_, a_: jnp.sum(jtri.tri_sq_colsum(jnp.tril(l_), a_) * g)
    val, (dlu, da) = jax.value_and_grad(f, (0, 1))(jnp.asarray(lu), jnp.asarray(a))
    before = (tri_cuda.tri_sq_colsum_fused.launches, tri_cuda.tri_t_matmul.launches)
    lu_t, a_t = T(lu, requires_grad=True), T(a, requires_grad=True)
    out = tri_cuda.tri_sq_colsum(torch.tril(lu_t), a_t)
    out.backward(T(g))
    _close(torch.sum(out * T(g)), val, 1e-10)
    _close(lu_t.grad, dlu, 1e-10)
    _close(a_t.grad, da, 1e-10)
    _close(tri_cuda.tri_t_matmul(T(np.tril(lu)), T(a)),
           jnp.einsum("lkm,lkb->lmb", jnp.tril(jnp.asarray(lu)), jnp.asarray(a)),
           1e-10)
    assert (tri_cuda.tri_sq_colsum_fused.launches,
            tri_cuda.tri_t_matmul.launches) == before
    with pytest.raises(ValueError):  # a per factor must have L factors
        tri_cuda.tri_sq_colsum_fused(T(lu), T(a[:1]))


@pytest.mark.parametrize("m_dim", [40, 1100])
def test_tri_sq_colsum_per_factor_a_equal_factors_match_shared(m_dim):
    """A per-factor a whose factors are all one (M, B) a gives the shared
    layout's value and dLu, and its per-factor da sums to the shared da."""
    rng = np.random.default_rng(14)
    lu = np.tril(rng.standard_normal((3, m_dim, m_dim))) / np.sqrt(m_dim)
    a = rng.standard_normal((m_dim, 5))
    g = T(rng.standard_normal((3, 5)))
    out = {}
    for layout, a_np in (("shared", a), ("per_factor", np.stack([a] * 3))):
        lu_t, a_t = T(lu, requires_grad=True), T(a_np, requires_grad=True)
        val = tri_cuda.tri_sq_colsum(lu_t, a_t)
        val.backward(g)
        out[layout] = (val.detach(), lu_t.grad, a_t.grad)
    (v_s, dlu_s, da_s), (v_p, dlu_p, da_p) = out["shared"], out["per_factor"]
    _close(v_p, v_s.numpy(), 1e-12)
    _close(dlu_p, dlu_s.numpy(), 1e-12)
    _close(da_p.sum(0), da_s.numpy(), 1e-12)


# --- the MGGP prior and head ------------------------------------------------

@pytest.mark.parametrize("layout", ["shared", "per_factor"])
def test_mggp_svgp_forward_matches_jax(data, models, layout):
    coords, _, groups = data
    jgp, tgp = models[layout].gp, _port(models[layout]).gp
    jqf, jqu, jpu = jgp(jnp.asarray(coords), jnp.asarray(groups))
    qf, qu, pu = tgp(T(coords), T(groups))
    assert qf.loc.shape == (L, N)
    _close(qf.loc, jqf.loc)
    _close(qf.scale, jqf.scale)
    _close(qu.scale_tril, jqu.scale_tril)
    _close(pu.scale_tril, jpu.scale_tril)


def test_mggpnsf_forward_matches_jax(data, models):
    coords, counts_t, groups = data
    jmodel = models["per_factor"]
    key = jax.random.PRNGKey(4)
    jpy = jmodel(jnp.asarray(coords), key, E=2, groups_x=jnp.asarray(groups))[0]
    eps = jax.random.normal(key, (2, L, N), dtype=jnp.float64)
    with torch.no_grad():
        py = _port(jmodel)(T(coords), T(np.asarray(eps)), groups_x=T(groups))[0]
    _close(py.rate, jpy.rate)


# --- the blockwise W-form step -----------------------------------------------

@functools.lru_cache(maxsize=None)
def _j_value_and_grad(E, remat):
    return jax.jit(lambda m, x, y, idx, key, g: _value_and_grad(
        lambda m_: j_batched(m_, x, y, idx, key, E=E, microbatch=MB,
                             factored=True, y_transposed=True, groups=g,
                             remat=remat), m))


@pytest.mark.parametrize("layout,E", [("shared", 1), ("per_factor", 2)])
def test_batched_loss_and_gradients_match_jax(data, models, layout, E):
    """Two chunks; every float leaf's gradient, Z and the group embedding
    included."""
    coords, y, groups = data
    jmodel = models[layout]
    idx, key, eps = _batch(7 + E, N, E)
    jval, jgrad = _j_value_and_grad(E, True)(
        jmodel, jnp.asarray(coords), jnp.asarray(y), idx, key, jnp.asarray(groups))
    tmodel = _port(jmodel)
    tval = gt.nsf_negative_elbo_batched(
        tmodel, T(coords), T(y), T(np.asarray(idx)), T(np.asarray(eps)), E=E,
        microbatch=MB, factored=True, y_transposed=True, groups=T(groups))
    tval.backward()
    _close(tval, jval)
    jg = jax_leaves(jgrad)
    names = {name for name, _ in tmodel.named_parameters()}
    assert names == set(MGGP_PATHS) - {"gp.groupsZ"}
    for path, p in tmodel.named_parameters():
        _close(p.grad, jg[path])


def test_batched_loss_nsf_over_svgp_per_factor_kernel_matches_jax(data):
    """NSF over an SVGP whose NSFRBF has per-factor σ and ℓ also resolves
    to the W-form branch; every leaf trains, Z and the kernel included."""
    coords, y, _ = data
    cfg = gz.SlideseqNSFConfig(D=D, N=N, L=L, M=M, batch_size=B)
    jmodel = cfg.build(jax.random.PRNGKey(0), jnp.asarray(coords))
    rng = np.random.default_rng(13)
    kernel = jmodel.prior.kernel.replace(
        sigma=jnp.asarray(rng.uniform(0.8, 1.3, (L, 1, 1))),
        lengthscale=jnp.asarray(rng.uniform(0.8, 1.5, (L, 1, 1))))
    jmodel = jmodel.replace(prior=jmodel.prior.replace(
        kernel=kernel, Lu_raw=jnp.asarray(0.2 * rng.standard_normal((L, M, M)))))
    idx, key, eps = _batch(21, N, 1)
    jval, jgrad = jax.value_and_grad(functools.partial(
        j_batched, E=1, microbatch=MB, factored=True, y_transposed=True))(
        jmodel, jnp.asarray(coords), jnp.asarray(y), idx, key)
    tmodel = nsf_from_numpy(jax_leaves(jmodel), "cpu", torch.float64,
                            jitter=jmodel.prior.jitter,
                            var_floor=jmodel.prior.var_floor)
    tval = gt.nsf_negative_elbo_batched(
        tmodel, T(coords), T(y), T(np.asarray(idx)), T(np.asarray(eps)),
        microbatch=MB, factored=True, y_transposed=True)
    tval.backward()
    _close(tval, jval)
    jg = jax_leaves(jgrad)
    for path, p in tmodel.named_parameters():
        _close(p.grad, jg[path])


@pytest.mark.parametrize("layout", ["shared", "per_factor"])
def test_remat_true_matches_false(data, models, layout):
    """Recomputing each chunk under torch.utils.checkpoint changes nothing."""
    coords, y, groups = data
    _, _, eps = _batch(30, N, 1)
    idx = T(np.arange(B))
    out = []
    for remat in (True, False):
        tmodel = _port(models[layout])
        loss = gt.nsf_negative_elbo_batched(
            tmodel, T(coords), T(y), idx, T(np.asarray(eps)), microbatch=MB,
            factored=True, y_transposed=True, groups=T(groups), remat=remat)
        loss.backward()
        out.append((loss.detach(), {n: p.grad for n, p in tmodel.named_parameters()}))
    for loss, grads in out[1:]:
        _close(loss, out[0][0], 1e-13)
        for name, grad in grads.items():
            _close(grad, out[0][1][name], 1e-12)


def test_adam_trajectory_matches_optax(data, models):
    """Five Adam(1e-3) steps of the benchmark's configuration (per-factor
    mu/Lu, Z frozen, everything else trained, the embedding included) on
    the same idx/eps sequence: the port's step against optax under the JAX
    mask (partition_optimizer + freeze_loss)."""
    coords, y, groups = data
    cfg = gt.MGGPNSFConfig(D=D, N=N, L=L, M_per_group=M_PER, n_groups=G,
                           batch_size=B)
    n_train = N - 30
    batches = [_batch(100 + t, n_train, cfg.E) for t in range(5)]
    jmodel = models["per_factor"]
    mask = trainable_mask(jmodel, lambda p: not p.endswith(".Z"))
    opt = partition_optimizer(optax.adam(cfg.lr), mask)
    loss = freeze_loss(j_batched, mask)

    @jax.jit
    def jstep(model, opt_state, idx, key):
        val, grads = _value_and_grad(lambda m: loss(
            m, jnp.asarray(coords), jnp.asarray(y), idx, key, E=1,
            microbatch=MB, factored=True, y_transposed=True,
            groups=jnp.asarray(groups), remat="save_proj"), model)
        updates, opt_state = opt.update(grads, opt_state, model)
        return optax.apply_updates(model, updates), opt_state, val

    opt_state = opt.init(jmodel)
    jlosses = []
    for idx, key, _ in batches:
        jmodel, opt_state, val = jstep(jmodel, opt_state, idx, key)
        jlosses.append(float(val))

    tmodel = gt.freeze_(_port(models["per_factor"]), cfg.trainable)
    assert not tmodel.gp.Z.requires_grad and tmodel.gp.kernel.embedding.requires_grad
    feed = iter(batches)

    def loss_fed(model, x, y_, idx, eps, **kw):
        # the step's own draws are replaced by the JAX sequence
        jidx, _, jeps = next(feed)
        return gt.nsf_negative_elbo_batched(
            model, x, y_, T(np.asarray(jidx)), T(np.asarray(jeps)), **kw)

    step = gt.make_batched_train_step(
        loss_fed, cfg.optimizer(tmodel), n_train, B, L,
        torch.Generator().manual_seed(0), E=cfg.E,
        loss_kwargs=dict(microbatch=MB, factored=True, y_transposed=True,
                         groups=T(groups), remat=False))
    tlosses = gt.run_steps(step, tmodel, (T(coords), T(y)), 5)
    np.testing.assert_allclose(tlosses.numpy(), jlosses, rtol=TOL)
    jl = jax_leaves(jmodel)
    for path, p in tmodel.named_parameters():
        if path != "gp.kernel.embedding":
            _close(p, jl[path])
    # Column 0 of the MDS embedding is the centring's null direction: its
    # entries are equal across groups, so its gradient is rounding noise in
    # either package, and Adam's per-element scaling turns that noise into
    # steps of up to ~lr. The other columns carry the gradient.
    emb, jemb = tmodel.gp.kernel.embedding.detach().numpy(), jl["gp.kernel.embedding"]
    _close(emb[:, 1:], jemb[:, 1:])
    assert np.max(np.abs(emb[:, 0] - jemb[:, 0])) <= 2 * 5 * cfg.lr
    assert torch.equal(tmodel.gp.groupsZ, T(jl["gp.groupsZ"]))


@pytest.mark.parametrize("case", ["not_factored", "shared_kernel",
                                  "shared_cholesky", "vnngp_prior"])
def test_unported_branches_raise(data, models, case):
    coords, y, groups = data
    kw = dict(microbatch=MB, factored=True, y_transposed=True, groups=T(groups))
    model = _port(models["shared"])
    if case == "not_factored":
        kw["factored"] = False
    elif case == "shared_kernel":
        kw["shared_kernel"] = True
    elif case == "shared_cholesky":  # a scalar kernel: one (M, M) Cholesky
        model = gt.NSF(gt.SVGP(gt.RBF(T(1.0), T(1.0)), T(coords[:M]),
                               torch.zeros((L, M), dtype=torch.float64),
                               torch.zeros((L, M, M), dtype=torch.float64)),
                       torch.zeros((D, L), dtype=torch.float64),
                       torch.zeros(N, dtype=torch.float64))
        del kw["groups"]
    else:
        model = gt.VNNGPConfig(D=D, N=N, L=L, M=M, K=4).build(
            torch.Generator().manual_seed(0), T(coords))
        del kw["groups"]
    with pytest.raises(NotImplementedError):
        gt.nsf_negative_elbo_batched(model, T(coords), T(y), T(np.arange(B)),
                                     torch.zeros((1, L, B), dtype=torch.float64),
                                     **kw)


@pytest.mark.parametrize("kw", [dict(microbatch=30), dict(groups=None),
                                dict(eps_shape=(2, L, B)),
                                dict(remat="save_proj")])
def test_batched_loss_rejects_bad_arguments(data, models, kw):
    coords, y, groups = data
    args = dict(microbatch=MB, factored=True, y_transposed=True, groups=T(groups))
    eps_shape = kw.pop("eps_shape", (1, L, B))
    args.update(kw)
    with pytest.raises(ValueError):
        gt.nsf_negative_elbo_batched(_port(models["shared"]), T(coords), T(y),
                                     T(np.arange(B)),
                                     torch.zeros(eps_shape, dtype=torch.float64),
                                     **args)


# --- posterior and held-out deviance -----------------------------------------

@pytest.mark.parametrize("chunk_size", [None, 70, 128, N])
def test_latent_posterior_with_groups_matches_jax(data, models, chunk_size):
    coords, _, groups = data
    jmodel = models["per_factor"]
    jmean, jscale = j_latent_posterior(jmodel.gp, jnp.asarray(coords),
                                       jnp.asarray(groups), chunk_size=chunk_size)
    with torch.no_grad():
        # groups is the third positional parameter, as in the JAX package
        mean, scale = gt.latent_posterior(_port(jmodel).gp, T(coords), T(groups),
                                          chunk_size)
    assert mean.shape == (L, N)
    _close(mean, jmean)
    _close(scale, jscale)


def test_posterior_deviance_matches_mggp_anatomy(data, models):
    from benchmarks.mggp_anatomy import _val_deviance

    coords, y, groups = data
    jmodel = models["per_factor"]
    expect = _val_deviance(jmodel, jnp.asarray(coords), jnp.asarray(y),
                           jnp.asarray(groups), N - 30, N)
    tmodel = _port(jmodel)
    assert tmodel.gp_prior is tmodel.gp
    got = posterior_deviance(tmodel, T(coords), T(y), T(np.arange(N - 30, N)),
                             T(groups))
    _close(got, expect)


def test_posterior_deviance_nsf_over_vnngp_matches_jax(data):
    """The same held-out deviance for an NSF head, whose GP ``gp_prior``
    finds under ``prior``."""
    from bench import _plugin_rate_deviance

    coords, y, _ = data
    vidx = np.arange(N - 30, N)
    jmodel = gz.VNNGPConfig(D=D, N=N, L=L, M=M, K=4).build(
        jax.random.PRNGKey(5), X=jnp.asarray(coords))
    tmodel = vnngp_from_numpy(jax_leaves(jmodel), "cpu", torch.float64, K=4,
                              jitter=jmodel.prior.jitter,
                              var_floor=jmodel.prior.var_floor)
    assert tmodel.gp_prior is tmodel.prior
    jmean, _ = j_latent_posterior(jmodel.prior, jnp.asarray(coords[vidx]))
    expect = _plugin_rate_deviance(jmodel.V_raw[vidx], [(jmodel.W_raw, jmean)],
                                   jnp.asarray(y[vidx].T))
    _close(posterior_deviance(tmodel, T(coords), T(y), T(vidx)), expect)


# --- configuration, conversion, import boundary --------------------------------

def test_config_build_picks_jax_inducing_points(data):
    coords, _, groups = data
    jcfg = gz.MGGPNSFConfig(D=D, N=N, L=L, M_per_group=M_PER, n_groups=G)
    jmodel = jcfg.build(jax.random.PRNGKey(0), X=jnp.asarray(coords),
                        groups=groups)
    cfg = gt.MGGPNSFConfig(D=D, N=N, L=L, M_per_group=M_PER, n_groups=G)
    model = cfg.build(torch.Generator().manual_seed(0), T(coords), T(groups))
    gp = model.gp
    np.testing.assert_array_equal(gp.Z.detach().numpy(), np.asarray(jmodel.gp.Z))
    np.testing.assert_array_equal(gp.groupsZ.numpy(), np.asarray(jmodel.gp.groupsZ))
    assert gp.groupsZ.dtype == torch.int64
    for name in ("sigma", "lengthscale", "group_diff_param"):
        _close(getattr(gp.kernel, name), getattr(jmodel.gp.kernel, name), 0)
    assert gp.mu.shape == (M,) and gp.Lu_raw.shape == (M, M)
    assert torch.equal(gp.mu.detach(), torch.zeros(M, dtype=torch.float64))
    assert (gp.jitter, gp.var_floor) == (jmodel.gp.jitter, jmodel.gp.var_floor)
    assert model.W_raw.shape == (D, L) and model.V_raw.shape == (N,)
    trained = {n for n, p in model.named_parameters() if p.requires_grad}
    assert trained == set(MGGP_PATHS) - {"gp.Z", "gp.groupsZ"}
    assert cfg.optimizer(model).defaults["lr"] == jcfg.lr
    assert cfg.M == jcfg.M


def test_mggp_round_trip_is_exact(models):
    jmodel = models["per_factor"]
    params = jax_leaves(jmodel)
    assert set(params) == set(MGGP_PATHS)
    back = to_numpy(_port(jmodel))
    assert set(back) == set(MGGP_PATHS)
    for path in MGGP_PATHS:
        np.testing.assert_array_equal(back[path], params[path])
    assert back["gp.groupsZ"].dtype == np.int64
    assert back["gp.kernel.embedding"].dtype == np.float64


def _port_sources():
    """Every module of the package (not the git-ignored kernel build
    directory, which is no package) and chip_smoke.py."""
    mods = [m.name for m in pkgutil.walk_packages(gt.__path__, "gpzoo_tpu_torch.")]
    files = [importlib.util.find_spec(m).origin for m in ["gpzoo_tpu_torch", *mods]]
    return sorted(os.path.relpath(f, REPO) for f in files) + ["chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources())
def test_port_source_imports_no_jax(path):
    """Every module of the port, and chip_smoke.py, imports neither JAX
    nor the JAX package (read from the source, imports inside functions
    included)."""
    with open(os.path.join(REPO, path)) as fh:
        tree = ast.parse(fh.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module and n.level == 0]
    bad = [n for n in names if n.split(".")[0] in
           ("jax", "jaxlib", "flax", "optax", "gpzoo_tpu")]
    assert not bad, f"{path} imports {bad}"
