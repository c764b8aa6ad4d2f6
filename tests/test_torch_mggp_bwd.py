"""Kernel 4's closed-form backward against the JAX package, on CPU.

``mggp_cuda.mggp_gram_bwd_plain`` is the CPU path of ``MGGPGram``'s
backward and the reference the backward kernel is held against on the
card. It must give JAX's gradients: ``jax.vjp`` of
``gram_pallas._mggp_gram_xla``, the function ``_mggp_gram_bwd``
differentiates, with the expanded, clamped d² and g² and ``jnp.maximum``'s
½ at a tie. Inputs are numpy arrays from a seed, in float64.
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpzoo_tpu as gz
from gpzoo_tpu.ops import gram_pallas
from gpzoo_tpu.train.fast import nsf_negative_elbo_batched as j_batched
from gpzoo_tpu.train.loop import _path_str, _value_and_grad

import gpzoo_tpu_torch as gt
from gpzoo_tpu_torch.convert import mggp_nsf_from_numpy
from gpzoo_tpu_torch.kernels import mggp as tmggp
from gpzoo_tpu_torch.ops import mggp_cuda

TOL = 1e-8
T = torch.tensor
NAMES = ("x", "z", "ex", "ez", "sigma", "lengthscale", "alpha_eff")


def _close(got, expect, rtol=TOL):
    """|got − expect| ≤ rtol · max|expect|."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    expect = np.asarray(expect)
    np.testing.assert_allclose(got, expect, rtol=0,
                               atol=rtol * max(np.max(np.abs(expect)), 1e-300))


def _operands(seed, n, m, l_dim, n_groups=4, e_dim=3, dim=2, kzz=False, grid=False):
    """x, z, ex, ez, σ, ℓ, α_eff. With ``grid`` the coordinates and the
    embedding are multiples of 1/4, so the expanded d² and g² of coincident
    points and same-group pairs are exactly 0: the clamps' ties."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (n, dim))
    emb = rng.standard_normal((n_groups, e_dim))
    if grid:
        x = np.round(x * 4) / 4
        emb = np.round(emb * 4) / 4
    ex = emb[rng.integers(0, n_groups, n)]
    z, ez = (x, ex) if kzz else (rng.uniform(-2, 2, (m, dim)),
                                 emb[rng.integers(0, n_groups, m)])
    if grid and not kzz:
        z = np.round(z * 4) / 4
    return [x, z, ex, ez, rng.uniform(0.5, 1.5, l_dim), rng.uniform(0.5, 2.0, l_dim),
            rng.uniform(0.2, 3.0, l_dim)]


def _jax_grads(ops, g, input_dim):
    out, vjp = jax.vjp(lambda *a: gram_pallas._mggp_gram_xla(*a, input_dim=input_dim),
                       *map(jnp.asarray, ops))
    return out, vjp(jnp.asarray(g))


def _cotangent(seed, ops):
    return np.random.default_rng(seed).standard_normal(
        (len(ops[4]), len(ops[0]), len(ops[1])))


CASES = {  # (n, m, L, groups, E, D, p)
    "small_p2": (40, 30, 3, 4, 3, 2, 2),
    "small_p3": (40, 30, 3, 4, 3, 2, 3),
    "ragged_L37_p3": (37, 29, 37, 5, 4, 2, 3),
    "ragged_n1": (1, 13, 2, 3, 2, 2, 2),
    "ragged_m1": (11, 1, 5, 3, 2, 2, 3),
    "wide_embedding": (23, 19, 4, 17, 17, 3, 2),
    "coordinates_d8": (17, 21, 2, 6, 5, 8, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_plain_matches_jax_vjp(case):
    """All seven gradients at 1e-8 against JAX's vjp."""
    n, m, l_dim, n_groups, e_dim, dim, p = CASES[case]
    ops = _operands(1, n, m, l_dim, n_groups, e_dim, dim)
    g = _cotangent(2, ops)
    _, expect = _jax_grads(ops, g, p)
    got = mggp_cuda.mggp_gram_bwd_plain(T(g), *map(T, ops), p)
    for name, a, b in zip(NAMES, got, expect):
        assert a.shape == b.shape, name
        _close(a, b)


SUBSETS = {
    "hyper": ("sigma", "lengthscale", "alpha_eff"),
    "embeddings": ("ex", "ez"),
    "coordinates": ("x", "z"),
    "all": NAMES,
    "sigma": ("sigma",),
    "ez": ("ez",),
    "x": ("x",),
}


@pytest.mark.parametrize("p", [2, 3])
@pytest.mark.parametrize("subset", sorted(SUBSETS))
def test_bwd_plain_subsets(subset, p):
    """Only the gradients asked for come back, each JAX's."""
    ops = _operands(3, 26, 18, 4)
    g = _cotangent(4, ops)
    _, expect = _jax_grads(ops, g, p)
    needs = tuple(name in SUBSETS[subset] for name in NAMES)
    got = mggp_cuda.mggp_gram_bwd_plain(T(g), *map(T, ops), p, needs)
    for name, need, a, b in zip(NAMES, needs, got, expect):
        if need:
            _close(a, b)
        else:
            assert a is None, name


@pytest.mark.parametrize("p", [2, 3])
@pytest.mark.parametrize("subset", sorted(SUBSETS))
def test_mggp_gram_autograd_subsets(subset, p):
    """MGGPGram on CPU tensors: the leaves that require a gradient get JAX's,
    the others none."""
    ops = _operands(5, 21, 16, 3)
    g = _cotangent(6, ops)
    _, expect = _jax_grads(ops, g, p)
    leaves = [T(v, requires_grad=name in SUBSETS[subset]) for name, v in zip(NAMES, ops)]
    mggp_cuda.mggp_gram(*leaves, p).backward(T(g))
    for name, t, b in zip(NAMES, leaves, expect):
        if t.requires_grad:
            _close(t.grad, b)
        else:
            assert t.grad is None, name


@pytest.mark.parametrize("p", [2, 3])
@pytest.mark.parametrize("grid", [False, True])
def test_kzz_with_ties_matches_jax(grid, p):
    """Kzz with x is z and ex is ez: coincident points and same-group pairs
    put the expanded d² and g² at the clamp, where JAX's gradient is ½ (on
    the grid exactly 0, so the ties are hit); autograd adds the x and z
    (ex and ez) gradients, as JAX's caller does."""
    ops = _operands(7, 30, 30, 4, n_groups=3, kzz=True, grid=grid)
    x, _, ex, _, *hyper = ops
    g = _cotangent(8, ops)
    _, expect = _jax_grads(ops, g, p)
    if grid:
        d2 = (np.sum(x * x, -1)[:, None] - 2 * x @ x.T + np.sum(x * x, -1)[None, :])
        g2 = (np.sum(ex * ex, -1)[:, None] - 2 * ex @ ex.T + np.sum(ex * ex, -1)[None, :])
        assert np.sum(d2 == 0) >= 30 and np.sum(g2 == 0) > 30 * 9
    got = mggp_cuda.mggp_gram_bwd_plain(T(g), *map(T, ops), p)
    for name, a, b in zip(NAMES, got, expect):
        _close(a, b)
    # through autograd with one leaf for x and z, one for ex and ez
    xt, ext = T(x, requires_grad=True), T(ex, requires_grad=True)
    ht = [T(v, requires_grad=True) for v in hyper]
    mggp_cuda.mggp_gram(xt, xt, ext, ext, *ht, p).backward(T(g))
    _close(xt.grad, expect[0] + expect[1])
    _close(ext.grad, expect[2] + expect[3])
    for t, b in zip(ht, expect[4:]):
        _close(t.grad, b)


def test_mggp_gram_cpu_takes_closed_form():
    """On CPU tensors MGGPGram's backward is mggp_gram_bwd_plain (no
    autograd graph of the plain form is built, no launch counted), and it
    meets autograd of mggp_gram_plain."""
    ops = _operands(9, 19, 23, 5)
    g = T(_cotangent(10, ops))
    leaves = [T(v, requires_grad=True) for v in ops]
    ref = [T(v, requires_grad=True) for v in ops]
    calls = []
    real = mggp_cuda.mggp_gram_bwd_plain

    def spy(*args, **kw):
        calls.append(torch.is_grad_enabled())
        return real(*args, **kw)

    before = (mggp_cuda.mggp_gram_fwd.launches, mggp_cuda.mggp_gram_bwd.launches)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mggp_cuda, "mggp_gram_bwd_plain", spy)
        mggp_cuda.mggp_gram(*leaves, 2).backward(g)
    assert calls == [False]
    assert (mggp_cuda.mggp_gram_fwd.launches, mggp_cuda.mggp_gram_bwd.launches) == before
    mggp_cuda.mggp_gram_plain(*ref, 2).backward(g)
    for name, a, b in zip(NAMES, leaves, ref):
        _close(a.grad, b.grad.numpy(), 1e-12)


def test_grads_from_planes_matches_plain():
    """The kernel route's finish (the thin products from dd², dg² and the
    (3, L) sums) on planes formed in float64 gives the closed form's
    gradients; a plane not written gives no gradient."""
    ops = [T(v) for v in _operands(11, 14, 12, 3)]
    x, z, ex, ez, sigma, ell, alpha = ops
    g = T(_cotangent(12, ops))
    half_p = 1.0
    d2 = torch.cdist(x, z) ** 2
    g2 = torch.cdist(ex, ez) ** 2
    c = (-0.5 / ell ** 2)[:, None, None]
    den = alpha[:, None, None] * g2 + 1
    u = d2 / den
    e = torch.exp(c * u) / den
    t = g * sigma[:, None, None] ** 2 * e
    q = t / den * (-c * u - half_p)
    hyper = torch.stack([2 * sigma * (g * e).sum((1, 2)),
                         (t * u).sum((1, 2)) / ell ** 3, (q * g2).sum((1, 2))])
    dd2 = (t * c / den).sum(0)
    dg2 = (q * alpha[:, None, None]).sum(0)
    want = mggp_cuda.mggp_gram_bwd_plain(g, *ops, 2)
    got = mggp_cuda.grads_from_planes(x, z, ex, ez, dd2, dg2, hyper, (True,) * 7)
    for name, a, b in zip(NAMES, got, want):
        _close(a, b.numpy(), 1e-12)
    got = mggp_cuda.grads_from_planes(x, z, ex, ez, dd2, None, None,
                                      (True, False) + (False,) * 5)
    assert got[1:] == (None,) * 6
    _close(got[0], want[0].numpy(), 1e-12)


def test_mggp_gram_bwd_wrapper_contract():
    """CPU tensors take the closed form without counting a launch; a
    cotangent of the wrong shape, or tensors on a device with no kernel,
    raise."""
    ops = [T(v, dtype=torch.float32) for v in _operands(13, 9, 7, 2)]
    g = torch.ones((2, 9, 7))
    before = mggp_cuda.mggp_gram_bwd.launches
    got = mggp_cuda.mggp_gram_bwd(g, *ops, 2)
    assert mggp_cuda.mggp_gram_bwd.launches == before
    assert [t.shape for t in got] == [t.shape for t in ops]
    with pytest.raises(ValueError):
        mggp_cuda.mggp_gram_bwd(g[:, :-1], *ops, 2)
    with pytest.raises(ValueError):
        mggp_cuda.mggp_gram_bwd(g.to("meta"), *[t.to("meta") for t in ops], 2)


KERNELS = {"MGGPRBF": ((), "RAW"),
           "MGGPNSFRBF": ((3, 1, 1), "SQUARED"),
           "BatchedMGGPRBF": ((), "ABS")}


@pytest.mark.parametrize("p", [2, 3])
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_conventions_through_mggp_math(name, p):
    """Each GroupDiffConvention through MGGPMath.gram: every leaf's gradient
    (σ, ℓ, the raw α, the embedding) of Σ g·K against jax.grad of the JAX
    kernel's gram, negative raw α included."""
    shape, convention = KERNELS[name]
    rng = np.random.default_rng(14)
    x, z = rng.uniform(-2, 2, (27, 2)), rng.uniform(-2, 2, (19, 2))
    gx, gz_ = rng.integers(0, 5, 27), rng.integers(0, 5, 19)
    hp = {k: rng.uniform(0.5, 1.5, shape) * s for k, s in
          (("sigma", 1), ("lengthscale", 1), ("group_diff_param", -1))}
    jk = getattr(gz.kernels, name).create(n_groups=5, input_dim=p).replace(
        **{k: jnp.asarray(v) for k, v in hp.items()})
    tk = getattr(tmggp, name)(*(T(hp[k]) for k in hp), T(np.asarray(jk.embedding)),
                              input_dim=p)
    assert tk.convention.name == convention
    cot = rng.standard_normal((3, 27, 19) if shape else (27, 19))

    def j_loss(k):
        return jnp.sum(jnp.asarray(cot) * k.gram(jnp.asarray(x), jnp.asarray(z),
                                                 jnp.asarray(gx), jnp.asarray(gz_)))

    jgrad = jax.grad(j_loss)(jk)
    (T(cot) * tk.gram(T(x), T(z), T(gx), T(gz_))).sum().backward()
    for leaf in ("sigma", "lengthscale", "group_diff_param", "embedding"):
        _close(getattr(tk, leaf).grad, getattr(jgrad, leaf))


# --- the MGGP blockwise loss, whose kernels train through the backward ------

N, D, L, G, M_PER, B, MB = 240, 12, 3, 3, 7, 48, 24


@functools.cache
def _loss_setup():
    rng = np.random.default_rng(15)
    coords = rng.uniform(-2, 2, (N, 2))
    y = rng.poisson(3.0, (N, D)).astype(np.float64)
    groups = rng.integers(0, G, N)
    cfg = gz.MGGPNSFConfig(D=D, N=N, L=L, M_per_group=M_PER, n_groups=G, batch_size=B)
    model = cfg.build(jax.random.PRNGKey(1), X=jnp.asarray(coords), groups=groups)
    kernel = model.gp.kernel.replace(
        sigma=jnp.asarray(rng.uniform(0.8, 1.3, (L, 1, 1))),
        lengthscale=jnp.asarray(rng.uniform(1.0, 2.0, (L, 1, 1))),
        group_diff_param=jnp.asarray(rng.uniform(1.5, 2.5, (L, 1, 1))))
    m = M_PER * G
    model = model.replace(gp=model.gp.replace(
        kernel=kernel, mu=jnp.asarray(0.3 * rng.standard_normal((L, m))),
        Lu_raw=jnp.asarray(0.2 * rng.standard_normal((L, m, m)))))
    k_idx, k_eps = jax.random.split(jax.random.PRNGKey(16))
    idx = jax.random.choice(k_idx, N, (B,), replace=False)
    return coords, y, groups, model, idx, k_eps


@pytest.mark.parametrize("remat", [False, True])
def test_mggp_blockwise_loss_gradients_match_jax(remat):
    """The MGGP W-form loss in two chunks: every leaf's gradient (Z, σ, ℓ,
    α and the embedding, all through kernel 4's backward, Kzz and Kzx) at
    1e-8 against JAX's loss on the same idx and eps."""
    coords, y, groups, jmodel, idx, key = _loss_setup()
    eps = jax.random.normal(key, (1, L, B), dtype=jnp.float64)
    kw = dict(E=1, microbatch=MB, factored=True, y_transposed=True)
    jval, jgrad = jax.jit(lambda m: _value_and_grad(lambda m_: j_batched(
        m_, jnp.asarray(coords), jnp.asarray(y), idx, key, groups=jnp.asarray(groups),
        remat=remat, **kw), m))(jmodel)
    leaves = {_path_str(p): np.asarray(v)
              for p, v in jax.tree_util.tree_flatten_with_path(jmodel)[0]}
    gp = jmodel.gp
    tmodel = mggp_nsf_from_numpy(leaves, "cpu", torch.float64, jitter=gp.jitter,
                                 var_floor=gp.var_floor)
    tval = gt.nsf_negative_elbo_batched(
        tmodel, T(coords), T(y), T(np.asarray(idx)), T(np.asarray(eps)), remat=remat,
        groups=T(groups), **kw)
    tval.backward()
    _close(tval, jval)
    jg = {_path_str(p): np.asarray(v)
          for p, v in jax.tree_util.tree_flatten_with_path(jgrad)[0]}
    seen = set()
    for path, p in tmodel.named_parameters():
        _close(p.grad, jg[path])
        seen.add(path)
    assert {"gp.Z", "gp.kernel.sigma", "gp.kernel.lengthscale",
            "gp.kernel.group_diff_param", "gp.kernel.embedding"} <= seen


def test_every_subset_of_seven_flags():
    """All 127 non-empty subsets of the seven flags on one input: each
    returned gradient is the full call's, bit for bit, and only those."""
    ops = [T(v) for v in _operands(17, 8, 6, 2)]
    g = T(_cotangent(18, ops))
    full = mggp_cuda.mggp_gram_bwd_plain(g, *ops, 3)
    for needs in itertools.product((False, True), repeat=7):
        if not any(needs):
            continue
        got = mggp_cuda.mggp_gram_bwd_plain(g, *ops, 3, needs)
        for need, a, b in zip(needs, got, full):
            assert (a is None) if not need else torch.equal(a, b)
