"""The blockwise loss's dispatch policy and precision knobs against the JAX
package, on CPU: ``resolve_policy`` over a grid of configurations and
overrides, ``cholesky_inverse_mm`` with its panel-blocked backward, the
precision-carrying triangular inverse, and ``nsf_negative_elbo_batched``
under every remat policy and both backward precisions (float64, same idx
and draws, at 1e-8). A spy records the mode in force at every governed
product, in the forward, the backward and the remat recompute (float32),
and must find each product at its knob's string.

On float64 and CPU tensors no mode changes a number, so the float64
comparisons hold whatever the knobs; what the modes do to a number is
measured on the card (``chip_smoke.py`` [mggp] and [hybrid_mggp]).
"""

import collections
import dataclasses
import importlib
import itertools
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpzoo_tpu as gz
from gpzoo_tpu.ops import linalg as jlinalg
from gpzoo_tpu.train import policy as jpolicy
from gpzoo_tpu.train.fast import nsf_negative_elbo_batched as j_batched
from gpzoo_tpu.train.loop import _path_str, _value_and_grad

import gpzoo_tpu_torch as gt
from gpzoo_tpu_torch.convert import mggp_nsf_from_numpy, nsf_from_numpy
from gpzoo_tpu_torch.ops import linalg, precision
from gpzoo_tpu_torch.train import policy

N, D, L, G, M_PER, B, MB, E = 120, 10, 3, 3, 8, 40, 20, 2
M = G * M_PER
TOL = 1e-8
T = torch.tensor
REMATS = (True, False, None, "save_proj", "save_proj_kzx")


def jax_leaves(model):
    return {_path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(model)[0]}


def _close(got, expect, rtol=TOL):
    """Max-normalized comparison: |got − expect| ≤ rtol · max|expect|."""
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    expect = np.asarray(expect)
    np.testing.assert_allclose(got, expect, rtol=0,
                               atol=rtol * max(np.max(np.abs(expect)), 1e-300))


# --- resolve_policy ----------------------------------------------------------

JITTERS = (1e-4, 1e-3, 9.99e-3, 1e-2, 1e-1)
KNOB_VALUES = (None, "default", "high", "highest")


@pytest.mark.parametrize("jitter", JITTERS)
def test_resolve_policy_matches_jax(jitter):
    """Every field of the resolved policy, over whitened × factored ×
    per_factor_chol, every stable_projection, precision and remat value."""
    for flags in itertools.product((False, True), repeat=3):
        for stable, grad, proj, chol, remat in itertools.product(
                (None, False, True), KNOB_VALUES, KNOB_VALUES, KNOB_VALUES, REMATS):
            kw = dict(whitened=flags[0], factored=flags[1], per_factor_chol=flags[2],
                      stable_projection=stable, grad_precision=grad,
                      proj_precision=proj, chol_precision=chol, remat=remat)
            got = dataclasses.asdict(policy.resolve_policy(jitter, **kw))
            assert got == dataclasses.asdict(jpolicy.resolve_policy(jitter, **kw)), kw


@pytest.mark.parametrize("bad", [
    dict(remat="save_porj"), dict(remat=""), dict(remat="True"), dict(remat="proj_a"),
    dict(grad_precision="hgh"), dict(proj_precision=""),
    dict(chol_precision="HIGHEST"), dict(grad_precision="float32")])
def test_resolve_policy_raises_where_jax_raises(bad):
    kw = dict(whitened=False, factored=True, per_factor_chol=True, **bad)
    with pytest.raises(ValueError, match=next(iter(bad))):
        jpolicy.resolve_policy(1e-1, **kw)
    with pytest.raises(ValueError, match=next(iter(bad))):
        policy.resolve_policy(1e-1, **kw)


def test_policy_constants_match_jax():
    assert policy.REMAT_POLICIES == jpolicy.REMAT_POLICIES
    assert policy.PRECISIONS == jpolicy.PRECISIONS == precision.PRECISIONS
    assert policy.WELL_JITTERED == jpolicy.WELL_JITTERED
    assert set(precision.MODES) == set(precision.PRECISIONS)
    train = importlib.import_module("gpzoo_tpu_torch.train")  # gt.train is the loop
    assert train.fast.WELL_JITTERED is policy.WELL_JITTERED
    for name in ("FastPathPolicy", "resolve_policy", "REMAT_POLICIES", "PRECISIONS"):
        assert getattr(gt, name) is getattr(train, name) is getattr(policy, name)


# The nine cases of the JAX package's own table test (tests/test_policy.py).

def test_well_jittered_w_form_defaults():
    p = policy.resolve_policy(1e-1, whitened=False, factored=True, per_factor_chol=True)
    assert p.w_form and not p.bwd_blocked and not p.stable_projection
    assert (p.grad_precision, p.proj_precision, p.chol_precision) == (
        "default", "high", "high")


def test_small_jitter_gates_to_highest_and_stable():
    p = policy.resolve_policy(1e-4, whitened=False, factored=True, per_factor_chol=True)
    assert (p.grad_precision, p.proj_precision, p.chol_precision) == ("highest",) * 3
    assert p.bwd_blocked and p.stable_projection


def test_whitened_is_always_stable_and_never_w_form():
    for jitter in (1e-1, 1e-4):
        p = policy.resolve_policy(jitter, whitened=True, factored=True,
                                  per_factor_chol=True)
        assert not p.w_form and p.stable_projection


def test_shared_chol_never_w_form():
    p = policy.resolve_policy(1e-1, whitened=False, factored=True, per_factor_chol=False)
    assert not p.w_form and not p.stable_projection


def test_explicit_overrides_pass_through():
    p = policy.resolve_policy(1e-1, whitened=False, factored=True, per_factor_chol=True,
                              stable_projection=True, grad_precision="highest",
                              proj_precision="highest", chol_precision="high",
                              remat="save_proj")
    assert p.stable_projection and p.bwd_blocked and p.remat == "save_proj"
    assert (p.grad_precision, p.proj_precision, p.chol_precision) == (
        "highest", "highest", "high")


def test_remat_typo_rejected():
    with pytest.raises(ValueError, match="remat"):
        policy.resolve_policy(1e-1, whitened=False, factored=True, per_factor_chol=True,
                              remat="save_porj")


def test_chol_precision_auto_is_wform_scoped():
    assert policy.resolve_policy(1e-1, whitened=False, factored=True,
                                 per_factor_chol=False).chol_precision == "highest"
    assert policy.resolve_policy(1e-1, whitened=True, factored=True,
                                 per_factor_chol=True).chol_precision == "highest"


def test_remat_none_means_no_remat():
    p = policy.resolve_policy(1e-1, whitened=False, factored=True, per_factor_chol=True,
                              remat=None)
    assert p.remat is False


@pytest.mark.parametrize("remat", policy.REMAT_POLICIES)
def test_wrap_remat_keeps_what_the_policy_says(remat, monkeypatch):
    """A chunk body with a Gram and a kept product under each policy: the
    value and the gradients are those of the plain body, and the Gram and
    the product run as often as the policy says (once each in the forward;
    in the backward the Gram again unless the policy keeps Kzx, the product
    again only under full remat)."""
    counts = {"gram": 0, "product": 0}
    product = precision._product

    def counted(a, b):
        counts["product"] += 1
        return product(a, b)

    monkeypatch.setattr(precision, "_product", counted)
    rng = np.random.default_rng(0)
    z = T(rng.standard_normal((5, 3)), requires_grad=True)
    x = T(rng.standard_normal((7, 3)))
    w = T(np.tril(rng.standard_normal((5, 5))), requires_grad=True)

    def gram_fn(x_):
        counts["gram"] += 1
        return torch.exp(-torch.cdist(z, x_) ** 2)

    def chunk(x_, kzx=None, keep=None):
        kzx = gram_fn(x_) if kzx is None else kzx
        a = precision.matmul(w, kzx, "highest", keep)
        return torch.sum(torch.square(a) * kzx)

    pol = dataclasses.replace(
        policy.resolve_policy(1e-1, whitened=False, factored=True, per_factor_chol=True),
        remat=remat)
    value = pol.wrap_remat(chunk, gram_fn)(x)
    forward = dict(counts)
    value.backward()
    after = dict(counts)
    grads = (z.grad.clone(), w.grad.clone())
    z.grad = w.grad = None
    expect = chunk(x)
    expect.backward()
    _close(value, expect.detach(), 1e-15)
    _close(grads[0], z.grad, 1e-15)
    _close(grads[1], w.grad, 1e-15)
    assert forward == {"gram": 1, "product": 1}
    recompute = {"gram": remat in (True, "save_proj"), "product": remat is True}
    # the product's backward makes 2 more products
    assert after["gram"] - forward["gram"] == recompute["gram"]
    assert after["product"] - forward["product"] == 2 + recompute["product"]


# --- the modes ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_no_mode_changes_a_cpu_product(dtype):
    rng = np.random.default_rng(1)
    a = T(rng.standard_normal((2, 6, 5)), dtype=dtype)
    b = T(rng.standard_normal((5, 4)), dtype=dtype)
    for p in precision.PRECISIONS:
        assert torch.equal(precision.mm(a, b, p), torch.matmul(a, b))
    assert precision.in_force() is None


def test_flags_and_modes_restored_on_exception():
    """The TF32 switch is process-wide: a mode restores it (and the mode
    stack) when its product raises."""
    flags = torch.backends.cuda.matmul
    before = flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction
    with pytest.raises(RuntimeError):
        with precision._cublas(not before[0]):
            assert flags.allow_tf32 is (not before[0])
            raise RuntimeError("a product failed")
    assert (flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction) == before
    with pytest.raises(RuntimeError):
        precision.mm(torch.ones(2, 2), torch.ones(3, 3), "high")  # shape error
    assert precision.in_force() is None
    with pytest.raises(ValueError, match="precision"):
        precision.mm(torch.ones(2, 2), torch.ones(2, 2), "hgh")


def test_bf16_product_rounds_the_operands_only(monkeypatch):
    """The "default" product on the card: bf16 operands, float32
    accumulation and result (here its rounded path, the one a CPU tensor
    can run), broadcast over the batch as torch.matmul."""
    monkeypatch.setattr(precision, "bf16_path", lambda: "rounded")
    rng = np.random.default_rng(2)
    a = T(rng.standard_normal((3, 8, 16)), dtype=torch.float32)
    b = T(rng.standard_normal((16, 5)), dtype=torch.float32)
    got = precision._bf16(a, b)
    expect = a.bfloat16().double() @ b.bfloat16().double()
    assert got.dtype == torch.float32 and got.shape == (3, 8, 5)
    _close(got, expect, 2 ** -7)
    assert float((got.double() - a.double() @ b.double()).abs().max()) > 1e-4


# --- the linear algebra ------------------------------------------------------

def _spd(rng, lead, m):
    a = rng.standard_normal(lead + (m, m))
    return a @ np.swapaxes(a, -1, -2) / m + np.eye(m)


@pytest.mark.parametrize("p", precision.PRECISIONS)
def test_tri_inverse_and_spd_inverse_take_precision(p):
    lz = np.linalg.cholesky(_spd(np.random.default_rng(5), (2,), 300))
    _close(linalg.tri_inverse(T(lz), 64, precision=p),
           jlinalg.tri_inverse(jnp.asarray(lz), 64, precision=p), 1e-10)
    _close(linalg.spd_inverse_from_cholesky(T(lz), precision=p),
           jlinalg.spd_inverse_from_cholesky(jnp.asarray(lz), precision=p), 1e-10)
    _close(linalg.spd_inverse_from_cholesky(T(lz), 64, precision=p),
           jlinalg.spd_inverse_from_cholesky(jnp.asarray(lz), 64, precision=p), 1e-10)


CHOL_M = 1100  # not a multiple of the 512 block


@pytest.fixture(scope="module")
def chol_case():
    rng = np.random.default_rng(6)
    k = _spd(rng, (2,), CHOL_M)
    gl = np.tril(rng.standard_normal((2, CHOL_M, CHOL_M)))
    gw = np.tril(rng.standard_normal((2, CHOL_M, CHOL_M)))
    return k, gl, gw


def _port_chol_grad(k, gl, gw, **kw):
    kt = T(k, requires_grad=True)
    lz, w = linalg.cholesky_inverse_mm(kt, **kw)
    torch.sum(T(gl) * lz + T(gw) * w).backward()
    return lz, w, kt.grad


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("fwd", ["highest", "high"])
def test_cholesky_inverse_mm_matches_jax(chol_case, blocked, fwd):
    """Values and the gradient of a linear functional of (L, W), against
    JAX's ``cholesky_inverse_mm`` with the same arguments, at 1e-10."""
    k, gl, gw = chol_case
    args = ("highest", blocked, fwd)

    def f(a):
        lz, w = jlinalg.cholesky_inverse_mm(a, *args)
        return jnp.sum(jnp.asarray(gl) * lz + jnp.asarray(gw) * w), (lz, w)

    (_, (jl, jw)), jgrad = jax.value_and_grad(f, has_aux=True)(jnp.asarray(k))
    lz, w, grad = _port_chol_grad(k, gl, gw, bwd_precision="highest",
                                  bwd_blocked=blocked, fwd_precision=fwd)
    _close(lz, jl, 1e-10)
    _close(w, jw, 1e-10)
    _close(grad, jgrad, 1e-10)


def test_cholesky_inverse_mm_blocked_backward_equals_dense(chol_case):
    k, gl, gw = chol_case
    dense = _port_chol_grad(k, gl, gw, bwd_blocked=False)[2]
    blocked = _port_chol_grad(k, gl, gw, bwd_blocked=True)[2]
    _close(blocked, dense, 1e-11)
    with pytest.raises(ValueError, match="bwd_precision"):
        linalg.cholesky_inverse_mm(T(k), bwd_precision="bf16")


@pytest.mark.parametrize("m_dim", [40, 1100])
def test_tri_matmuls_take_precision_and_match_jax(m_dim):
    """``tri_matmul`` and ``tri_tri_matmul`` with a precision (one panel
    below 1,024, six above), values and gradients against JAX's."""
    from gpzoo_tpu.ops import tri_blocked as jtri

    from gpzoo_tpu_torch.ops import tri_blocked

    rng = np.random.default_rng(m_dim)
    w = np.tril(rng.standard_normal((2, m_dim, m_dim))) / m_dim
    lu = np.tril(rng.standard_normal((1, m_dim, m_dim)))
    rhs = rng.standard_normal((2, m_dim, 9))
    g_a, g_c = rng.standard_normal((2, m_dim, 9)), rng.standard_normal((2, m_dim, m_dim))

    def jf(w_, lu_, rhs_):
        with jax.default_matmul_precision("high"):
            return (jnp.sum(jtri.tri_matmul(w_, rhs_) * g_a)
                    + jnp.sum(jtri.tri_tri_matmul(w_, lu_) * g_c))

    jgrads = jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (w, lu, rhs)))
    ts = [T(v, requires_grad=True) for v in (w, lu, rhs)]
    a = tri_blocked.tri_matmul(ts[0], ts[2], "high")
    c = tri_blocked.tri_tri_matmul(ts[0], ts[1], "high")
    _close(a, jtri.tri_matmul(jnp.asarray(w), jnp.asarray(rhs)), 1e-12)
    _close(c, jtri.tri_tri_matmul(jnp.asarray(w), jnp.asarray(lu)), 1e-12)
    (torch.sum(a * T(g_a)) + torch.sum(c * T(g_c))).backward()
    for t, jg in zip(ts, jgrads):
        _close(t.grad, jg, 1e-12)


# --- the blockwise loss under the policy --------------------------------------

@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    coords = rng.uniform(-2, 2, (N, 2))
    counts_t = rng.poisson(3.0, (N, D)).astype(np.float64)  # spot-major
    groups = rng.integers(0, G, N)
    return coords, counts_t, groups


#: case: (prior, kernel, jitter, loss options)
CASES = {
    "mggp_w_form": ("mggp", "per_factor", 1e-1, {}),
    "rbf_w_form": ("svgp", "per_factor", 1e-1, {}),
    "shared_chol_stable": ("svgp", "scalar", 1e-1,
                           dict(stable_projection=True, chol_precision="high")),
}


def _jmodel(case, coords, groups):
    """The JAX model of a case, per-factor μ (L, M) and Lu (L, M, M)."""
    prior, kind, jitter, _ = CASES[case]
    rng = np.random.default_rng(zlib.crc32(case.encode()))

    def per(lo, hi):
        return jnp.asarray(rng.uniform(lo, hi, (L, 1, 1)))

    fields = dict(mu=jnp.asarray(0.5 * rng.standard_normal((L, M))),
                  Lu_raw=jnp.asarray(np.tril(0.2 * rng.standard_normal((L, M, M)))),
                  jitter=jitter)
    if prior == "mggp":
        k = gz.kernels.MGGPNSFRBF.create(sigma=1.1, lengthscale=1.3,
                                         group_diff_param=0.7, n_groups=G, L=L)
        k = k.replace(sigma=per(0.8, 1.3), lengthscale=per(1.0, 2.0),
                      group_diff_param=per(0.5, 1.5))
        take = rng.choice(N, M, replace=False)
        gp = gz.gps.MGGPSVGP(kernel=k, Z=jnp.asarray(coords[take]),
                             groupsZ=jnp.asarray(groups[take]), **fields)
    else:
        k = gz.kernels.NSFRBF.create(L=L, sigma=1.1, lengthscale=0.9)
        k = (k.replace(sigma=per(0.8, 1.3), lengthscale=per(0.7, 1.2))
             if kind == "per_factor"
             else k.replace(sigma=jnp.asarray(1.1), lengthscale=jnp.asarray(0.9)))
        gp = gz.gps.SVGP(kernel=k, Z=jnp.asarray(rng.uniform(-2, 2, (M, 2))), **fields)
    w_raw = jnp.asarray(rng.uniform(0, 1, (D, L)))
    v_raw = jnp.asarray(rng.normal(1.0, 0.2, N))
    if prior == "mggp":
        return gz.models.MGGPNSF(gp=gp, W_raw=w_raw, V_raw=v_raw)
    return gz.models.NSF(prior=gp, W_raw=w_raw, V_raw=v_raw)


def _port(case, jmodel, dtype=torch.float64):
    prior, _, jitter, _ = CASES[case]
    if prior == "mggp":
        return mggp_nsf_from_numpy(jax_leaves(jmodel), "cpu", dtype, jitter=jitter,
                                   var_floor=jmodel.gp.var_floor)
    return nsf_from_numpy(jax_leaves(jmodel), "cpu", dtype, jitter=jitter,
                          var_floor=jmodel.prior.var_floor)


def _batch(case):
    k_idx, key = jax.random.split(jax.random.PRNGKey(zlib.crc32(case.encode()) % 997))
    idx = jax.random.choice(k_idx, N, (B,), replace=False)
    eps = np.asarray(jax.random.normal(key, (E, L, B), dtype=jnp.float64))
    return idx, key, eps


def _kwargs(case, data, remat, grad, torch_side):
    coords, _, groups = data
    kw = dict(E=E, microbatch=MB, factored=True, y_transposed=True, remat=remat,
              grad_precision=grad, **CASES[case][3])
    if CASES[case][0] == "mggp":
        kw["groups"] = T(groups) if torch_side else jnp.asarray(groups)
    return kw


def _port_loss_grads(case, data, tmodel, remat, grad):
    coords, y, _ = data
    idx, _, eps = _batch(case)
    tmodel.zero_grad(set_to_none=True)
    val = gt.nsf_negative_elbo_batched(tmodel, T(coords), T(y), T(np.asarray(idx)),
                                       T(eps), **_kwargs(case, data, remat, grad, True))
    val.backward()
    return val.detach(), {p_: t.grad.clone() for p_, t in tmodel.named_parameters()
                          if t.grad is not None}


@pytest.fixture(scope="module")
def jmodels(data):
    coords, _, groups = data
    return {case: _jmodel(case, coords, groups) for case in CASES}


@pytest.mark.parametrize("grad", ["default", "highest"])
@pytest.mark.parametrize("remat", REMATS, ids=str)
@pytest.mark.parametrize("case", sorted(CASES))
def test_blockwise_loss_under_policy_matches_jax(data, jmodels, case, remat, grad):
    """The loss and every leaf's gradient against JAX's loss with the same
    knobs (JAX's remat and precision change no float64 number either)."""
    coords, y, _ = data
    jmodel = jmodels[case]
    idx, key, _ = _batch(case)
    jkw = _kwargs(case, data, remat, grad, False)
    jval, jgrad = _value_and_grad(lambda m: j_batched(
        m, jnp.asarray(coords), jnp.asarray(y), idx, key, **jkw), jmodel)
    tval, tgrads = _port_loss_grads(case, data, _port(case, jmodel), remat, grad)
    _close(tval, jval)
    jg = jax_leaves(jgrad)
    assert len(tgrads) >= 5
    for path, g in tgrads.items():
        _close(g, jg[path])


@pytest.mark.parametrize("grad", ["default", "highest"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_remat_policies_agree(data, jmodels, case, grad):
    """The five remat values give one loss and one gradient, at 1e-12."""
    tmodel = _port(case, jmodels[case])
    base_val, base = _port_loss_grads(case, data, tmodel, False, grad)
    for remat in REMATS:
        val, grads = _port_loss_grads(case, data, tmodel, remat, grad)
        _close(val, base_val, 1e-12)
        assert set(grads) == set(base)
        for path, g in grads.items():
            _close(g, base[path], 1e-12)


# --- the spy: the mode in force at every governed product ----------------------

SPY_G, SPY_MPER, SPY_L = 3, 180, 2  # M = 540 > 512: W = Lzz⁻¹ takes the recursion


def _site(frames, a, b):
    """Which knob governs a product, from the code it runs in: the
    Cholesky-and-inverse backward ("grad"), a = W·Kzx or C = W·Lu ("proj"),
    the products that build W or K⁻¹ ("chol"), or the mean's products and
    the stable branch's a, ã and the library Cholesky's backward, which
    stay at "highest" ("pinned")."""
    quals = [f.f_code.co_qualname for f in frames]
    if 1 in tuple(a.shape[-2:]) + tuple(b.shape[-2:]):
        return "pinned"  # matrix-vector: the mean's products
    if any(q.startswith("CholeskyInverse.backward") for q in quals):
        return "grad"
    if any(q.startswith("CholeskyMM.") for q in quals):
        return "pinned"
    if any(q.startswith(("TriMatmul.", "TriTriMatmul.")) for q in quals):
        return "proj"
    if any(q.startswith(("tri_inverse", "spd_inverse_from_cholesky",
                         "CholeskyInverse.forward")) for q in quals):
        return "chol"
    caller = next(q for q in quals if q.startswith("nsf_negative_elbo_batched"))
    return "chol" if caller == "nsf_negative_elbo_batched" else "pinned"  # K⁻¹ = WᵀW


class Spy:
    """Records (phase, role, site, precision) at every governed product."""

    def __init__(self):
        self.phase = "forward"
        self.records = []
        self.sites = {}  # id(ctx) of a differentiable product → its site

    def __call__(self, a, b):
        frames, f = [], sys._getframe(1)
        while f is not None:
            frames.append(f)
            f = f.f_back
        p, role = precision.in_force()
        ctx_frame = next((f for f in frames
                          if f.f_code.co_qualname in ("_Product.forward",
                                                      "_Product.backward")), None)
        if ctx_frame is not None and role == "backward":
            site = self.sites[id(ctx_frame.f_locals["ctx"])]
        else:
            site = _site(frames, a, b)
            if ctx_frame is not None:
                self.sites[id(ctx_frame.f_locals["ctx"])] = site
        self.records.append((self.phase, role, site, p))
        return torch.matmul(a, b)

def _spy_model(kind):
    """A float32 model on the CPU: the MGGP W-form (M = 540) or the shared
    Cholesky's stable branch (M = 540, σ and ℓ trained)."""
    rng = np.random.default_rng(9)
    m = SPY_G * SPY_MPER
    coords = rng.uniform(-2, 2, (N, 2))
    groups = rng.integers(0, SPY_G, N)
    if kind == "w_form":
        k = gz.kernels.MGGPNSFRBF.create(sigma=1.1, lengthscale=1.3, group_diff_param=0.7,
                                         n_groups=SPY_G, L=SPY_L)
        k = k.replace(sigma=jnp.asarray(rng.uniform(0.8, 1.3, (SPY_L, 1, 1))))
        take = rng.choice(N, m, replace=True)
        gp = gz.gps.MGGPSVGP(kernel=k, Z=jnp.asarray(coords[take] + 1e-3 * np.arange(m)[:, None]),
                             groupsZ=jnp.asarray(groups[take]),
                             mu=jnp.asarray(0.3 * rng.standard_normal((SPY_L, m))),
                             Lu_raw=jnp.asarray(np.tril(0.05 * rng.standard_normal(
                                 (SPY_L, m, m)))), jitter=1e-1)
        jmodel = gz.models.MGGPNSF(gp=gp, W_raw=jnp.asarray(rng.uniform(0, 1, (D, SPY_L))),
                                   V_raw=jnp.asarray(rng.normal(1.0, 0.2, N)))
        tmodel = mggp_nsf_from_numpy(jax_leaves(jmodel), "cpu", torch.float32, jitter=1e-1)
    else:
        k = gz.kernels.NSFRBF.create(L=SPY_L, sigma=1.1, lengthscale=0.9)
        k = k.replace(sigma=jnp.asarray(1.1), lengthscale=jnp.asarray(0.9))
        gp = gz.gps.SVGP(kernel=k, Z=jnp.asarray(rng.uniform(-2, 2, (m, 2))),
                         mu=jnp.asarray(0.3 * rng.standard_normal((SPY_L, m))),
                         Lu_raw=jnp.asarray(np.tril(0.05 * rng.standard_normal(
                             (SPY_L, m, m)))), jitter=1e-1)
        jmodel = gz.models.NSF(prior=gp, W_raw=jnp.asarray(rng.uniform(0, 1, (D, SPY_L))),
                               V_raw=jnp.asarray(rng.normal(1.0, 0.2, N)))
        tmodel = nsf_from_numpy(jax_leaves(jmodel), "cpu", torch.float32, jitter=1e-1)
    y = rng.poisson(3.0, (N, D)).astype(np.float32)
    return tmodel, T(coords, dtype=torch.float32), T(y), T(groups)


SPY_POLICIES = [dict(grad_precision="default", proj_precision="high", chol_precision="high"),
                dict(grad_precision="high", proj_precision="default",
                     chol_precision="default")]


@pytest.mark.parametrize("remat", policy.REMAT_POLICIES, ids=str)
@pytest.mark.parametrize("knobs", range(len(SPY_POLICIES)))
def test_spy_mode_at_every_governed_product(monkeypatch, remat, knobs):
    """The MGGP W-form in float32: every governed product runs at its knob's
    string in the forward, the backward and the recompute; a = W·Kzx is
    recomputed (at proj_precision) under full remat only."""
    spy = Spy()
    monkeypatch.setattr(precision, "_product", spy)
    tmodel, x, y, groups = _spy_model("w_form")
    knob = SPY_POLICIES[knobs]
    loss = gt.nsf_negative_elbo_batched(
        tmodel, x, y, torch.arange(B), torch.randn((1, SPY_L, B), generator=torch.Generator(
        ).manual_seed(0)), microbatch=MB, factored=True, y_transposed=True, groups=groups,
        remat=remat, **knob)
    spy.phase = "backward"
    loss.backward()
    expect = {"grad": knob["grad_precision"], "proj": knob["proj_precision"],
              "chol": knob["chol_precision"], "pinned": "highest"}
    for phase, role, site, p in spy.records:
        assert p == expect[site], (phase, role, site, p)
    assert {(r[1], r[2]) for r in spy.records if r[0] == "forward"} == {
        ("forward", "proj"), ("forward", "chol"), ("forward", "pinned")}
    backward = {(r[1], r[2]) for r in spy.records if r[0] == "backward"}
    assert {("backward", "grad"), ("backward", "proj"), ("backward", "pinned")} <= backward
    assert (("forward", "proj") in backward) == (remat is True)  # the recompute of a
    assert (("forward", "pinned") in backward) == bool(remat)  # the mean's recompute
    # every governed product is counted, so that none runs outside its mode:
    # two chunks at one panel (M < 1,024) and W = Lzz⁻¹ by one 2×2 split
    count = collections.Counter(spy.records)
    n_chunks = B // MB

    def n(phase, role, site):
        return count[phase, role, site, expect[site]]
    assert n("forward", "forward", "chol") == 2  # −C⁻¹·B·A⁻¹
    assert n("forward", "forward", "proj") == 1 + n_chunks  # C = W·Lu, a = W·Kzx
    assert n("backward", "backward", "grad") == 5  # the dense backward's five
    assert n("backward", "backward", "proj") == 2 + 2 * n_chunks  # dW, dLu; dW, dKzx
    assert n("backward", "forward", "proj") == (n_chunks if remat is True else 0)
    assert precision.in_force() is None


def test_spy_stable_branch_takes_chol_precision(monkeypatch):
    """The shared Cholesky's stable branch: W = Lzz⁻¹ and K⁻¹ = WᵀW at
    chol_precision, forward and backward; its a, ã and the mean at
    "highest"."""
    spy = Spy()
    monkeypatch.setattr(precision, "_product", spy)
    tmodel, x, y, _ = _spy_model("stable")
    loss = gt.nsf_negative_elbo_batched(
        tmodel, x, y, torch.arange(B), torch.randn((1, SPY_L, B), generator=torch.Generator(
        ).manual_seed(0)), microbatch=MB, factored=True, y_transposed=True,
        stable_projection=True, chol_precision="default", remat="save_proj")
    spy.phase = "backward"
    loss.backward()
    for phase, role, site, p in spy.records:
        assert p == {"chol": "default", "pinned": "highest"}[site], (phase, role, site, p)
    sites = {(r[0], r[1], r[2]) for r in spy.records}
    assert {("forward", "forward", "chol"), ("backward", "backward", "chol"),
            ("forward", "forward", "pinned"), ("backward", "backward", "pinned")} <= sites
