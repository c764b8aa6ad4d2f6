"""Kernel 8 of the port, the KL trace tr(K⁻¹·Lu·Luᵀ), on the CPU.

``tri_cuda.tri_kl_trace`` is the autograd Function every loss's KL calls
(``TriKLTrace``): on the card kernel 8 and its backward, here the panel form
of ``ops/tri_blocked.py`` forward and the closed form
``tri_kl_trace_bwd_plain`` backward, written into one buffer, with dK⁻¹ =
g·Lu·Luᵀ as one product (``tri_kl_trace_dk``). Held against
``gpzoo_tpu.ops.tri_blocked.tri_kl_trace`` and ``jax.grad`` in float64: the
value at 1e-10, dLu on the lower triangle and dK⁻¹ at 1e-8, at M = 130 (one
panel) and 1,100 (six), L = 1 and 3, a shared K⁻¹, a per-factor one, and a
per-factor one over one Lu, always a K⁻¹ that is not symmetric (a kernel
that assumed symmetry would fail). The closed forms that ``chip_smoke.py``
holds the kernels against, against the same oracle. A profile of the
backward: no fill, zero or add of a full (L, M, M) tensor (the panel form
under autograd makes them, the control). The losses whose KL takes the trace
(the precomputed NSF loss, the blockwise collapse with the kernel trained,
the VNNGP loss with a per-factor and a shared Lu) against JAX's leaf
gradients at 1e-8, through the Function. The guards on ``meta`` tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import gpzoo_tpu as gz
from gpzoo_tpu.ops import tri_blocked as jtri
from gpzoo_tpu.train.fast import nsf_negative_elbo_batched as j_batched
from gpzoo_tpu.train.fast import nsf_negative_elbo_precomputed as j_loss
from gpzoo_tpu.train.fast import precompute_nsf_projection as j_precompute
from gpzoo_tpu.train.fast_vnngp import vnngp_nsf_negative_elbo_batched as j_vnngp
from gpzoo_tpu.train.loop import _path_str

import gpzoo_tpu_torch as gt
from gpzoo_tpu_torch.convert import nsf_from_numpy, vnngp_from_numpy
from gpzoo_tpu_torch.ops import tri_blocked, tri_cuda
from gpzoo_tpu_torch.train import fast, fast_vnngp

T = torch.tensor
FORMS = ("shared", "per-factor", "one Lu")


def _close(got, expect, rtol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    expect = np.asarray(expect)
    np.testing.assert_allclose(got, expect, rtol=0,
                               atol=rtol * max(np.max(np.abs(expect)), 1e-300))


def _operands(seed, l_dim, m_dim, form):
    """K⁻¹ (SPD plus a part that is not symmetric), lower-triangular Lu and
    a cotangent g (L,), in numpy float64: K⁻¹ (M, M) for "shared", else
    (L, M, M); Lu (1, M, M) for "one Lu", else (L, M, M)."""
    rng = np.random.default_rng(seed)
    k_shape = (m_dim, m_dim) if form == "shared" else (l_dim, m_dim, m_dim)
    w = rng.standard_normal(k_shape) / np.sqrt(m_dim)
    k_inv = (w @ np.swapaxes(w, -1, -2) + np.eye(m_dim)
             + 0.1 / np.sqrt(m_dim) * rng.standard_normal(k_shape))
    lu = np.tril(rng.standard_normal((1 if form == "one Lu" else l_dim, m_dim, m_dim)))
    return k_inv, lu / np.sqrt(m_dim), rng.standard_normal(l_dim)


def _jax(k_inv, lu, g):
    """JAX's trace and the gradients of g·trace, (value, dK⁻¹, dLu)."""
    def f(k, u):
        return jnp.sum(jnp.asarray(g) * jtri.tri_kl_trace(k, u))
    value = jtri.tri_kl_trace(jnp.asarray(k_inv), jnp.asarray(lu))
    dk, dlu = jax.grad(f, argnums=(0, 1))(jnp.asarray(k_inv), jnp.asarray(lu))
    return value, dk, dlu


CASES = [(m, l_dim, form) for m in (130, 1100) for l_dim in (1, 3) for form in FORMS]


@pytest.mark.parametrize("m_dim,l_dim,form", CASES)
def test_trace_and_gradients_match_jax(m_dim, l_dim, form):
    """The Function's value and both gradients against JAX's panels."""
    k_inv, lu, g = _operands(m_dim + l_dim, l_dim, m_dim, form)
    value, dk, dlu = _jax(k_inv, lu, g)
    k_t, lu_t = T(k_inv, requires_grad=True), T(lu, requires_grad=True)
    out = tri_cuda.tri_kl_trace(k_t, lu_t)
    assert out.grad_fn is not None and out.shape == (l_dim,)
    out.backward(T(g))
    _close(out, value, 1e-10)
    _close(lu_t.grad, np.tril(dlu), 1e-8)
    assert torch.all(lu_t.grad.triu(1) == 0)
    _close(k_t.grad, dk, 1e-8)


@pytest.mark.parametrize("m_dim,l_dim,form", CASES)
def test_closed_forms_match_jax(m_dim, l_dim, form):
    """The closed forms the kernels are held against on the card."""
    k_inv, lu, g = _operands(2 * m_dim + l_dim, l_dim, m_dim, form)
    value, dk, dlu = _jax(k_inv, lu, g)
    _close(tri_cuda.tri_kl_trace_plain(T(k_inv), T(lu)), value, 1e-10)
    _close(tri_cuda.tri_kl_trace_bwd_plain(T(k_inv), T(lu), T(g)), np.tril(dlu), 1e-8)
    _close(tri_cuda.tri_kl_trace_dk(T(k_inv), T(lu), T(g)), dk, 1e-8)


@pytest.mark.parametrize("form", FORMS)
def test_two_dimensional_lu_keeps_its_shape(form):
    """An (M, M) Lu gets an (M, M) gradient; K⁻¹'s keeps K⁻¹'s shape."""
    k_inv, lu, g = _operands(3, 2 if form != "shared" else 1, 60, form)
    lu2 = lu[0]
    value, dk, dlu = _jax(k_inv, lu2, g)
    k_t, lu_t = T(k_inv, requires_grad=True), T(lu2, requires_grad=True)
    tri_cuda.tri_kl_trace(k_t, lu_t).backward(T(g))
    assert lu_t.grad.shape == lu2.shape and k_t.grad.shape == k_inv.shape
    _close(lu_t.grad, np.tril(dlu), 1e-8)
    _close(k_t.grad, dk, 1e-8)


def _full_size_writes(fn, shape):
    """(fills and zeros, adds) of a tensor of ``shape`` in ``fn``'s run,
    from a profile with the operators' input shapes."""
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        fn()
    fills = adds = 0
    for evt in prof.events():
        if list(shape) not in [list(s) for s in evt.input_shapes]:
            continue
        if evt.name in ("aten::fill_", "aten::zero_"):
            fills += 1
        elif evt.name in ("aten::add_", "aten::add"):
            adds += 1
    return fills, adds


@pytest.mark.parametrize("form", ["shared", "per-factor"])
def test_backward_writes_no_full_size_fill_or_add(form):
    """L = 2, M = 1,200 (six panels): the panel form under autograd widens
    each slice's gradient to a zero-filled (L, M, M) and adds it in (the
    control); the Function's backward writes dLu once."""
    l_dim, m_dim = 2, 1200
    k_inv, lu, g = _operands(7, l_dim, m_dim, form)
    shape = (l_dim, m_dim, m_dim)

    def run(trace):
        k_t, lu_t = T(k_inv), T(lu, requires_grad=True)
        out = trace(k_t, lu_t)
        return lambda: out.backward(T(g))

    panels = _full_size_writes(run(tri_blocked.tri_kl_trace), shape)
    kernel = _full_size_writes(run(tri_cuda.tri_kl_trace), shape)
    assert panels[0] >= 6 and panels[1] >= 5, panels
    assert kernel == (0, 0), kernel


def test_forward_alone_without_a_gradient():
    """Where no gradient is recorded the forward runs alone, the panels'
    value."""
    k_inv, lu, _ = _operands(9, 3, 50, "shared")
    with torch.no_grad():
        out = tri_cuda.tri_kl_trace(T(k_inv, requires_grad=True), T(lu))
    assert out.grad_fn is None
    _close(out, tri_blocked.tri_kl_trace(T(k_inv), T(lu)), 1e-14)


def test_wrapper_guards():
    """Off the CPU a tensor goes to the kernel or raises: on ``meta`` every
    malformed or kernel-less call raises and no counter moves; shapes that
    make no trace raise on the CPU too."""
    k = torch.zeros((5, 5), device="meta")
    lu = torch.zeros((2, 5, 5), device="meta")
    g = torch.zeros((2,), device="meta")
    counters = (tri_cuda.tri_kl_trace_fwd, tri_cuda.tri_kl_trace_bwd)
    before = [fn.launches for fn in counters]
    with pytest.raises(ValueError):  # no kernel for meta
        tri_cuda.tri_kl_trace_fwd(k, lu)
    with pytest.raises(ValueError):
        tri_cuda.tri_kl_trace_bwd(k, lu, g)
    with pytest.raises(ValueError):  # g of another shape
        tri_cuda.tri_kl_trace_bwd(k, lu, g[:1])
    with pytest.raises(ValueError):  # K⁻¹ on the CPU, Lu not
        tri_cuda.tri_kl_trace_fwd(torch.zeros((5, 5)), lu)
    with pytest.raises(ValueError):  # Lu on the CPU, K⁻¹ not
        tri_cuda.tri_kl_trace_fwd(k, torch.zeros((2, 5, 5)))
    for k_shape, lu_shape in (((5, 5), (2, 5, 4)), ((3, 5, 5), (2, 5, 5)),
                              ((1, 5, 5), (2, 5, 5)), ((5, 4), (5, 4))):
        with pytest.raises(ValueError):
            tri_cuda.tri_kl_trace(torch.zeros(k_shape), torch.zeros(lu_shape))
    with pytest.raises(TypeError):  # the kernels take float32
        tri_cuda.tri_kl_trace_fwd(k.double(), lu.double())
    assert [fn.launches for fn in counters] == before


# --- the losses whose KL takes the trace --------------------------------------

N, D, L, M, B = 300, 20, 3, 40, 64


def jax_leaves(model):
    return {_path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(model)[0]}


@pytest.fixture
def counted(monkeypatch):
    """Counts the calls of the Function's CPU backward (the closed form),
    so that each loss below shows it went through ``TriKLTrace``."""
    calls = []
    plain = tri_cuda.tri_kl_trace_bwd_plain

    def spy(*args):
        calls.append(tuple(args[1].shape))
        return plain(*args)
    monkeypatch.setattr(tri_cuda, "tri_kl_trace_bwd_plain", spy)
    return calls


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    coords = rng.uniform(-2, 2, (N, 2))
    counts_t = rng.poisson(3.0, (N, D)).astype(np.float64)  # spot-major
    return coords, counts_t


def _nsf(coords, seed):
    cfg = gz.SlideseqNSFConfig(D=D, N=N, L=L, M=M, batch_size=B)
    jmodel = cfg.build(jax.random.PRNGKey(seed), jnp.asarray(coords))
    rng = np.random.default_rng(seed)
    lu_raw = np.tril(0.2 * rng.standard_normal((L, M, M)))
    jmodel = jmodel.replace(prior=jmodel.prior.replace(Lu_raw=jnp.asarray(lu_raw)))
    tmodel = nsf_from_numpy(jax_leaves(jmodel), "cpu", torch.float64,
                            jitter=jmodel.prior.jitter, var_floor=jmodel.prior.var_floor)
    return jmodel, tmodel


def _batch(seed, E):
    k_idx, k_eps = jax.random.split(jax.random.PRNGKey(seed))
    idx = jax.random.choice(k_idx, N, (B,), replace=False)
    return idx, k_eps, jax.random.normal(k_eps, (E, L, B), dtype=jnp.float64)


def _check_leaves(tmodel, jgrad, paths=None):
    jg = jax_leaves(jgrad)
    for path, p in tmodel.named_parameters():
        if p.grad is not None and (paths is None or path in paths):
            _close(p.grad, jg[path], 1e-8)


def test_precomputed_loss_leaf_gradients_match_jax(data, counted):
    """The north-star loss: a shared K⁻¹ (constant), per-factor Lu."""
    coords, y = data
    jmodel, tmodel = _nsf(coords, 3)
    idx, key, eps = _batch(4, 1)
    jval, jgrad = jax.value_and_grad(j_loss)(
        jmodel, j_precompute(jmodel, jnp.asarray(coords)), jnp.asarray(y), idx, key, E=1,
        y_transposed=True)
    tval = gt.nsf_negative_elbo_precomputed(
        tmodel, gt.precompute_nsf_projection(tmodel, T(coords)), T(y),
        T(np.asarray(idx)), T(np.asarray(eps)), y_transposed=True)
    tval.backward()
    _close(tval, jval, 1e-8)
    _check_leaves(tmodel, jgrad, ("prior.mu", "prior.Lu_raw", "W_raw", "V_raw"))
    assert counted == [(L, M, M)]


def test_blockwise_collapse_leaf_gradients_match_jax(data, counted):
    """The blockwise collapse with the kernel and Z trained: the KL's K⁻¹
    carries a gradient (dK⁻¹ = Σ_l g_l·Lu_l·Lu_lᵀ)."""
    coords, y = data
    jmodel, tmodel = _nsf(coords, 5)
    idx, key, eps = _batch(6, 2)
    kw = dict(factored=True, shared_kernel=True, y_transposed=True, microbatch=32,
              remat=False)
    jval, jgrad = jax.value_and_grad(lambda m: j_batched(
        m, jnp.asarray(coords), jnp.asarray(y), idx, key, E=2, **kw))(jmodel)
    tval = gt.nsf_negative_elbo_batched(tmodel, T(coords), T(y), T(np.asarray(idx)),
                                        T(np.asarray(eps)), E=2, **kw)
    tval.backward()
    _close(tval, jval, 1e-8)
    assert tmodel.prior.Z.grad is not None and tmodel.prior.kernel.lengthscale.grad is not None
    _check_leaves(tmodel, jgrad)
    assert counted == [(L, M, M)]


@pytest.mark.parametrize("layout", ["per_factor", "shared"])
def test_vnngp_loss_leaf_gradients_match_jax(data, counted, layout):
    """The VNNGP loss without the collapse: a per-factor K⁻¹ over a
    per-factor Lu, or over one Lu (its dLu summed over the factors)."""
    coords, y = data
    cfg = gz.VNNGPConfig(D=D, N=N, L=L, M=M, K=4)
    jmodel = cfg.build(jax.random.PRNGKey(8), X=jnp.asarray(coords))
    rng = np.random.default_rng(12)
    lead = (L,) if layout == "per_factor" else ()
    jmodel = jmodel.replace(prior=jmodel.prior.replace(
        mu=jnp.asarray(0.3 * rng.standard_normal(lead + (M,))),
        Lu_raw=jnp.asarray(0.2 * rng.standard_normal(lead + (M, M)))))
    gp = jmodel.prior
    tmodel = vnngp_from_numpy(jax_leaves(jmodel), "cpu", torch.float64, K=gp.K,
                              jitter=gp.jitter, var_floor=gp.var_floor)
    idx, key, eps = _batch(9, 1)
    jval, jgrad = jax.value_and_grad(lambda m: j_vnngp(
        m, jnp.asarray(coords), jnp.asarray(y), idx, key, E=1, shared_kernel=False,
        y_transposed=True))(jmodel)
    tval = gt.vnngp_nsf_negative_elbo_batched(
        tmodel, T(coords), T(y), T(np.asarray(idx)), T(np.asarray(eps)),
        shared_kernel=False, y_transposed=True)
    tval.backward()
    _close(tval, jval, 1e-8)
    _check_leaves(tmodel, jgrad)
    assert counted == [(L, M, M) if layout == "per_factor" else (1, M, M)]


def test_losses_call_the_function():
    """Every caller of the trace takes the kernel's Function, none the
    panel form."""
    assert fast.tri_kl_trace is tri_cuda.tri_kl_trace
    assert fast_vnngp.tri_kl_trace is tri_cuda.tri_kl_trace
