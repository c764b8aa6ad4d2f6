"""Kernel 8 keeping P = K_s·Lu between its forward and its backward, on the CPU.

Where Lu takes a gradient and is per factor, ``tri_cuda.TriKLTrace`` runs two
steps: a forward that returns the trace and keeps P = tril(K_s·Lu), K_s =
(K⁻¹ + K⁻ᵀ)/2 (on the card kernel 8 with its P epilogue, here
``tri_kl_trace_p_plain``), and a backward that scales it, dLu = tril(2g·P)
(on the card one bytes-bound pass, here ``tri_kl_trace_scale_plain``). One Lu
under a per-factor K⁻¹ keeps nothing and recomputes. Held against
``gpzoo_tpu.ops.tri_blocked.tri_kl_trace`` and ``jax.grad`` in float64 at M =
130 and 1,100, L = 1 and 3, a shared and a per-factor K⁻¹ that is not
symmetric: the plain forward's trace at 1e-10, its P with exact zeros above
the diagonal and 2g·P against JAX's dLu at 1e-8; the Function's gradients
with Lu alone, K⁻¹ alone (no P made) and both trained; two backwards of one
graph; a profile of the backward (no product where P is kept, the recompute
where it is not); the new entries' guards on ``meta`` tensors.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gpzoo_tpu.ops import tri_blocked as jtri

from gpzoo_tpu_torch.ops import tri_cuda

T = torch.tensor
CASES = [(m, l_dim, form) for m in (130, 1100) for l_dim in (1, 3)
         for form in ("shared", "per-factor")]
PRODUCTS = ("aten::mm", "aten::bmm", "aten::matmul", "aten::baddbmm", "aten::addmm")


def _close(got, expect, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    expect = np.asarray(expect)
    np.testing.assert_allclose(got, expect, rtol=0,
                               atol=rtol * max(np.max(np.abs(expect)), 1e-300))


@functools.cache
def _case(m_dim, l_dim, form):
    """K⁻¹ (SPD plus a part that is not symmetric: (M, M) for "shared", else
    (L, M, M)), lower-triangular Lu ((1, M, M) for "one Lu", else (L, M, M)),
    a cotangent g (L,), all numpy float64, and JAX's trace and gradients of
    g·trace, (value, dK⁻¹, dLu)."""
    rng = np.random.default_rng(7 * m_dim + l_dim)
    k_shape = (m_dim, m_dim) if form == "shared" else (l_dim, m_dim, m_dim)
    w = rng.standard_normal(k_shape) / np.sqrt(m_dim)
    k_inv = (w @ np.swapaxes(w, -1, -2) + np.eye(m_dim)
             + 0.1 / np.sqrt(m_dim) * rng.standard_normal(k_shape))
    lu = np.tril(rng.standard_normal((1 if form == "one Lu" else l_dim, m_dim, m_dim)))
    lu /= np.sqrt(m_dim)
    g = rng.standard_normal(l_dim)

    def f(k, u):
        return jnp.sum(jnp.asarray(g) * jtri.tri_kl_trace(k, u))
    value = jtri.tri_kl_trace(jnp.asarray(k_inv), jnp.asarray(lu))
    dk, dlu = jax.grad(f, argnums=(0, 1))(jnp.asarray(k_inv), jnp.asarray(lu))
    return k_inv, lu, g, np.asarray(value), np.asarray(dk), np.asarray(dlu)


@pytest.mark.parametrize("m_dim,l_dim,form", CASES)
def test_plain_forward_keeps_p(m_dim, l_dim, form):
    """The plain forward-with-P: JAX's trace, tril(P) with exact zeros above
    the diagonal, and 2g·P (the plain scale) JAX's dLu on the lower
    triangle."""
    k_inv, lu, g, value, _, dlu = _case(m_dim, l_dim, form)
    trace, p = tri_cuda.tri_kl_trace_p_plain(T(k_inv), T(lu))
    _close(trace, value, 1e-10)
    assert p.shape == (l_dim, m_dim, m_dim)
    assert torch.all(p.triu(1) == 0)
    lu3 = np.tril(lu)
    k_s = (k_inv + np.swapaxes(k_inv, -1, -2)) / 2
    _close(p, np.tril(k_s @ lu3), 1e-12)
    scaled = tri_cuda.tri_kl_trace_scale_plain(p, T(g))
    _close(scaled, np.tril(dlu), 1e-8)
    assert torch.all(scaled.triu(1) == 0)
    # the Function's CPU backward from the kept P is the same closed form
    assert torch.equal(tri_cuda.tri_kl_trace_bwd_plain(T(k_inv), T(lu), T(g), p), scaled)


@pytest.mark.parametrize("trained", ["Lu", "K⁻¹", "both"])
@pytest.mark.parametrize("m_dim,l_dim,form", CASES)
def test_function_gradients_match_jax(m_dim, l_dim, form, trained):
    """TriKLTrace's value and the trained operands' gradients against JAX;
    P is kept exactly where Lu trains."""
    k_inv, lu, g, value, dk, dlu = _case(m_dim, l_dim, form)
    k_t = T(k_inv, requires_grad=trained != "Lu")
    lu_t = T(lu, requires_grad=trained != "K⁻¹")
    out = tri_cuda.tri_kl_trace(k_t, lu_t)
    kept = out.grad_fn.saved_tensors[2]
    if trained == "K⁻¹":
        assert kept is None
    else:
        assert kept.shape == (l_dim, m_dim, m_dim) and torch.all(kept.triu(1) == 0)
    out.backward(T(g))
    _close(out, value, 1e-10)
    if trained != "K⁻¹":
        _close(lu_t.grad, np.tril(dlu), 1e-8)
        assert torch.all(lu_t.grad.triu(1) == 0)
    else:
        assert lu_t.grad is None
    if trained != "Lu":
        _close(k_t.grad, dk, 1e-8)
    else:
        assert k_t.grad is None


@pytest.mark.parametrize("form", ["shared", "per-factor", "one Lu"])
def test_two_backwards_of_one_graph_agree(form):
    """backward(retain_graph=True) twice: the scale pass writes a new dLu
    and leaves P as it was, so both give the same bits."""
    k_inv, lu, g, _, _, dlu = _case(130, 3, form)
    lu_t = T(lu, requires_grad=True)
    out = tri_cuda.tri_kl_trace(T(k_inv), lu_t)
    first, = torch.autograd.grad(out, lu_t, T(g), retain_graph=True)
    second, = torch.autograd.grad(out, lu_t, T(g), retain_graph=True)
    assert torch.equal(first, second)
    _close(first, np.tril(dlu), 1e-8)


def _backward_ops(k_inv, lu, g):
    """The operators the Function's backward runs (Lu trained)."""
    lu_t = T(lu, requires_grad=True)
    out = tri_cuda.tri_kl_trace(T(k_inv), lu_t)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out.backward(T(g))
    return {evt.name for evt in prof.events()}


@pytest.mark.parametrize("form", ["shared", "per-factor", "one Lu"])
def test_backward_runs_a_product_only_to_recompute(form):
    """Where P is kept (a per-factor Lu) the backward runs no matrix
    product, only the scale; one Lu under a per-factor K⁻¹ keeps no P, and
    its backward recomputes with a product."""
    k_inv, lu, g, _, _, _ = _case(130, 3, form)
    ops = _backward_ops(k_inv, lu, g)
    products = ops.intersection(PRODUCTS)
    if form == "one Lu":
        assert products, ops
    else:
        assert not products, products
        assert "aten::mul" in ops


def test_new_entries_guards():
    """Off the CPU a tensor goes to the kernel or raises: on ``meta`` the
    forward-with-P and the scale pass raise and no counter moves; shapes
    that keep no P, or a g that does not fit P, raise on the CPU too."""
    k = torch.zeros((5, 5), device="meta")
    lu = torch.zeros((2, 5, 5), device="meta")
    g = torch.zeros((2,), device="meta")
    counters = (tri_cuda.tri_kl_trace_fwd, tri_cuda.tri_kl_trace_fwd_p,
                tri_cuda.tri_kl_trace_scale, tri_cuda.tri_kl_trace_bwd)
    before = [fn.launches for fn in counters]
    with pytest.raises(ValueError):  # no kernel for meta
        tri_cuda.tri_kl_trace_fwd_p(k, lu)
    with pytest.raises(ValueError):
        tri_cuda.tri_kl_trace_scale(lu, g)
    with pytest.raises(TypeError):  # the kernels take float32
        tri_cuda.tri_kl_trace_fwd_p(k.double(), lu.double())
    with pytest.raises(TypeError):
        tri_cuda.tri_kl_trace_scale(lu.double(), g.double())
    with pytest.raises(ValueError):  # g of another length than P's factors
        tri_cuda.tri_kl_trace_scale(lu, g[:1])
    with pytest.raises(ValueError):  # P is not (L, M, M)
        tri_cuda.tri_kl_trace_scale(lu[:, :, :4], g)
    with pytest.raises(ValueError):  # Lu on the CPU, K⁻¹ not
        tri_cuda.tri_kl_trace_fwd_p(k, torch.zeros((2, 5, 5)))
    with pytest.raises(ValueError):  # g on the CPU, P not
        tri_cuda.tri_kl_trace_scale(torch.zeros((2, 5, 5)), g)
    for k_shape, lu_shape in (((3, 5, 5), (1, 5, 5)), ((3, 5, 5), (5, 5))):
        with pytest.raises(ValueError):  # one Lu under a per-factor K⁻¹
            tri_cuda.tri_kl_trace_fwd_p(torch.zeros(k_shape), torch.zeros(lu_shape))
        with pytest.raises(ValueError):
            tri_cuda.tri_kl_trace_fwd_p(torch.zeros(k_shape, device="meta"),
                                        torch.zeros(lu_shape, device="meta"))
    assert [fn.launches for fn in counters] == before
