"""Kernel 1 keeping c = Luᵀã between its forward and its backward, on the CPU.

Where a gradient is taken, ``tri_cuda.TriSqColsum`` runs two steps: a forward
that returns colsum(c²) and keeps c (on the card kernel 1 storing each row
tile's c beside its column sums, here ``tri_sq_colsum_c_plain``: the panels of
``tri_blocked`` computed once), and a backward whose dc = 2c·g is one pass of
bytes (on the card the split pass given g, here ``tri_dc_from_c_plain``)
before kernels 6 and 7, where the dc epilogue reran the whole triangle for c.
Held against ``gpzoo_tpu.ops.tri_blocked.tri_sq_colsum`` and ``jax.vjp`` of it
in float64 at M = 130 and 1,100, L = 1 and 3, a shared (M, B) and a per-factor
(L, M, B) a: the plain forward's colsum at 1e-10 and the same bits as the
port's panel form, its c the bits of ``tri_blocked.tri_t_matmul``; the plain
scale the bits of ``tri_dc_plain``; the Function's dLu and da at 1e-8 and the
bits of the recompute route; no c made where no gradient is recorded; the
first run's c freed under ``torch.utils.checkpoint``; two backwards of one
graph; no recompute in the backward; the new entries' guards on ``meta``
tensors; and the c store's addressing replayed from tri.cu.
"""

import contextlib
import functools
import gc
import weakref
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint
from _tri_decodes import M_REPLAY

from gpzoo_tpu.ops import tri_blocked as jtri

from gpzoo_tpu_torch.ops import tri_blocked, tri_cuda

T = torch.tensor
B = 37  # off the 128 tile, odd: the kernel's ragged, one-float stores
CASES = [(m, l_dim, form) for m in (130, 1100) for l_dim in (1, 3)
         for form in ("shared", "per-factor")]
TILE = 128


def _close(got, expect, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    expect = np.asarray(expect)
    np.testing.assert_allclose(got, expect, rtol=0,
                               atol=rtol * max(np.max(np.abs(expect)), 1e-300))


@functools.cache
def _case(m_dim, l_dim, form):
    """Lower-triangular Lu (L, M, M), a ((M, B) for "shared", else
    (L, M, B)), a cotangent g (L, B), all numpy float64, and JAX's colsum
    and gradients of Σ g·colsum, (value, dLu, da)."""
    rng = np.random.default_rng(11 * m_dim + l_dim + (form == "shared"))
    lu = np.tril(rng.standard_normal((l_dim, m_dim, m_dim))) / np.sqrt(m_dim)
    a = rng.standard_normal((m_dim, B) if form == "shared" else (l_dim, m_dim, B))
    g = rng.standard_normal((l_dim, B))

    def f(u, x):
        return jnp.sum(jnp.asarray(g) * jtri.tri_sq_colsum(jnp.tril(u), x))
    value = jtri.tri_sq_colsum(jnp.asarray(lu), jnp.asarray(a))
    dlu, da = jax.grad(f, argnums=(0, 1))(jnp.asarray(lu), jnp.asarray(a))
    return lu, a, g, np.asarray(value), np.asarray(dlu), np.asarray(da)


@pytest.mark.parametrize("m_dim,l_dim,form", CASES)
def test_plain_forward_keeps_c(m_dim, l_dim, form):
    """The plain forward keeping c: JAX's colsum, the port's panel colsum bit
    for bit, and c the panel product's bits."""
    lu, a, _, value, _, _ = _case(m_dim, l_dim, form)
    out, c = tri_cuda.tri_sq_colsum_c_plain(T(lu), T(a))
    _close(out, value, 1e-10)
    assert torch.equal(out, tri_blocked.tri_sq_colsum(T(lu), T(a)))
    assert c.shape == (l_dim, m_dim, B)
    assert torch.equal(c, tri_blocked.tri_t_matmul(T(lu), T(a)))
    # the entry point takes this route on the CPU and counts no launch
    before = tri_cuda.tri_sq_colsum_fwd_c.launches
    out2, c2 = tri_cuda.tri_sq_colsum_fwd_c(T(lu), T(a))
    assert torch.equal(out2, out) and torch.equal(c2, c)
    assert tri_cuda.tri_sq_colsum_fwd_c.launches == before


@pytest.mark.parametrize("m_dim,l_dim,form", CASES)
def test_plain_scale_is_the_recompute_bit_for_bit(m_dim, l_dim, form):
    """dc = 2c·g from the kept c: tri_dc_plain's bits (which recomputes c),
    through the plain form and the entry point's CPU route."""
    lu, a, g, _, _, _ = _case(m_dim, l_dim, form)
    c = tri_cuda.tri_sq_colsum_c_plain(T(lu), T(a))[1]
    want = tri_cuda.tri_dc_plain(T(lu), T(a), T(g))
    assert torch.equal(tri_cuda.tri_dc_from_c_plain(c, T(g)), want)
    before = tri_cuda.tri_dc_from_c.launches
    assert torch.equal(tri_cuda.tri_dc_from_c(c, T(g), transposed=True), want)
    assert tri_cuda.tri_dc_from_c.launches == before


def _grads(lu, a, g, trained):
    """The Function's value, its kept c and the trained operands'
    gradients (None where not trained)."""
    lu_t = T(lu, requires_grad=trained != "a")
    a_t = T(a, requires_grad=trained != "Lu")
    out = tri_cuda.tri_sq_colsum(lu_t, a_t)
    kept = out.grad_fn.saved_tensors[2]
    out.backward(T(g))
    return out.detach(), kept, lu_t.grad, a_t.grad


@pytest.mark.parametrize("trained", ["Lu", "a", "both"])
@pytest.mark.parametrize("m_dim,l_dim,form", CASES)
def test_function_gradients_match_jax(m_dim, l_dim, form, trained):
    """TriSqColsum's value and the trained operands' gradients against JAX,
    c kept whichever operand trains."""
    lu, a, g, value, dlu, da = _case(m_dim, l_dim, form)
    out, kept, got_lu, got_a = _grads(lu, a, g, trained)
    _close(out, value, 1e-10)
    assert torch.equal(kept, tri_blocked.tri_t_matmul(T(lu), T(a)))
    if trained == "a":
        assert got_lu is None
    else:
        _close(got_lu, np.tril(dlu), 1e-8)
        assert torch.all(got_lu.triu(1) == 0)
    if trained == "Lu":
        assert got_a is None
    else:
        _close(got_a, da, 1e-8)


@pytest.mark.parametrize("m_dim,l_dim,form", CASES)
def test_keep_c_route_is_the_recompute_route_bit_for_bit(m_dim, l_dim, form):
    """The gradients from the kept c are those of the route that recomputed
    c in the backward (tri_dc_plain, then kernels 6 and 7's plain forms)."""
    lu, a, g, _, _, _ = _case(m_dim, l_dim, form)
    _, _, got_lu, got_a = _grads(lu, a, g, "both")
    dc = tri_cuda.tri_dc_plain(T(lu), T(a), T(g))
    assert torch.equal(got_lu, tri_cuda.tri_dlu_plain(T(a), dc))
    assert torch.equal(got_a, tri_cuda.tri_da_plain(T(lu), dc, shared=form == "shared"))


@contextlib.contextmanager
def _spied():
    """The forward that keeps c spied on: yields the c's it makes, as weak
    references."""
    made = []
    keep = tri_cuda.tri_sq_colsum_fwd_c

    def spy(lu, a):
        out, c = keep(lu, a)
        made.append(weakref.ref(c))
        return out, c
    with mock.patch.object(tri_cuda, "tri_sq_colsum_fwd_c", spy):
        yield made


@pytest.mark.parametrize("form", ["shared", "per-factor"])
@pytest.mark.parametrize("how", ["no_grad", "nothing requires grad"])
def test_no_c_where_no_gradient_is_recorded(how, form):
    """Where no gradient is recorded the forward keeps nothing: kernel 1
    alone, the same value as the forward that keeps c."""
    lu, a, _, value, _, _ = _case(130, 3, form)
    lu_t = T(lu, requires_grad=how == "no_grad")
    a_t = T(a, requires_grad=how == "no_grad")
    with _spied() as made, (torch.no_grad() if how == "no_grad" else contextlib.nullcontext()):
        out = tri_cuda.tri_sq_colsum(lu_t, a_t)
    assert made == []
    assert out.grad_fn is None
    assert torch.equal(out, tri_cuda.tri_sq_colsum_c_plain(T(lu), T(a))[0])
    _close(out, value, 1e-10)


@pytest.mark.parametrize("form", ["shared", "per-factor"])
def test_checkpoint_drops_the_first_runs_c(form):
    """Under torch.utils.checkpoint(use_reentrant=False), as the MGGP legs
    run their chunk: c is kept through save_for_backward, so the first
    run's c is freed when the forward ends, the recompute makes the c the
    backward reads, and the gradients are those without the checkpoint."""
    lu, a, g, _, _, _ = _case(130, 3, form)
    _, _, want_lu, want_a = _grads(lu, a, g, "both")
    lu_t, a_t = T(lu, requires_grad=True), T(a, requires_grad=True)

    def region(u, x):
        return tri_cuda.tri_sq_colsum(u, x) * 1.0

    with _spied() as made:
        out = torch.utils.checkpoint.checkpoint(region, lu_t, a_t, use_reentrant=False)
        gc.collect()
        assert len(made) == 1 and made[0]() is None  # the first run's c is gone
        out.backward(T(g))
    assert len(made) == 2  # the recompute's c, which the backward read
    gc.collect()
    assert made[1]() is None
    assert torch.equal(lu_t.grad, want_lu) and torch.equal(a_t.grad, want_a)


@pytest.mark.parametrize("form", ["shared", "per-factor"])
def test_two_backwards_of_one_graph_agree(form):
    """backward(retain_graph=True) twice: the scale pass writes a new dc and
    leaves c as it was, so both give the same bits."""
    lu, a, g, _, dlu, da = _case(130, 3, form)
    lu_t, a_t = T(lu, requires_grad=True), T(a, requires_grad=True)
    out = tri_cuda.tri_sq_colsum(lu_t, a_t)
    first = torch.autograd.grad(out, (lu_t, a_t), T(g), retain_graph=True)
    second = torch.autograd.grad(out, (lu_t, a_t), T(g), retain_graph=True)
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    _close(first[0], np.tril(dlu), 1e-8)
    _close(first[1], da, 1e-8)


@pytest.mark.parametrize("form", ["shared", "per-factor"])
def test_backward_recomputes_no_c(form):
    """Where c is kept, the backward calls no product that makes c again:
    neither tri_t_matmul (either route) nor the recomputing dc."""
    lu, a, g, _, dlu, _ = _case(1100, 3, form)
    lu_t, a_t = T(lu, requires_grad=True), T(a, requires_grad=True)
    out = tri_cuda.tri_sq_colsum(lu_t, a_t)

    def refuse(*args, **kwargs):
        raise AssertionError("the backward recomputed c")
    with mock.patch.object(tri_blocked, "tri_t_matmul", refuse), \
            mock.patch.object(tri_cuda, "tri_t_matmul", refuse), \
            mock.patch.object(tri_cuda, "tri_t_matmul_fwd", refuse), \
            mock.patch.object(tri_cuda, "tri_dc_plain", refuse), \
            mock.patch.object(tri_cuda, "tri_dc", refuse), \
            mock.patch.object(tri_cuda, "tri_sq_colsum_c_plain", refuse):
        out.backward(T(g))
    _close(lu_t.grad, np.tril(dlu), 1e-8)


def test_new_entries_guards():
    """Off the CPU a tensor goes to the kernel or raises: on ``meta`` the
    forward keeping c and the scale pass raise and no counter moves; shapes
    that do not fit raise on the CPU too."""
    lu = torch.zeros((2, 5, 5), device="meta")
    a = torch.zeros((2, 5, 3), device="meta")
    c = torch.zeros((2, 5, 3), device="meta")
    g = torch.zeros((2, 3), device="meta")
    counters = (tri_cuda.tri_sq_colsum_fwd_c, tri_cuda.tri_dc_from_c,
                tri_cuda.tri_sq_colsum_fused, tri_cuda.tri_dc, tri_cuda.tri_split)
    before = [fn.launches for fn in counters]
    with pytest.raises(ValueError):  # no kernel for meta
        tri_cuda.tri_sq_colsum_fwd_c(lu, a)
    with pytest.raises(ValueError):
        tri_cuda.tri_dc_from_c(c, g)
    with pytest.raises(ValueError):
        tri_cuda.tri_dc_from_c(c, g, transposed=True)
    with pytest.raises(TypeError):  # the kernels take float32
        tri_cuda.tri_sq_colsum_fwd_c(lu.double(), a.double())
    with pytest.raises(TypeError):
        tri_cuda.tri_dc_from_c(c.double(), g.double())
    with pytest.raises(ValueError):  # not contiguous
        tri_cuda.tri_dc_from_c(torch.zeros((2, 3, 5), device="meta").mT, g)
    with pytest.raises(ValueError):  # g does not fit c: (L, B)
        tri_cuda.tri_dc_from_c(c, g[:, :2])
    with pytest.raises(ValueError):
        tri_cuda.tri_dc_from_c(c, g[:1])
    with pytest.raises(ValueError):  # c is not (L, M, B)
        tri_cuda.tri_dc_from_c(c[0], g)
    with pytest.raises(ValueError):  # a does not fit lu
        tri_cuda.tri_sq_colsum_fwd_c(lu, a[:1])
    with pytest.raises(ValueError):  # lu on the CPU, a not
        tri_cuda.tri_sq_colsum_fwd_c(torch.zeros((2, 5, 5)), a)
    with pytest.raises(ValueError):  # c on the CPU, g not
        tri_cuda.tri_dc_from_c(torch.zeros((2, 5, 3)), g)
    with pytest.raises(ValueError):  # the CPU route checks shapes too
        tri_cuda.tri_dc_from_c(torch.zeros((2, 5, 3)), torch.zeros((2, 5)))
    assert [fn.launches for fn in counters] == before


@pytest.mark.parametrize("b_dim", [1, 129, 130, 7000])
@pytest.mark.parametrize("m_dim", [m for m in M_REPLAY if m != 3000])
def test_c_store_writes_every_element_once(m_dim, b_dim):
    """tri.cu's kColsumC store, replayed: each block (a 128-column strip)
    walks every row tile; thread (warp, lane) of the two consumer
    warpgroups stores rows row and row + 8, columns col + 8 j and + 1, masked
    at m >= M and b >= B. Every element of c is written once, nothing
    outside it, and where B is even (a float2 a lane) every pair starts 8
    bytes aligned inside its row."""
    nrt, nct = -(-m_dim // TILE), -(-b_dim // TILE)
    warp, lane, h, j, e = np.meshgrid(np.arange(8), np.arange(32), np.arange(2),
                                      np.arange(16), np.arange(2), indexing="ij")
    local_row = (warp // 4) * 64 + (warp % 4) * 16 + lane // 4 + 8 * h
    local_col = 2 * (lane % 4) + 8 * j + e
    counts = np.zeros((m_dim, b_dim), np.int64)
    for rt in range(nrt):
        for ct in range(nct):
            m = rt * TILE + local_row
            b = ct * TILE + local_col
            keep = (m < m_dim) & (b < b_dim)
            np.add.at(counts, (m[keep], b[keep]), 1)
            if b_dim % 2 == 0:
                # the pair (e = 0, 1) of one lane: both in or both out
                first = b[..., 0]
                np.testing.assert_array_equal(keep[..., 0], keep[..., 1])
                assert np.all(((m[..., 0] * b_dim + first) % 2 == 0) | ~keep[..., 0])
    assert np.all(counts == 1)
