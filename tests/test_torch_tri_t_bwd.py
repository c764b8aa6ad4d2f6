"""Kernel 2's backward (JAX's ``tri_pallas._tri_bwd``) in the port, on CPU.

``tri_cuda.tri_t_matmul`` is differentiable on both routes with JAX's
contract: Lu is structurally lower-triangular and the returned dLu is
tril(dense gradient), da = Lu·g over the lower triangle (summed over l for a
shared a). On the CPU the backward is ``tri_t_matmul_bwd_plain`` (JAX's
panels); on the card ``tri_split`` writes g in the operand layout of kernels
6 and 7, which run on it unchanged. Here: the gradients against
``_tri_bwd`` in float64, M below and above ``MIN_DIM`` (one panel and six),
with exact zeros above dLu's diagonal (the dense einsum's gradient, which the
CPU route gave before, has none there); a per-factor a against ``jax.vjp``
of the dense product; ``tri_split_plain``'s layout and its TF32 hi/lo
rounding against an independent float64 rounding; the wrappers' guards on
``meta`` tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpzoo_tpu.ops import tri_pallas

from gpzoo_tpu_torch.ops import tri_blocked, tri_cuda

T = torch.tensor


def _close(got, expect, rtol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    expect = np.asarray(expect)
    np.testing.assert_allclose(got, expect, rtol=0,
                               atol=rtol * max(np.max(np.abs(expect)), 1e-300))


def _operands(seed, l_dim, m_dim, b_dim, per_factor=False):
    rng = np.random.default_rng(seed)
    lu = np.tril(rng.standard_normal((l_dim, m_dim, m_dim))) / np.sqrt(m_dim)
    a = rng.standard_normal((l_dim, m_dim, b_dim) if per_factor else (m_dim, b_dim))
    g = rng.standard_normal((l_dim, m_dim, b_dim))
    return lu, a, g


def _grads(lu, a, g, need_lu=True, need_a=True):
    lu_t, a_t = T(lu, requires_grad=need_lu), T(a, requires_grad=need_a)
    c = tri_cuda.tri_t_matmul(lu_t, a_t)
    c.backward(T(g))
    return c, lu_t.grad, a_t.grad


@pytest.mark.parametrize("m_dim", [40, 1100])
def test_gradients_match_jax_tri_bwd(m_dim):
    """A shared a (M, B): dLu and da against JAX's own backward rule."""
    lu, a, g = _operands(m_dim, 2, m_dim, 9)
    c, dlu, da = _grads(lu, a, g)
    assert c.grad_fn is not None
    expect = tri_pallas._tri_bwd(True, None, None, None,
                                 (jnp.asarray(lu), jnp.asarray(a)), jnp.asarray(g))
    _close(dlu, expect[0], 1e-10)
    _close(da, expect[1], 1e-10)


@pytest.mark.parametrize("per_factor", [False, True], ids=["shared", "per_factor"])
@pytest.mark.parametrize("m_dim", [40, 1100])
def test_dlu_is_tril_of_the_dense_gradient(m_dim, per_factor):
    """Every strictly-upper dLu entry is exactly 0: below MIN_DIM the whole
    strict upper triangle, above it the strict upper parts of the diagonal
    panels too, where the panel einsums do produce values; the rest of dLu
    and da against jax.vjp of the dense product through tril(Lu)."""
    lu, a, g = _operands(7 + m_dim, 3, m_dim, 11, per_factor)
    _, dlu, da = _grads(lu, a, g)
    upper = np.triu(np.ones((m_dim, m_dim), dtype=bool), 1)
    assert (dlu.numpy()[:, upper] == 0).all()
    spec = "lkm,lkb->lmb" if per_factor else "lkm,kb->lmb"
    _, vjp = jax.vjp(lambda l_, a_: jnp.einsum(spec, jnp.tril(l_), a_),
                     jnp.asarray(lu), jnp.asarray(a))
    e_dlu, e_da = vjp(jnp.asarray(g))
    _close(dlu, jnp.tril(e_dlu), 1e-10)
    _close(da, e_da, 1e-10)


@pytest.mark.parametrize("m_dim", [40, 1100])
def test_dense_einsum_gradient_differs_above_the_diagonal(m_dim):
    """The control: autograd of the panel einsums (the CPU route before
    TriTMatmul) puts nonzero entries above dLu's diagonal, in the diagonal
    panels; the contract's dLu has none."""
    lu, a, g = _operands(3, 2, m_dim, 7)
    lu_t = T(lu, requires_grad=True)
    tri_blocked.tri_t_matmul(lu_t, T(a)).backward(T(g))
    upper = np.triu(np.ones((m_dim, m_dim), dtype=bool), 1)
    assert (lu_t.grad.numpy()[:, upper] != 0).any()
    _, dlu, _ = _grads(lu, a, g)
    _close(dlu, torch.tril(lu_t.grad), 1e-12)


@pytest.mark.parametrize("needs", [(True, False), (False, True)], ids=["lu", "a"])
def test_only_the_asked_gradient_is_computed(monkeypatch, needs):
    calls = []
    plain = tri_cuda.tri_t_matmul_bwd_plain

    def spy(*args):
        calls.append(tuple(args[-1]))
        return plain(*args)

    monkeypatch.setattr(tri_cuda, "tri_t_matmul_bwd_plain", spy)
    lu, a, g = _operands(5, 2, 30, 6, per_factor=True)
    _, dlu, da = _grads(lu, a, g, *needs)
    assert calls == [needs]
    assert (dlu is not None, da is not None) == needs


def _tf32_rna(v):
    """Round-to-nearest, ties away from zero, to TF32's 11 significant bits,
    in float64 from the frexp decomposition (independent of the bit trick
    of ``split_tf32``)."""
    mant, exp = np.frexp(np.abs(v.astype(np.float64)))
    return (np.sign(v) * np.floor(mant * 2.0 ** 11 + 0.5) * 2.0 ** (exp - 11)).astype(
        np.float32)


@pytest.mark.parametrize("shape", [(2, 1, 64), (2, 257, 129), (1, 130, 33)])
def test_split_plain_layout_and_rounding(shape):
    """``tri_split_plain``: rows (2, L, M, Bp) and rows_t (2, L, B, Mp) hold
    the TF32 hi and lo parts of g and gᵀ, zeros in the padding; hi is g
    rounded to nearest with ties away from zero (``cvt.rna``), lo the
    remainder rounded the same way, against float64 rounding and
    ``split_tf32``."""
    l_dim, m_dim, b_dim = shape
    rng = np.random.default_rng(sum(shape))
    g = rng.standard_normal(shape).astype(np.float32)
    # ties: values exactly halfway between two TF32 numbers, both signs
    g.reshape(-1)[:4] = np.float32([1 + 2.0 ** -11, -(1 + 2.0 ** -11),
                                    1 + 3 * 2.0 ** -11, -(1 + 3 * 2.0 ** -11)])[:g.size]
    op = tri_cuda.tri_split(T(g), transposed=True)
    bp, mp = tri_cuda.padded_b(b_dim), tri_cuda.padded(m_dim)
    assert op.rows.shape == (2, l_dim, m_dim, bp) and op.rows_t.shape == (2, l_dim, b_dim, mp)
    assert op.b == b_dim
    hi = _tf32_rna(g)
    lo = _tf32_rna(g - hi)
    np.testing.assert_array_equal(op.rows[0, ..., :b_dim].numpy(), hi)
    np.testing.assert_array_equal(op.rows[1, ..., :b_dim].numpy(), lo)
    assert (op.rows[..., b_dim:] == 0).all() and (op.rows_t[..., m_dim:] == 0).all()
    assert torch.equal(op.rows_t[..., :m_dim], op.rows[..., :b_dim].mT)
    for got, ref in zip(op.rows[..., :b_dim], tri_cuda.split_tf32(T(g))):
        assert torch.equal(got, ref)
    assert (op.rows[0].view(torch.int32) & 0x1FFF == 0).all()
    np.testing.assert_array_equal(op.rows[0, 0, 0, :2].numpy()[:min(2, b_dim)],
                                  np.float32([1 + 2.0 ** -10, -(1 + 2.0 ** -10)])[:min(2, b_dim)])
    assert torch.allclose(op.dense(), T(g), rtol=2.0 ** -21, atol=0)  # hi + lo = g to 2⁻²²
    assert tri_cuda.tri_split(T(g)).rows_t is None


def test_wrapper_guards_refuse_before_any_launch():
    """Off the CPU a tensor goes to the kernel or raises: on ``meta`` every
    malformed or kernel-less call raises and no counter moves."""
    lu = torch.zeros((2, 5, 5), device="meta")
    a = torch.zeros((5, 3), device="meta")
    g = torch.zeros((2, 5, 3), device="meta")
    counters = (tri_cuda.tri_split, tri_cuda.tri_dlu, tri_cuda.tri_da, tri_cuda.tri_t_matmul)
    before = [fn.launches for fn in counters]
    with pytest.raises(ValueError):  # no kernel for meta
        tri_cuda.tri_split(g)
    with pytest.raises(ValueError):
        tri_cuda.tri_split(g[0])
    with pytest.raises(ValueError):
        tri_cuda.tri_t_matmul_bwd(lu, a, g)
    with pytest.raises(ValueError):  # g of another shape
        tri_cuda.tri_t_matmul_bwd(lu, a, g[:, :4])
    with pytest.raises(ValueError):  # a per factor needs L factors
        tri_cuda.tri_t_matmul_bwd(lu, torch.zeros((1, 5, 3), device="meta"), g)
    with pytest.raises(ValueError):  # g on the CPU
        tri_cuda.tri_t_matmul_bwd(lu, a, torch.zeros((2, 5, 3)))
    with pytest.raises(ValueError):
        tri_cuda.tri_t_matmul(lu.requires_grad_(), a)
    assert [fn.launches for fn in counters] == before
