"""The 3xTF32 arithmetic of kernels 1-2 (``csrc/tri.cu``) on the CPU.

The card's kernels stage Luᵀ and aᵀ K-major, split each value into TF32
hi and lo parts, and sum lo·hi + hi·lo + hi·hi in float32. Here the plain
staging pass (``tri_cuda.stage_plain``) is checked for layout and
rounding, and a float32 emulation of the three products is held against
the JAX package's panel-blocked contractions in float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpzoo_tpu.ops import tri_blocked as jtri

from gpzoo_tpu_torch.ops import tri_cuda

# Dropping lo·lo and rounding lo to TF32 each cost ≤ 2⁻²² of a product, and
# a float32 accumulation over M ≤ 300 terms ~sqrt(M)·2⁻²⁴: about 1e-6 of
# max|c| in all. TOL_TRI (chip_smoke.py) holds the card's kernels to 1e-4;
# the emulation must meet the same bound, which one TF32 product (2⁻¹¹ per
# operand, ~3e-4 here) does not.
TOL_TRI = 1e-4
SHAPES = [(2, 300, 64), (2, 257, 129), (1, 1, 5)]


def _operands(rng, L, M, B, per_factor):
    lu = np.tril(rng.standard_normal((L, M, M))) / np.sqrt(M)
    a = rng.standard_normal((L, M, B) if per_factor else (M, B))
    return lu, a


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def _emulate(lu, a, products):
    """c = Luᵀa from the staged operands in float32, as the kernel sums
    it: lo·hi, hi·lo, then hi·hi (``products="3x"``), or hi·hi alone."""
    (lu_hi, lu_lo), (a_hi, a_lo) = tri_cuda.stage_plain(lu, a)
    c = torch.matmul(lu_hi, a_hi.mT)
    if products == "3x":
        c = torch.matmul(lu_lo, a_hi.mT) + torch.matmul(lu_hi, a_lo.mT) + c
    return c[:, :lu.shape[-1], :a.shape[-1]]


def _norm_err(got, ref):
    ref = np.asarray(ref)
    return float(np.max(np.abs(got.double().numpy() - ref)) / np.max(np.abs(ref)))


def _tf32_reference(x):
    """Round-to-nearest, ties away from zero, to 10 mantissa bits, in
    float64 arithmetic (independent of the bit trick under test)."""
    x = np.asarray(x, dtype=np.float64)
    q = np.exp2(np.floor(np.log2(np.abs(x))) - 10)
    return np.sign(x) * np.floor(np.abs(x) / q + 0.5) * q


@pytest.mark.parametrize("per_factor", [False, True])
@pytest.mark.parametrize("L,M,B", SHAPES)
def test_stage_plain_transposes(rng, L, M, B, per_factor):
    lu, a = _operands(rng, L, M, B, per_factor)
    lut, at = tri_cuda.stage_plain(_f32(lu), _f32(a))
    mp = tri_cuda.padded(M)
    assert mp % 128 == 0 and M <= mp < M + 128
    assert lut.shape == (2, L, mp, mp)
    assert at.shape == (2, L if per_factor else 1, B, mp)
    lut_x = (lut[0].double() + lut[1].double())[:, :M, :M].numpy()
    at_x = (at[0].double() + at[1].double())[..., :M].numpy()
    np.testing.assert_allclose(lut_x, np.swapaxes(lu, -1, -2), rtol=2.0**-22, atol=0)
    a_t = np.swapaxes(a if per_factor else a[None], -1, -2)
    np.testing.assert_allclose(at_x, a_t, rtol=2.0**-22, atol=0)


@pytest.mark.parametrize("L,M,B", SHAPES)
def test_stage_plain_zeros_above_diagonal_and_in_padding(rng, L, M, B):
    lu, a = _operands(rng, L, M, B, True)
    # a full Lu: its strict upper triangle must not reach LuT
    full = lu + np.triu(rng.standard_normal((L, M, M)), 1)
    lut, at = tri_cuda.stage_plain(_f32(full), _f32(a))
    mp = lut.shape[-1]
    m_idx = torch.arange(mp)[:, None]
    k_idx = torch.arange(mp)[None, :]
    # LuT[m, k] is nonzero only for m ≤ k < M
    outside = (k_idx < m_idx) | (k_idx >= M) | (m_idx >= M)
    assert bool((lut[:, :, outside] == 0).all())
    assert bool((at[..., M:] == 0).all())
    assert tri_cuda._scratch(_f32(lu), _f32(a)).numel() == lut.numel() + at.numel()


def test_split_reconstructs_to_2_pow_minus_22(rng):
    x = rng.standard_normal(20_000) * np.exp2(rng.integers(-60, 60, 20_000))
    xt = _f32(x)
    hi, lo = tri_cuda.split_tf32(xt)
    err = np.abs(hi.double().numpy() + lo.double().numpy() - xt.double().numpy())
    assert np.all(err <= 2.0**-22 * np.abs(xt.double().numpy()))


def test_split_hi_has_ten_mantissa_bits_rounded_to_nearest_ties_away(rng):
    x = np.concatenate([
        rng.standard_normal(20_000) * np.exp2(rng.integers(-60, 60, 20_000)),
        # exact ties between two TF32 values, either sign, and their
        # neighbours one float32 ulp to either side
        [1 + 2.0**-11, -(1 + 2.0**-11), 3 * 2.0**-11 + 1, 1.5 + 2.0**-11,
         1 + 2.0**-11 - 2.0**-23, 1 + 2.0**-11 + 2.0**-23, -(1 + 2.0**-11 - 2.0**-23)],
    ]).astype(np.float32)
    hi, lo = tri_cuda.split_tf32(torch.from_numpy(x))
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((lo.view(torch.int32) & 0x1FFF) == 0).all())
    np.testing.assert_array_equal(hi.double().numpy(), _tf32_reference(x))
    np.testing.assert_array_equal(hi[-7:].double().numpy(),
                                  [1 + 2.0**-10, -(1 + 2.0**-10), 1 + 2 * 2.0**-10,
                                   1.5 + 2.0**-10, 1.0, 1 + 2.0**-10, -1.0])


@pytest.mark.parametrize("per_factor", [False, True])
@pytest.mark.parametrize("L,M,B", SHAPES)
def test_3xtf32_t_matmul_matches_jax(rng, L, M, B, per_factor):
    lu, a = _operands(rng, L, M, B, per_factor)
    ref = jtri.tri_t_matmul_b(jnp.asarray(lu), jnp.asarray(a))
    got = _emulate(_f32(lu), _f32(a), "3x")
    err = _norm_err(got, ref)
    assert err <= TOL_TRI
    if M > 1:  # one TF32 product is not float32-accurate; three are
        assert _norm_err(_emulate(_f32(lu), _f32(a), "1x"), ref) > 100 * err


@pytest.mark.parametrize("per_factor", [False, True])
@pytest.mark.parametrize("L,M,B", SHAPES)
def test_3xtf32_sq_colsum_matches_jax(rng, L, M, B, per_factor):
    lu, a = _operands(rng, L, M, B, per_factor)
    ref = jtri.tri_sq_colsum(jnp.asarray(lu), jnp.asarray(a))
    got = torch.sum(torch.square(_emulate(_f32(lu), _f32(a), "3x")), dim=-2)
    assert _norm_err(got, ref) <= TOL_TRI


def test_stage_refuses_cpu_tensors(rng):
    lu, a = _operands(rng, 2, 10, 4, False)
    with pytest.raises(ValueError, match="must be on"):
        tri_cuda.stage(_f32(lu), _f32(a))
