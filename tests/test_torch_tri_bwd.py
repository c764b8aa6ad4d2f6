"""The backward of kernel 1 (JAX's ``tri_pallas._fused_bwd``) on the CPU.

On the card ``TriSqColsum.backward`` runs three launches of tri.cu's main
loop: the dc epilogue of kernel 2 (dc = 2c·g, stored split into TF32 hi
and lo), kernel 6 (dLu = tril(a·dcᵀ)) and kernel 7 (the per-factor
da = Lu·dc over the lower triangle). None can run here. What can:

- their plain versions (``tri_cuda.tri_dc_plain``, ``tri_dlu_plain``,
  ``tri_da_plain``), the CPU route and the card's reference, against
  ``jax.vjp`` of the interpreted Pallas kernel and of the panel-blocked
  colsum in float64 at 1e-8;
- a float32 emulation of the kernels' arithmetic (the operand split, three
  TF32 products, each stage of 32 summed into the total in float32)
  against JAX at TOL_TRI, with one TF32 product as a control that fails;
- the kernels' tile schedules and epilogue stores, replayed with tri.cu's
  own index arithmetic: what each block writes, and that every element of
  dLu, da, dc and dcᵀ is written once, zeros where the layout says;
- the layout of dc, and the wrappers' operand guards.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _tri_decodes import B_REPLAY, M_REPLAY, da_block, dc_block, dlu_block

from gpzoo_tpu.ops import tri_blocked as jtri
from gpzoo_tpu.ops import tri_pallas

from gpzoo_tpu_torch.ops import tri_blocked, tri_cuda

# As tests/test_torch_tri_tf32.py: the kernels are held to 1e-4 of the
# largest entry on the card (chip_smoke.py's TOL_TRI); three TF32 products
# summed in float32 stage by stage come to ~1e-6, one TF32 product to ~1e-4.
TOL_TRI = 1e-4
TOL_F64 = 1e-8
TK = 32  # tri.cu: k (b, m) per stage of the main loop
TILE = 128


def _operands(rng, L, M, B, per_factor):
    lu = np.tril(rng.standard_normal((L, M, M))) / np.sqrt(M)
    a = rng.standard_normal((L, M, B) if per_factor else (M, B))
    g = rng.standard_normal((L, B))
    return lu, a, g


def _jax_grads(lu, a, g, fused=False):
    """(dLu tril-masked, da) of colsum((Luᵀa)²) by ``jax.vjp``: of the
    interpreted Pallas kernel (its ``_fused_bwd``) or of the panel-blocked
    form it differentiates."""
    lu, a, g = jnp.asarray(lu), jnp.asarray(a), jnp.asarray(g)
    if fused:
        # the custom_vjp's own rules, forward interpreted: under x64 its
        # float32 output would refuse the float64 cotangent at jax.vjp
        _, res = tri_pallas._fused_fwd(lu, a, True, None, None, None)
        dlu, da = tri_pallas._fused_bwd(True, None, None, None, res, g)
    else:
        _, vjp = jax.vjp(jtri.tri_sq_colsum, lu, a)
        dlu, da = vjp(g)
    return np.tril(np.asarray(dlu)), np.asarray(da)


def _norm_err(got, ref):
    got = got.double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _t(x, dtype=torch.float64):
    return torch.tensor(x, dtype=dtype)


# M below MIN_DIM (one panel) and above it (six panels); ragged M and B
PLAIN_CASES = [(2, 40, 24), (2, 257, 129), (2, 1030, 37), (3, 1, 5)]


@pytest.mark.parametrize("per_factor", [False, True])
@pytest.mark.parametrize("L,M,B", PLAIN_CASES)
def test_plain_backward_matches_jax_vjp(rng, L, M, B, per_factor):
    lu, a, g = _operands(rng, L, M, B, per_factor)
    ref_dlu, ref_da = _jax_grads(lu, a, g)
    dc = tri_cuda.tri_dc_plain(_t(lu), _t(a), _t(g))
    dlu = tri_cuda.tri_dlu_plain(_t(a), dc)
    da = tri_cuda.tri_da_plain(_t(lu), dc, shared=not per_factor)
    assert dlu.shape == (L, M, M) and da.shape == a.shape
    assert _norm_err(dlu, ref_dlu) <= TOL_F64
    assert _norm_err(da, ref_da) <= TOL_F64
    # dc is the cotangent of c = Luᵀa
    c = np.asarray(jtri.tri_t_matmul_b(jnp.asarray(lu), jnp.asarray(a)))
    assert _norm_err(dc, 2 * g[:, None, :] * c) <= TOL_F64


@pytest.mark.parametrize("L,M,B", PLAIN_CASES[:3])
def test_plain_backward_matches_the_interpreted_pallas_vjp(rng, L, M, B):
    # tri_sq_colsum_fused takes a shared a only; its vjp runs on the saved
    # float64 operands
    lu, a, g = _operands(rng, L, M, B, False)
    ref_dlu, ref_da = _jax_grads(lu, a, g, fused=True)
    dc = tri_cuda.tri_dc_plain(_t(lu), _t(a), _t(g))
    assert _norm_err(tri_cuda.tri_dlu_plain(_t(a), dc), ref_dlu) <= TOL_F64
    assert _norm_err(tri_cuda.tri_da_plain(_t(lu), dc, shared=True), ref_da) <= TOL_F64


@pytest.mark.parametrize("per_factor", [False, True])
@pytest.mark.parametrize("L,M,B", PLAIN_CASES)
def test_tri_sq_colsum_backward_on_the_cpu_route(rng, L, M, B, per_factor):
    lu, a, g = _operands(rng, L, M, B, per_factor)
    ref_dlu, ref_da = _jax_grads(lu, a, g)
    lu_t = _t(lu).requires_grad_()
    a_t = _t(a).requires_grad_()
    tri_cuda.tri_sq_colsum(lu_t, a_t).backward(_t(g))
    assert _norm_err(lu_t.grad, ref_dlu) <= TOL_F64
    assert _norm_err(a_t.grad, ref_da) <= TOL_F64
    # only what needs a gradient is formed
    lu_t = _t(lu).requires_grad_()
    tri_cuda.tri_sq_colsum(lu_t, _t(a)).backward(_t(g))
    assert _norm_err(lu_t.grad, ref_dlu) <= TOL_F64


@pytest.mark.parametrize("L,M,B", PLAIN_CASES)
def test_tri_da_shared_is_the_sum_over_factors(rng, L, M, B):
    # a shared a's da, on the card kernel 7's output summed over l
    lu, a, g = _operands(rng, L, M, B, False)
    _, ref_da = _jax_grads(lu, a, g)
    dc = tri_cuda.tri_dc(_t(lu), _t(a), _t(g))
    shared = tri_cuda.tri_da(_t(lu), dc, shared=True)
    assert shared.shape == (M, B)
    assert _norm_err(shared, ref_da) <= TOL_F64
    assert _norm_err(tri_cuda.tri_da(_t(lu), dc).sum(0), ref_da) <= TOL_F64


def test_tri_da_plain_reads_the_lower_triangle_only(rng):
    lu, a, g = _operands(rng, 2, 1030, 17, True)
    dc = tri_cuda.tri_dc_plain(_t(lu), _t(a), _t(g))
    upper = np.triu(rng.standard_normal(lu.shape), 1)
    np.testing.assert_array_equal(tri_cuda.tri_da_plain(_t(lu + upper), dc).numpy(),
                                  tri_cuda.tri_da_plain(_t(lu), dc).numpy())


# ---------------------------------------------------------------------------
# the kernels' 3xTF32 arithmetic, emulated in float32
# ---------------------------------------------------------------------------

def _mma(a_parts, b_parts, products):
    """A·Bᵀ as tri.cu's main loop sums it: the contraction (last axis) in
    stages of 32, each stage's products (lo·hi, hi·lo, hi·hi, or hi·hi
    alone) summed in float32, then added into the float32 total."""
    (a_hi, a_lo), (b_hi, b_lo) = a_parts, b_parts
    tot = None
    for k0 in range(0, a_hi.shape[-1], TK):
        s = slice(k0, k0 + TK)
        acc = torch.matmul(a_hi[..., s], b_hi[..., s].mT)
        if products == "3x":
            acc = (torch.matmul(a_lo[..., s], b_hi[..., s].mT)
                   + torch.matmul(a_hi[..., s], b_lo[..., s].mT) + acc)
        tot = acc if tot is None else tot + acc
    return tot


def _dc_layout(dc, transposed=False):
    """The layout of ``tri_cuda.DcOperand`` that the dc epilogue writes, in
    plain PyTorch, from a float32 dc (L, M, B): rows padded with zeros to
    Bp = ``padded_b`` (B) (and dcᵀ's to Mp = ``padded`` (M)), then split
    into TF32 hi and lo parts."""
    l_dim, m_dim, b_dim = dc.shape
    rows = dc.new_zeros((l_dim, m_dim, tri_cuda.padded_b(b_dim)))
    rows[..., :b_dim] = dc
    rows_t = None
    if transposed:
        rows_t = dc.new_zeros((l_dim, b_dim, tri_cuda.padded(m_dim)))
        rows_t[..., :m_dim] = dc.mT
        rows_t = torch.stack(tri_cuda.split_tf32(rows_t))
    return tri_cuda.DcOperand(torch.stack(tri_cuda.split_tf32(rows)), rows_t, b_dim)


def _emulate(lu, a, g, products):
    """(dc, dLu, da) of the three kernels in float32: kernel 2 over the
    staged LuT and aT, the dc epilogue (2g·c, split and laid out as
    DcOperand), kernel 6 over a's rows padded to Bp, kernel 7 over Lu's
    rows, tril and padded to Mp."""
    L, M, _ = lu.shape
    B = a.shape[-1]
    lut, at = tri_cuda.stage_plain(lu, a)
    c = _mma(lut, at, products)[:, :M, :B]  # (L, M, B)
    dc_op = _dc_layout(c * (2 * g)[:, None, :], transposed=True)
    a_rows = a.new_zeros(a.shape[:-1] + (tri_cuda.padded_b(B),))
    a_rows[..., :B] = a
    dlu = torch.tril(_mma(tri_cuda.split_tf32(a_rows), dc_op.rows, products))
    mp = tri_cuda.padded(M)
    lu_rows = lu.new_zeros((L, mp, mp))
    lu_rows[:, :M, :M] = torch.tril(lu)
    da = _mma(tri_cuda.split_tf32(lu_rows), dc_op.rows_t, products)[:, :M]
    return dc_op.dense(), dlu, da


@pytest.mark.parametrize("per_factor", [False, True])
@pytest.mark.parametrize("L,M,B", [(2, 300, 129), (2, 257, 64), (1, 1, 5)])
def test_3xtf32_backward_matches_jax(rng, L, M, B, per_factor):
    lu, a, g = _operands(rng, L, M, B, per_factor)
    ref_dlu, ref_da = _jax_grads(lu, a, g)
    c = np.asarray(jtri.tri_t_matmul_b(jnp.asarray(lu), jnp.asarray(a)))
    ref_dc = 2 * g[:, None, :] * c
    f32 = dict(dtype=torch.float32)
    got = _emulate(_t(lu, **f32), _t(a, **f32), _t(g, **f32), "3x")
    control = _emulate(_t(lu, **f32), _t(a, **f32), _t(g, **f32), "1x")
    for what, ref, out, ctl in zip(("dc", "dLu", "da"), (ref_dc, ref_dlu, None),
                                   got, control):
        if ref is None:  # da: per factor, summed over l for a shared a
            ref = ref_da
            out = out if per_factor else out.sum(0)
            ctl = ctl if per_factor else ctl.sum(0)
        err = _norm_err(out, ref)
        assert err <= TOL_TRI, (what, err)
        if M > 1:  # one TF32 product fails TOL_TRI (3-5e-4 here); three pass it
            assert _norm_err(ctl, ref) > max(TOL_TRI, 100 * err), what


# ---------------------------------------------------------------------------
# the tile schedules and epilogue stores, replayed with tri.cu's arithmetic
# ---------------------------------------------------------------------------

def _fragments():
    """(row, column) in the 128 x 128 tile of every accumulator fragment
    the consumers hold: warp w of the two warpgroups, lane, fragment i of
    wgmma's m64n128 layout (row lane/4, +8 for i%4 >= 2, of the warp's 16;
    column 8 (i/4) + 2 (lane%4) + i%2)."""
    w, lane, i = np.meshgrid(np.arange(8), np.arange(32), np.arange(64), indexing="ij")
    row = (w // 4) * 64 + (w % 4) * 16 + lane // 4 + 8 * ((i % 4) >= 2)
    col = 8 * (i // 4) + 2 * (lane % 4) + i % 2
    return row.ravel(), col.ravel()


ROW, COL = _fragments()


def test_fragments_cover_the_tile_once():
    counts = np.zeros((TILE, TILE), np.int64)
    np.add.at(counts, (ROW, COL), 1)
    assert (counts == 1).all()


_da_block = da_block  # tri_mma_kernel<kDa>'s block decode: (l, kt, bt)




@pytest.mark.parametrize("M", M_REPLAY)
def test_dlu_schedule_writes_every_element_once(M):
    L = 2
    mp = tri_cuda.padded(M)
    nrt = mp // TILE
    grid = L * (nrt * (nrt + 1) // 2)  # tri_dlu_f32's launch
    writes = np.zeros(L * M * M, np.int64)
    summed = np.zeros(L * M * M, bool)
    seen = set()
    for bid in range(grid):
        l, kt, mt = dlu_block(bid, nrt)
        assert 0 <= mt <= kt < nrt and l < L
        seen.add((l, kt, mt))
        k, m = kt * TILE + ROW, mt * TILE + COL
        keep = (k < M) & (m < M)
        idx = (l * M + k[keep]) * M + m[keep]
        np.add.at(writes, idx, 1)
        summed[idx] = k[keep] >= m[keep]
        if kt > mt:  # the mirror tile above the diagonal: zeros
            k2, m2 = mt * TILE + ROW, kt * TILE + COL
            keep = (k2 < M) & (m2 < M)
            np.add.at(writes, (l * M + k2[keep]) * M + m2[keep], 1)
    assert len(seen) == grid  # each tile pair of each factor once
    assert (writes == 1).all()
    k_idx, m_idx = np.meshgrid(np.arange(M), np.arange(M), indexing="ij")
    # the sum exactly where k >= m, exact zeros above the diagonal
    np.testing.assert_array_equal(summed.reshape(L, M, M), np.broadcast_to(
        k_idx >= m_idx, (L, M, M)))


@pytest.mark.parametrize("B", B_REPLAY)
def test_dlu_contraction_covers_the_padded_rows(B):
    # kernel 6's k loop runs nk = Bp / 32 whole stages over a and dc rows
    # whose padding b >= B holds zeros (staged a; dc's epilogue)
    bp = tri_cuda.padded_b(B)
    nk = bp // TK
    assert nk * TK == bp and B <= bp < B + 32 and (bp * 4) % 128 == 0


@pytest.mark.parametrize("B", B_REPLAY)
@pytest.mark.parametrize("M", M_REPLAY)
def test_da_schedule_writes_every_element_once(M, B):
    L = 2 if M * B < 10**6 else 1
    mp = tri_cuda.padded(M)
    nrt, nct = mp // TILE, -(-B // TILE)
    grid = L * nct * nrt  # tri_da_f32's launch
    writes = np.zeros(L * M * B, np.int64)
    for bid in range(grid):
        l, kt, bt = _da_block(bid, nrt, nct)
        # the m loop: stages [0, (kt + 1) * 4), all that rows k of the tile
        # need (m <= k), inside what stage_lu_rows_kernel wrote for them
        m_end = (kt + 1) * TILE
        rows = kt * TILE + np.arange(TILE)
        assert m_end == (rows // TILE + 1).max() * TILE and m_end <= mp
        k, b = kt * TILE + ROW, bt * TILE + COL
        keep = (k < M) & (b < B)
        np.add.at(writes, (l * M + k[keep]) * B + b[keep], 1)
    assert (writes == 1).all()


def _dc_replay(L, M, B):
    """What the dc epilogue writes, by the kDc epilogue's loops and masks:
    counts of writes and of real (not padding) values into dc (L, M, Bp)
    and dcT (L, B, Mp). Its 256 consumer threads t write dc's rows m < M
    at column t % 128, rows t // 128 + 2 i, up to Bp; and dcT's rows b < B
    at tile row (m) t % 128, columns t // 128 + 2 i."""
    mp, bp = tri_cuda.padded(M), tri_cuda.padded_b(B)
    nrt, nct = mp // TILE, -(-B // TILE)
    dc_w = np.zeros(L * M * bp, np.int64)
    dc_real = np.zeros(L * M * bp, bool)
    dct_w = np.zeros(L * B * mp, np.int64)
    dct_real = np.zeros(L * B * mp, bool)
    t = np.arange(256)
    i = np.arange(TILE // 2)
    across = (t % TILE)[:, None] + 0 * i       # the thread's fixed index
    along = (t // TILE)[:, None] + 2 * i       # its loop over the other one
    for bid in range(nrt * L * nct):
        l, mt, bt = dc_block(bid, nrt, nct)
        b, m = bt * TILE + across, mt * TILE + along  # dc's pass
        keep = (b < bp) & (m < M)
        idx = (l * M + m[keep]) * bp + b[keep]
        np.add.at(dc_w, idx, 1)
        dc_real[idx] = b[keep] < B
        m, b = mt * TILE + across, bt * TILE + along  # dcT's pass
        keep = b < B
        idx = (l * B + b[keep]) * mp + m[keep]
        np.add.at(dct_w, idx, 1)
        dct_real[idx] = m[keep] < M
    return dc_w, dc_real, dct_w, dct_real


@pytest.mark.parametrize("B", B_REPLAY)
@pytest.mark.parametrize("M", [1, 127, 257, 3010])
def test_dc_epilogue_writes_the_layout_once(M, B):
    L = 2 if M * B < 10**6 else 1
    mp, bp = tri_cuda.padded(M), tri_cuda.padded_b(B)
    dc_w, dc_real, dct_w, dct_real = _dc_replay(L, M, B)
    assert (dc_w == 1).all() and (dct_w == 1).all()
    # real values exactly at b < B (dc) and m < M (dcT), zeros in the padding
    np.testing.assert_array_equal(dc_real.reshape(L, M, bp),
                                  np.broadcast_to(np.arange(bp) < B, (L, M, bp)))
    np.testing.assert_array_equal(dct_real.reshape(L, B, mp),
                                  np.broadcast_to(np.arange(mp) < M, (L, B, mp)))


@pytest.mark.parametrize("M,B", [(1, 1), (257, 129), (130, 32), (40, 7000)])
def test_dc_layout_padding_and_stride(rng, M, B):
    L = 2
    dc = torch.tensor(rng.standard_normal((L, M, B)), dtype=torch.float32)
    op = _dc_layout(dc, transposed=True)
    bp, mp = tri_cuda.padded_b(B), tri_cuda.padded(M)
    assert bp % 32 == 0 and (bp * 4) % 16 == 0 and B <= bp < B + 32
    assert op.rows.shape == (2, L, M, bp) and op.rows_t.shape == (2, L, B, mp)
    assert op.rows.is_contiguous() and op.rows_t.is_contiguous() and op.b == B
    assert bool((op.rows[..., B:] == 0).all()) and bool((op.rows_t[..., M:] == 0).all())
    for part in (op.rows, op.rows_t):  # TF32 values: 13 low mantissa bits clear
        assert bool(((part.view(torch.int32) & 0x1FFF) == 0).all())
    np.testing.assert_allclose(op.dense().double().numpy(), dc.double().numpy(),
                               rtol=2.0**-22, atol=0)
    t = (op.rows_t[0] + op.rows_t[1])[..., :M]
    np.testing.assert_array_equal(t.numpy(), op.dense().mT.numpy())
    assert _dc_layout(dc).rows_t is None


# ---------------------------------------------------------------------------
# the wrappers' guards
# ---------------------------------------------------------------------------

def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _meta_dc(L, M, B, dtype=torch.float32, transposed=True):
    return tri_cuda.DcOperand(
        _meta((2, L, M, tri_cuda.padded_b(B)), dtype),
        _meta((2, L, B, tri_cuda.padded(M)), dtype) if transposed else None, B)


def test_tri_dc_refuses_what_the_kernel_does_not_take():
    lu, a, g = _meta((2, 9, 9)), _meta((2, 9, 5)), _meta((2, 5))
    with pytest.raises(TypeError, match="float32"):
        tri_cuda.tri_dc(_meta((2, 9, 9), torch.float64), a, g)
    with pytest.raises(ValueError, match="contiguous"):
        tri_cuda.tri_dc(lu, _meta((2, 5, 9)).mT, g)
    with pytest.raises(ValueError, match="is on"):  # mixed devices
        tri_cuda.tri_dc(torch.zeros(2, 9, 9), a, g)
    with pytest.raises(ValueError, match="is on"):
        tri_cuda.tri_dc(lu, a, torch.zeros(2, 5))
    with pytest.raises(ValueError, match="CUDA"):
        tri_cuda.tri_dc(lu, a, g)
    with pytest.raises(ValueError, match="g must be"):
        tri_cuda.tri_dc(lu, a, _meta((2, 6)))


def test_tri_dlu_refuses_what_the_kernel_does_not_take():
    a, dc = _meta((2, 9, 5)), _meta_dc(2, 9, 5)
    with pytest.raises(TypeError, match="float32"):
        tri_cuda.tri_dlu(_meta((2, 9, 5), torch.float64), dc)
    with pytest.raises(TypeError, match="float32"):
        tri_cuda.tri_dlu(a, _meta_dc(2, 9, 5, torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        tri_cuda.tri_dlu(_meta((2, 5, 9)).mT, dc)
    with pytest.raises(ValueError, match="is on"):
        tri_cuda.tri_dlu(a, tri_cuda.DcOperand(torch.zeros(2, 2, 9, 32), None, 5))
    with pytest.raises(ValueError, match="a must be"):
        tri_cuda.tri_dlu(_meta((2, 9, 6)), dc)
    with pytest.raises(TypeError, match="DcOperand"):  # a dense dc on the card route
        tri_cuda.tri_dlu(a, _meta((2, 9, 5)))
    with pytest.raises(TypeError, match="on the CPU"):
        tri_cuda.tri_dlu(torch.zeros(2, 9, 5), dc)
    with pytest.raises(ValueError, match="CUDA"):
        tri_cuda.tri_dlu(a, dc)


def test_tri_da_refuses_what_the_kernel_does_not_take():
    lu, dc = _meta((2, 9, 9)), _meta_dc(2, 9, 5)
    with pytest.raises(TypeError, match="float32"):
        tri_cuda.tri_da(_meta((2, 9, 9), torch.float64), dc)
    with pytest.raises(ValueError, match="contiguous"):
        tri_cuda.tri_da(_meta((2, 9, 9)).mT, dc)
    with pytest.raises(ValueError, match="is on"):
        tri_cuda.tri_da(lu, tri_cuda.DcOperand(torch.zeros(2, 2, 9, 32),
                                               torch.zeros(2, 2, 5, 128), 5))
    with pytest.raises(TypeError, match="transposed"):  # no dcT
        tri_cuda.tri_da(lu, _meta_dc(2, 9, 5, transposed=False))
    with pytest.raises(ValueError, match="lu must be"):
        tri_cuda.tri_da(_meta((3, 9, 9)), dc)
    with pytest.raises(ValueError, match="is on"):
        tri_cuda.tri_da(torch.zeros(2, 9, 9), torch.zeros(2, 9, 5, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        tri_cuda.tri_da(lu, dc)


def test_touched_modules_import_neither_jax_nor_the_jax_package():
    root = Path(__file__).resolve().parents[1]
    for path in (root / "gpzoo_tpu_torch" / "ops" / "tri_cuda.py",
                 root / "gpzoo_tpu_torch" / "ops" / "tri_blocked.py",
                 root / "chip_smoke.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "gpzoo_tpu"), (path.name, name)


def test_plain_forms_keep_tri_blocked_panels():
    # six panels above MIN_DIM, one below: the panels of JAX's vjp
    assert len(tri_blocked._panels(1030)) == 6 and len(tri_blocked._panels(1023)) == 1
