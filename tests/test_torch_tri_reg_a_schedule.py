"""The main loop of the dc epilogue and of kernels 6 and 7 on the CPU: what
can be checked of tri.cu's register-A instances (``reg_a``) without the card.

All three read their operand A in float32 (48 KB a stage: A f32, B hi, B lo)
and split it into TF32 hi and lo in registers, each thread loading its
wgmma A fragments from the 128-byte-swizzled tile that TMA wrote. These
tests replay, with tri.cu's own index arithmetic:

- the fragment addressing: each warpgroup's four warps read each element of
  their 64 rows once, as wgmma's m64k8 A fragments, from the address where
  the swizzle put it, and each shared-memory load hits 32 distinct banks;
- the dc epilogue's factor-major block decode, kernel 6's and kernel 7's
  (tests/_tri_decodes.py) at the replay shapes: every tile once, in the
  order the design relies on, and every element of dc, dcᵀ, dLu and da
  written once, padding zeros included (tests/test_torch_tri_bwd.py replays
  the stores thread by thread);
- kernel 7's operand: Lu's rows as ``stage_lu_rows_kernel`` stages them in
  float32 (zeros above the diagonal and in the padding, every element the
  m loop reads written once), read through the TMA box and the swizzle
  into each thread's fragments;
- the shared-memory and register budgets, and when kernel 6 reads a's rows
  in place.
"""

import re
from pathlib import Path

import numpy as np
import pytest
from _tri_decodes import B_REPLAY, M_REPLAY, da_block, dc_block, dlu_block

TRI_CU = Path(__file__).resolve().parents[1] / "gpzoo_tpu_torch" / "ops" / "csrc" / "tri.cu"
TILE, TK = 128, 32
SMEM_PER_BLOCK = 232_448  # an H100 block's most dynamic shared memory
REGS_PER_SM, REGS_PER_QUARTER = 65_536, 16_384


def _src():
    return TRI_CU.read_text()


def _const(name):
    """An integer ``constexpr int name = value;`` of tri.cu."""
    return int(re.search(rf"constexpr int {name} = (\d+);", _src()).group(1))


def _pad(x, to):
    return -(-x // to) * to


def _swizzled(row, k):
    """Where TMA's 128-byte swizzle puts f32 element (row, k) of a 32-wide
    tile, from the tile's 1024-byte-aligned start: 16-byte chunk k // 4 of
    128-byte row ``row`` goes to chunk (k // 4) ^ (row % 8)."""
    return row * 128 + (((k // 4) ^ (row % 8)) * 16) + (k % 4) * 4


def _fragment_reads():
    """(warp in the warpgroup, lane, kk, e) -> (row, k, byte address) as the
    kernel's consumers compute them."""
    w, lane, kk, e = np.meshgrid(np.arange(4), np.arange(32), np.arange(TK // 8),
                                 np.arange(4), indexing="ij")
    r = w * 16 + lane // 4
    row = r + 8 * (e & 1)
    k = 8 * kk + lane % 4 + 4 * (e >> 1)
    addr = row * 128 + (((k >> 2) ^ (row & 7)) << 4) + (k & 3) * 4
    return row, k, addr


def test_fragment_reads_follow_the_swizzle_and_cover_the_tile_once():
    row, k, addr = _fragment_reads()
    # the address the kernel reads is where the swizzle put (row, k)
    np.testing.assert_array_equal(addr, _swizzled(row, k))
    counts = np.zeros((64, TK), np.int64)
    np.add.at(counts, (row.ravel(), k.ravel()), 1)
    assert (counts == 1).all()
    # wgmma's m64k8 A fragment: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
    # a3 (g + 8, t + 4) of the warp's 16 rows, g = lane / 4, t = lane % 4
    w, lane = np.meshgrid(np.arange(4), np.arange(32), indexing="ij")
    g, t = w * 16 + lane // 4, lane % 4
    for e, (dr, dk) in enumerate([(0, 0), (8, 0), (0, 4), (8, 4)]):
        np.testing.assert_array_equal(row[..., 0, e], g + dr)
        np.testing.assert_array_equal(k[..., 0, e], t + dk)


def test_fragment_loads_are_free_of_bank_conflicts():
    _, _, addr = _fragment_reads()
    banks = (addr // 4) % 32  # (warp, lane, kk, e)
    for w in range(4):
        for kk in range(TK // 8):
            for e in range(4):
                assert len(set(banks[w, :, kk, e])) == 32


def test_the_kernel_reads_the_fragments_so():
    src = _src()
    for line in ("const int r = (warp % 4) * 16 + lane / 4;",
                 "const int row = r + 8 * (e & 1), k = 8 * kk + lane % 4 + 4 * (e >> 1);",
                 "lds_f32(a32 + row * 128 + (((k >> 2) ^ (row & 7)) << 4) + (k & 3) * 4)",
                 "const uint32_t a32 = tiles + s * kStageBytes + wg * (TILE_BYTES / 2);",
                 "return mode == kDc || mode == kDlu || mode == kDa;"):
        assert line in src, line


def test_shared_memory_and_register_budgets():
    tile_bytes = TILE * TK * 4
    stages = _const("REG_A_STAGES")
    assert "constexpr int REG_A_STAGE_BYTES = 3 * TILE_BYTES;" in _src()
    stage_bytes = 3 * tile_bytes  # A f32, B hi, B lo
    red = _const("CONSUMERS") * 4 * TILE * 4
    smem = 1024 + stages * stage_bytes + red + 2 * stages * 8
    assert stages == 4 and smem <= SMEM_PER_BLOCK
    assert TILE * (TILE + 1) * 4 <= stages * stage_bytes  # the dc epilogue's tile
    # every stage starts on a 1 KB swizzle atom, so do B hi and B lo
    assert stage_bytes % 1024 == 0 and tile_bytes % 1024 == 0
    producer, consumer = _const("REG_A_PRODUCER_REGS"), _const("REG_A_CONSUMER_REGS")
    assert 2 * 128 * consumer + 128 * producer <= REGS_PER_SM
    # the quarters each hold one warp of each of the three warpgroups
    assert 32 * (2 * consumer + producer) <= REGS_PER_QUARTER
    assert producer % 8 == 0 and consumer % 8 == 0 and 24 <= producer and consumer <= 256
    # the other instances: nine warps, three on one quarter, 168 registers
    assert 3 * 32 * 168 <= REGS_PER_QUARTER < 3 * 32 * 176


@pytest.mark.parametrize("B", B_REPLAY)
def test_kernel6_reads_a_in_place_on_a_16_byte_row_stride(B):
    # tri_dlu_f32 maps a's rows as they stand when 4 B bytes is a multiple of
    # 16 (TMA's stride rule), else copies them with the row stride Bp
    assert "if (B % 4 != 0) {" in _src()
    bp = _pad(B, 32)
    in_place = B % 4 == 0
    assert (4 * (B if in_place else bp)) % 16 == 0
    assert bp % TK == 0 and B <= bp < B + TK  # the k loop: whole stages over Bp


def test_decodes_mirror_tri_cu():
    src = _src()
    for line in ("l = blockIdx.x / (nct * nrt);", "ct = r / nrt;", "rt_begin = r % nrt;",
                 "const int pairs = nrt * (nrt + 1) / 2;",
                 "int kt = (int)((sqrtf(8.f * q + 1.f) - 1.f) * 0.5f);"):
        assert line in src, line
    # the dc epilogue's factor-major branch precedes kernel 2's row-tile order
    assert src.index("} else if constexpr (kMode == kDc) {") < src.index(
        "// kC: row tile slowest")


@pytest.mark.parametrize("B", B_REPLAY)
@pytest.mark.parametrize("M", M_REPLAY)
def test_dc_epilogue_schedule(M, B):
    L = 2 if M * B < 10**6 else 1
    mp, bp = _pad(M, TILE), _pad(B, 32)
    nrt, nct = mp // TILE, -(-B // TILE)
    grid = nrt * L * nct  # run<kDc>'s launch
    order = [dc_block(bid, nrt, nct) for bid in range(grid)]
    assert len(set(order)) == grid
    assert sorted(order) == sorted((l, mt, bt) for l in range(L) for mt in range(nrt)
                                   for bt in range(nct))
    # a factor's blocks are consecutive (its LuT, whole, stays in L2), a
    # column tile's row tiles run together, the longest k loop first
    assert [o[0] for o in order] == sorted(o[0] for o in order)
    for bid in range(0, grid, nrt):
        assert [o[1] for o in order[bid:bid + nrt]] == list(range(nrt))
        assert len({o[2] for o in order[bid:bid + nrt]}) == 1
    dc = np.zeros((L, M, bp), np.int8)     # rows m < M up to Bp, zeros at b >= B
    dct = np.zeros((L, B, mp), np.int8)    # rows b < B up to Mp, zeros at m >= M
    for l, mt, bt in order:
        m0, b0 = mt * TILE, bt * TILE
        dc[l, m0:m0 + TILE, b0:min(b0 + TILE, bp)] += 1
        dct[l, b0:min(b0 + TILE, B), m0:m0 + TILE] += 1
    assert (dc == 1).all() and (dct == 1).all()


@pytest.mark.parametrize("M", M_REPLAY)
def test_kernel6_schedule(M):
    L = 2
    mp = _pad(M, TILE)
    nrt = mp // TILE
    grid = L * (nrt * (nrt + 1) // 2)  # tri_dlu_f32's launch
    order = [dlu_block(bid, nrt) for bid in range(grid)]
    assert sorted(order) == sorted((l, kt, mt) for l in range(L) for kt in range(nrt)
                                   for mt in range(kt + 1))
    dlu = np.zeros((L, mp, mp), np.int8)
    for l, kt, mt in order:
        k0, m0 = kt * TILE, mt * TILE
        dlu[l, k0:k0 + TILE, m0:m0 + TILE] += 1
        if kt > mt:  # the mirror tile's zeros
            dlu[l, m0:m0 + TILE, k0:k0 + TILE] += 1
    assert (dlu == 1).all()


def _stage_lu_rows(lu, mp):
    """stage_lu_rows_kernel replayed with its own index arithmetic: block
    (x, k, l) of 256 threads, m = 256 x + thread; rows[l, k, m] = Lu[l, k, m]
    for m <= k < M, else 0, written for m below the end of k's row tile.
    Returns (rows (L, Mp, Mp) with NaN where nothing was written, write
    counts)."""
    L, M, _ = lu.shape
    rows = np.full((L, mp, mp), np.nan, np.float32)
    writes = np.zeros((L, mp, mp), np.int64)
    m = np.arange(-(-mp // 256) * 256)  # the grid's x blocks times 256 threads
    for l in range(L):
        for k in range(mp):
            mm = m[m < (k // TILE + 1) * TILE]
            real = (k < M) & (mm <= k)
            rows[l, k, mm] = np.where(real, lu[l, min(k, M - 1), np.minimum(mm, M - 1)], 0)
            writes[l, k, mm] += 1
    return rows, writes


@pytest.mark.parametrize("M", [1, 127, 128, 257, 529])
def test_kernel7_staging_zeros_and_covers_what_the_loop_reads(M):
    rng = np.random.default_rng(M)
    L, mp = 2, _pad(M, TILE)
    lu = rng.standard_normal((L, M, M)).astype(np.float32)
    rows, writes = _stage_lu_rows(lu, mp)
    # row k of row tile kt is read over the m stages [0, (kt + 1) * 128)
    k = np.arange(mp)[:, None]
    m = np.arange(mp)[None, :]
    read = m < (k // TILE + 1) * TILE
    assert (writes[:, read] == 1).all() and (writes[:, ~read] == 0).all()
    want = np.zeros((L, mp, mp), np.float32)
    want[:, :M, :M] = np.tril(lu)
    np.testing.assert_array_equal(rows[:, read], want[:, read])
    # Mp floats a row: a 16-byte multiple, as TMA's row stride must be (M
    # itself is not at the paths' 3,010 and 529)
    assert (4 * mp) % 16 == 0 and mp % TK == 0
    src = _src()
    assert "const float v = (k < M && m <= k) ? lu[((int64_t)l * M + k) * M + m] : 0.f;" in src
    assert "if (m >= (k / TM + 1) * TM) return;" in src
    # whole in f32 for the register-A loop; split where the grid is one wave
    assert "stage_lu_rows_kernel<true><<<rows_grid, 256, 0, st>>>(lu, scratch, nullptr, M, " \
        "p.Mp);" in src
    assert "stage_lu_rows_kernel<false><<<rows_grid, 256, 0, st>>>(lu, scratch, lo, M, " \
        "p.Mp);" in src


@pytest.mark.parametrize("M", [257, 529])
def test_kernel7_fragments_read_lu_rows_through_the_swizzle(M):
    rng = np.random.default_rng(7)
    L, mp = 2, _pad(M, TILE)
    lu = rng.standard_normal((L, M, M)).astype(np.float32)
    rows, _ = _stage_lu_rows(lu, mp)
    flat = rows.reshape(L * mp, mp)  # the map: L Mp rows of Mp floats
    wrow, wk, addr = _fragment_reads()
    for l in range(L):
        for kt in range(mp // TILE):
            for st in range(kt + 1) if M < 300 else (0, kt):
                for wg in range(2):
                    # TMA's box (32 m, 128 k rows) at (st * 32 m-stages, l Mp + kt 128)
                    box = flat[l * mp + kt * TILE:(l + 1) * mp][:TILE]
                    for s4 in range(TILE // TK):
                        stage = st * (TILE // TK) + s4
                        tile = np.zeros(TILE * TK, np.float32)
                        r, c = np.meshgrid(np.arange(TILE), np.arange(TK), indexing="ij")
                        tile[_swizzled(r, c) // 4] = box[r, stage * TK + c]
                        # warpgroup wg's 64 rows start at byte 64 * 128 wg
                        got = tile[(wg * 64 * 128 + addr) // 4]
                        k_abs = kt * TILE + wg * 64 + wrow
                        m_abs = stage * TK + wk
                        want = np.where((k_abs < M) & (m_abs <= k_abs),
                                        lu[l, np.minimum(k_abs, M - 1),
                                           np.minimum(m_abs, M - 1)], 0)
                        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("B", B_REPLAY)
@pytest.mark.parametrize("M", M_REPLAY)
def test_kernel7_schedule(M, B):
    L = 2 if M * B < 10**6 else 1
    mp = _pad(M, TILE)
    nrt, nct = mp // TILE, -(-B // TILE)
    grid = L * nct * nrt  # tri_da_f32's launch
    order = [da_block(bid, nrt, nct) for bid in range(grid)]
    assert sorted(order) == sorted((l, kt, bt) for l in range(L) for kt in range(nrt)
                                   for bt in range(nct))
    # factor-major (one factor's Lu rows, whole in f32, stay in L2), a
    # column tile's row tiles together, the longest m loop first
    assert [o[0] for o in order] == sorted(o[0] for o in order)
    for bid in range(0, grid, nrt):
        assert [o[1] for o in order[bid:bid + nrt]] == list(range(nrt))[::-1]
        assert len({o[2] for o in order[bid:bid + nrt]}) == 1
    da = np.zeros((L, mp, _pad(B, TILE)), np.int8)
    for l, kt, bt in order:
        da[l, kt * TILE:(kt + 1) * TILE, bt * TILE:(bt + 1) * TILE] += 1
    assert (da[:, :M, :B] == 1).all()


def test_kernel7_budgets():
    # the register-A instance: a producer warpgroup and two consumer ones
    # (384 threads), the 48 KB stages of the dc epilogue and kernel 6
    src = _src()
    assert "return reg_a(mode) ? 32 * CONSUMER_WARPS + 128 : THREADS;" in src
    assert "return reg_a(mode) ? REG_A_STAGES : STAGES;" in src
    # one factor's Lu rows in f32 at M = 3,010: 37.7 MB (Mp = 3,072), the
    # lower half (with the diagonal tiles) staged and read, ~19 MB: L2 (50 MB)
    mp = _pad(3010, TILE)
    nrt = mp // TILE
    staged = sum((kt + 1) * TILE * TILE * 4 for kt in range(nrt))
    assert staged < 20e6
    # the scratch: L Mp^2 floats, half a hi/lo split (0.75 GB at L = 20)
    assert 20 * mp * mp * 4 < 0.76e9
    assert "launch<kDa>(scratch, scratch, p.Mp, (uint64_t)L * p.Mp, dct," in src
    # a grid of one wave or less (Hybrid-NSF: 4 x 6 x 5 = 120 blocks on 132
    # SMs) takes the split staging and kernels 1-2's loop, 2 L Mp^2 floats
    assert "if ((int)grid.x <= sms) {" in src
    assert "return launch<kDaSplit>(scratch, lo, p.Mp, (uint64_t)L * p.Mp, dct, dct_lo, " \
        "p.Mp," in src
    assert "return mode == kDa || mode == kDaSplit;" in src
    for (L, M, B), one_wave in (((4, 529, 720), True), ((20, 3010, 7000), False),
                                ((10, 3010, 6000), False), ((20, 3010, 3500), False)):
        assert (L * (_pad(M, TILE) // TILE) * -(-B // TILE) <= 132) == one_wave
