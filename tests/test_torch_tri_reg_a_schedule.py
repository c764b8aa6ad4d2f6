"""The dc epilogue's and kernel 6's main loop on the CPU: what can be checked
of tri.cu's register-A instances (``reg_a``) without the card.

Both read their operand A in float32 (48 KB a stage: A f32, B hi, B lo)
and split it into TF32 hi and lo in registers, each thread loading its
wgmma A fragments from the 128-byte-swizzled tile that TMA wrote. These
tests replay, with tri.cu's own index arithmetic:

- the fragment addressing: each warpgroup's four warps read each element of
  their 64 rows once, as wgmma's m64k8 A fragments, from the address where
  the swizzle put it, and each shared-memory load hits 32 distinct banks;
- the dc epilogue's factor-major block decode and kernel 6's
  (tests/_tri_decodes.py) at the replay shapes: every tile once, in the
  order the design relies on, and every element of dc, dcᵀ and dLu written
  once, padding zeros included (tests/test_torch_tri_bwd.py replays the
  stores thread by thread);
- the shared-memory and register budgets, and when kernel 6 reads a's rows
  in place.
"""

import re
from pathlib import Path

import numpy as np
import pytest
from _tri_decodes import B_REPLAY, M_REPLAY, dc_block, dlu_block

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
                 "return mode == kDc || mode == kDlu;"):
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
