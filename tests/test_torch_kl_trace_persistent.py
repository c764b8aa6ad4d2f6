"""Kernel 8's forward keeping P on the persistent grid, on the CPU.

On the card ``tri_cuda.tri_kl_trace_fwd_p`` runs tri.cu's ``trace_p_kernel``:
min(SMs, tiles) blocks, whose producers take the (l, rt, ct >= rt)
tiles of a fixed list from a counter, the longest k loop first; operand A
is Lu's rows read in place through a map with a slab a factor (or a copy
of them with the row stride Mp where a row is off 16 bytes), read
transposed into the fragments, the entries above Lu's diagonal set to 0,
then split; P is stored straight from the
fragments below and on the diagonal only; each tile's partial of the trace
is keyed by its index in the old one-tile-a-block grid. What the card runs
cannot run here, so these tests replay it with tri.cu's own arithmetic:

- the tile walk (``trace_tile``) at the replay shapes, L 1, 3 and 20, grids
  of 1, 7 and 132 blocks, a shared and a per-factor K⁻¹: every tile once, the
  longest k loop first, each partial's slot the old grid's block of the same
  tile, summed by the factor's last tile in the old order;
- operand A: the landed boxes (zeros past Lu's slab, NaN above its diagonal
  masked) give each fragment the value kTrace's staged LuT gave it;
- the epilogue: P's lower triangle written once, nothing above it, in whole
  32-byte sectors where M is a multiple of 8; the trace's Lu[i, j] mask is
  LuT's zeros;
- :class:`tri_cuda.TriKLTrace`'s backward from a P whose upper triangle is
  NaN (the kernel leaves it unwritten) against the plain recompute and
  ``jax.grad`` of ``gpzoo_tpu.ops.tri_blocked.tri_kl_trace`` in float64 at
  1e-8, M 130 and 1,100, L 1 and 3.
"""

import functools
import math
import re
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _tri_decodes import M_REPLAY

from gpzoo_tpu.ops import tri_blocked as jtri

from gpzoo_tpu_torch.ops import tri_cuda

T = torch.tensor
TRI_CU = Path(__file__).resolve().parents[1] / "gpzoo_tpu_torch" / "ops" / "csrc" / "tri.cu"


def _src():
    return TRI_CU.read_text()


def _const(name):
    """An integer ``constexpr int name = value;`` of tri.cu."""
    return int(re.search(rf"constexpr int {name} = (\d+);", _src()).group(1))


TILE, TK, C_BOX = _const("TM"), _const("TK"), _const("C_BOX")


def _kernel(src):
    """trace_p_kernel's text in tri.cu."""
    start = src.index("trace_p_kernel(const __grid_constant__")
    return src[start:src.index("using EncodeTiled", start)]


def trace_tile(t, L, nrt, order):
    """tri.cu's ``trace_tile``: tile t of the list, (l, rt, ct)."""
    if order == 0:
        pairs = nrt * (nrt + 1) // 2
        l, q = divmod(t, pairs)
        ct = 0
        while q > ct:
            ct += 1
            q -= ct
        return l, q, ct
    r, rt = t, 0
    while r >= L * (nrt - rt):
        r -= L * (nrt - rt)
        rt += 1
    return r // (nrt - rt), rt, rt + r % (nrt - rt)


def old_block(bid, nrt):
    """The one-tile-a-block grid's decode (tri_mma_kernel's is_trace branch):
    (l, rt, ct) of block bid, q = ct (ct + 1) / 2 + rt."""
    pairs = nrt * (nrt + 1) // 2
    l, q = divmod(bid, pairs)
    ct = int((np.sqrt(np.float32(8 * q + 1), dtype=np.float32) - np.float32(1))
             * np.float32(0.5))
    while ct * (ct + 1) // 2 > q:
        ct -= 1
    while (ct + 1) * (ct + 2) // 2 <= q:
        ct += 1
    return l, q - ct * (ct + 1) // 2, ct


def walk(L, m_dim, sms, order):
    """The hand-out replayed: each block's tiles in its order, [(t, l, rt,
    ct, slot)], and the grid. min(sms, tiles) blocks; a block's producer
    takes t from the counter (tickets[L]) when its ring frees, here the
    block with the least work so far (a tile of n stages costs n + 4), until
    t is past the list; then it takes a ticket of tickets[L + 1], and the
    last one sets both back to 0."""
    nrt = -(-m_dim // TILE)
    nk = nrt * TILE // TK
    pairs = nrt * (nrt + 1) // 2
    count = L * pairs
    grid = min(count, sms)
    counters = [0, 0]  # tickets[L], tickets[L + 1]
    blocks, busy, done = [[] for _ in range(grid)], [0] * grid, [False] * grid
    while not all(done):
        b = min((busy[i], i) for i in range(grid) if not done[i])[1]
        t = counters[0]
        counters[0] += 1
        if t >= count:
            done[b] = True
            old = counters[1]
            counters[1] += 1
            if old == grid - 1:
                counters[0] = counters[1] = 0
            continue
        l, rt, ct = trace_tile(t, L, nrt, order)
        blocks[b].append((t, l, rt, ct, l * pairs + ct * (ct + 1) // 2 + rt))
        busy[b] += nk - rt * (TILE // TK) + 4
    assert counters == [0, 0]  # the next call finds them at 0
    return blocks, grid


# trace_tile's orders: the kernel takes 0 for a per-factor K⁻¹, 1 for a
# shared one
ORDERS = pytest.mark.parametrize("order", [0, 1], ids=["per-factor K", "shared K"])


@ORDERS
@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("l_dim", [1, 3, 20])
@pytest.mark.parametrize("m_dim", M_REPLAY)
def test_the_walk_visits_every_tile_once_longest_first(m_dim, l_dim, sms, order):
    nrt = -(-m_dim // TILE)
    nk = nrt * TILE // TK
    pairs = nrt * (nrt + 1) // 2
    blocks, grid = walk(l_dim, m_dim, sms, order)
    assert grid == min(sms, l_dim * pairs)
    seen = [(l, rt, ct) for mine in blocks for _, l, rt, ct, _ in mine]
    assert sorted(seen) == sorted((l, rt, ct) for l in range(l_dim) for ct in range(nrt)
                                  for rt in range(ct + 1))
    order_ = sorted(x for mine in blocks for x in mine)
    assert [x[0] for x in order_] == list(range(l_dim * pairs))
    loops = [nk - rt * (TILE // TK) for _, _, rt, _, _ in order_]
    if order == 0:
        # the old grid's order: each tile where the old grid put it, the
        # longest k loop first in each (l, ct)
        assert [x[4] for x in order_] == [x[0] for x in order_]
        for l in range(l_dim):
            for ct in range(nrt):
                run = [x[2] for x in order_ if x[1] == l and x[3] == ct]
                assert run == list(range(ct + 1))
    else:
        # the longest k loop first over every factor: rt slowest, then l,
        # then ct; each block's tiles in the list's order, so its first
        # tile has its longest loop
        assert loops == sorted(loops, reverse=True) and loops[0] == nk
        assert order_ == sorted(order_, key=lambda x: (x[2], x[1], x[3]))
        for mine in blocks:
            assert not mine or mine[0][2] == min(x[2] for x in mine)
    for mine in blocks:
        assert [x[0] for x in mine] == sorted(x[0] for x in mine)


@ORDERS
@pytest.mark.parametrize("l_dim", [1, 3, 20])
@pytest.mark.parametrize("m_dim", M_REPLAY)
def test_each_partial_sits_where_the_old_grid_put_it(m_dim, l_dim, order):
    """The slot of each tile's partial is the block the one-tile-a-block
    grid gave the same tile, so the slots cover the partials once, each
    factor's in its own pairs, and the last tile's block sums them in the
    old order (256 strided sums over q, then a tree)."""
    nrt = -(-m_dim // TILE)
    pairs = nrt * (nrt + 1) // 2
    blocks, _ = walk(l_dim, m_dim, 132, order)
    slots = {}
    for mine in blocks:
        for _, l, rt, ct, slot in mine:
            assert old_block(slot, nrt) == (l, rt, ct)
            assert l * pairs <= slot < (l + 1) * pairs
            slots[slot] = (l, rt, ct)
    assert sorted(slots) == list(range(l_dim * pairs))
    src = _src()
    body = _kernel(src)
    for line in ("const double* part = p.partial + (int64_t)l * pairs;",
                 "for (int q = t_id; q < pairs; q += 256) v += __ldcg(part + q);",
                 "if (t_id < w) sums[t_id] += sums[t_id + w];",
                 "p.partial[(int64_t)l * pairs + ct * (ct + 1) / 2 + rt] = b;",
                 "*last = ticket(p.tickets + l) == (unsigned)(pairs - 1);"):
        assert line in body, line
    # the old grid's own sum, the same lines keyed by blockIdx
    old = src[src.index("tri_mma_kernel(const __grid_constant__"):
              src.index("trace_p_kernel(const __grid_constant__")]
    for line in ("p.partial[blockIdx.x] = b;",
                 "for (int q = t; q < n; q += 256) v += __ldcg(part + q);",
                 "if (t < w) sums[t] += sums[t + w];"):
        assert line in old, line


def test_tri_cu_has_the_replayed_walk():
    src = _src()
    for line in (
            "const int pairs = nrt * (nrt + 1) / 2;",
            "l = t / pairs;",
            "int q = t % pairs;",
            "while (q > ct) q -= ++ct;",
            "rt = q;",
            "while (r >= L * (nrt - rt)) r -= L * (nrt - rt++);",
            "l = r / (nrt - rt);",
            "ct = rt + r % (nrt - rt);",
            "const int order = p.b_slab != 0 ? 0 : 1;",
            "const int t = (int)atomicAdd(next, 1u);",
            "tile_of[s] = t < count ? t : -1;",
            "if (ticket(p.tickets + p.L + 1) == gridDim.x - 1) {",
            "const int t = tile_of[it % kStages];",
            "for (int kt = rt * (TM / TK); kt < p.nk; ++kt, ++it) {",
            "const int kb = rt * (TM / TK);",
            "const auto kernel = order == 0 ? trace_p_kernel<0> : trace_p_kernel<1>;",
            "kernel<<<count < sms ? count : sms, threads(kTraceP), smem_bytes(kTraceP), stream>>>("):
        assert line in src, line
    # K_s has a slab a factor only when K⁻¹ is per factor: the list is the
    # old grid's exactly then
    assert "p->b_slab = (g == nullptr && Lk > 1) ? Mp : 0;" in src
    # the tile slots sit past the 256 sums and before the last-tile flag
    assert "volatile int* tile_of = reinterpret_cast<int*>(sums + 256);" in src
    assert 256 * 8 + 4 * _const("REG_A_STAGES") <= 4 * _const("CONSUMERS") * TILE * 4 - 4


def _landed(lu_rows, l, kt, rt, rows_in_slab, inner):
    """Stage kt of a tile of row tile rt as TMA lands operand A: four
    32 x 32 boxes of Lu's rows k in [32 kt, 32 kt + 32) of factor l's slab
    (zeros past its rows_in_slab rows and past inner columns) by the tile's
    128 j, 4 KB apart, each row k 128 bytes with 16-byte chunk q at
    q ^ (k % 8); as floats."""
    smem = np.full(TILE * TK, np.nan, np.float32)
    for jb in range(TILE // C_BOX):
        for kl in range(TK):
            for bb in range(C_BOX):
                k, j = TK * kt + kl, rt * TILE + jb * C_BOX + bb
                v = lu_rows[l, k, j] if k < rows_in_slab and j < inner else 0.0
                smem[(jb * 4096 + kl * 128 + (((bb >> 2) ^ (kl & 7)) << 4) + (bb & 3) * 4) // 4] = v
    return smem


def _a_reads():
    """(wg, tile row, k, byte address) of each thread's A fragment reads of a
    stage, by (wg, warp % 4, lane, kk, e), as load_a computes them."""
    wg, w, lane, kk, e = np.meshgrid(np.arange(2), np.arange(4), np.arange(32),
                                     np.arange(TK // 8), np.arange(4), indexing="ij")
    row = w * 16 + lane // 4 + 8 * (e & 1)
    k = 8 * kk + lane % 4 + 4 * (e >> 1)
    bb = row & (C_BOX - 1)
    addr = (wg * (TILE * TK * 4 // 2) + (row // C_BOX) * (TILE * TK * 4 // (TILE // C_BOX))
            + k * 128 + (((bb >> 2) ^ (k & 7)) << 4) + (bb & 3) * 4)
    return wg, row, k, addr


def test_fragment_reads_are_kernel_7_reading_cs():
    """load_a's rows, k and addresses are kDaC's (tests/test_torch_da_from_c.py
    replays their swizzle and 2-way bank conflict)."""
    src = _kernel(_src())
    for line in ("const int r = (warp % 4) * 16 + lane / 4;",
                 "const int row = r + 8 * (e & 1), k = 8 * kk + lane % 4 + 4 * (e >> 1);",
                 "const int bb = row & (C_BOX - 1);",
                 "float v = lds_f32(a32 + (row / C_BOX) * (TILE_BYTES / (TM / C_BOX)) + k * 128 +",
                 "(((bb >> 2) ^ (k & 7)) << 4) + (bb & 3) * 4);",
                 "const uint32_t a32 = tiles + s * kStageBytes + wg * (TILE_BYTES / 2);"):
        assert line in src, line


def _a_fragments(smem, kt, rt):
    """Each consumer thread's operand A values of a stage, as trace_p_kernel's
    load_a reads and masks them, with the (j, k) each stands for."""
    wg, row, k, addr = _a_reads()
    v = smem[addr // 4]
    diag = kt < (rt + 1) * (TILE // TK)
    kd = kt * TK - rt * TILE - wg * 64
    v = np.where(diag & (kd + k < row), np.float32(0), v)
    return v, rt * TILE + wg * 64 + row, kt * TK + k


def _stage_lut(lu, m_dim):
    """kTrace's operand A as stage_lu_tile staged it: LuT[l, j, k] = Lu[l, k,
    j] for j <= k < M, else 0, (L, Mp, Mp)."""
    mp = -(-m_dim // TILE) * TILE
    lut = np.zeros((lu.shape[0], mp, mp), np.float32)
    k, j = np.meshgrid(np.arange(m_dim), np.arange(m_dim), indexing="ij")
    keep = k >= j
    lut[:, j[keep], k[keep]] = lu[:, k[keep], j[keep]]
    return lut


def _stage_lu_rows(lu, m_dim):
    """trace_lu_rows_kernel replayed with its own index arithmetic: block
    (k, l), thread c's four floats 4c + e for c < (k / TM + 1) (TM / 4),
    Lu[l, k, m] for m <= k < M, else 0; what it does not write is NaN here,
    (L, Mp, Mp)."""
    mp = -(-m_dim // TILE) * TILE
    rows = np.full((lu.shape[0], mp, mp), np.nan, np.float32)
    for k in range(mp):
        for c in range((k // TILE + 1) * (TILE // 4)):
            for e in range(4):
                m = 4 * c + e
                rows[:, k, m] = lu[:, k, m] if k < m_dim and m <= k else 0.0
    return rows


@pytest.mark.parametrize("m_dim", [1, 33, 128, 132, 257])
def test_operand_a_is_the_staged_lut(m_dim):
    """Each fragment of every stage a tile reads is the value kTrace's LuT
    gave it: from Lu read in place (M a multiple of 4 floats: a slab of M
    rows of M, NaN above Lu's diagonal) or from the copy of its rows
    (slabs of Mp rows of Mp, never-written columns NaN); no NaN reaches the
    split, and the next factor's rows never enter."""
    rng = np.random.default_rng(m_dim)
    l_dim = 2
    lu = np.tril(rng.standard_normal((l_dim, m_dim, m_dim))).astype(np.float32)
    lu[:, ~np.tri(m_dim, dtype=bool)] = np.nan
    lut = _stage_lut(np.nan_to_num(lu, nan=0.0), m_dim)
    nrt = -(-m_dim // TILE)
    routes = [(_stage_lu_rows(lu, m_dim), nrt * TILE)]
    if m_dim % 4 == 0:  # in place: the slab's rows and columns end at M
        routes.append((lu, m_dim))
    for lu_rows, dim in routes:
        for l in range(l_dim):
            for rt in range(nrt):
                for kt in range(rt * (TILE // TK), nrt * TILE // TK):
                    v, j, k = _a_fragments(_landed(lu_rows, l, kt, rt, dim, dim), kt, rt)
                    assert not np.isnan(v).any()
                    np.testing.assert_array_equal(v, lut[l, j, k])
    src = _src()
    for line in ("const bool diag = kt < (rt + 1) * (TM / TK);",
                 "const int kd = kt * TK - rt * TM - wg * 64;",
                 "if (diag && kd + k < row) v = 0.f;  // above Lu's diagonal",
                 "tma_load_3d(st + j * (TILE_BYTES / (TM / C_BOX)), &lu_map, rt * TM + j * C_BOX,",
                 "if ((err = make_map(&maps[0], lu_rows, lu_dim, lu_dim, TK, p.L)) != 0) return err;",
                 "const bool copy = M % 4 != 0 || (reinterpret_cast<uintptr_t>(lu) & 15) != 0;",
                 "trace_lu_rows_kernel<<<dim3(p.Mp, L), 256, 0, st>>>(lu, rows, M, p.Mp);",
                 "for (int c = threadIdx.x; c < (k / TM + 1) * (TM / 4); c += blockDim.x) {",
                 "for (int e = 0; e < 4; ++e) v[e] = (k < M && 4 * c + e <= k) ? row[4 * c + e] : 0.f;"):
        assert line in src, line


def _fragments():
    """(row j, column i) of each consumer thread's accumulator elements in the
    128 x 128 tile, by (warp, lane, jj, h, e), as trace_p_kernel computes them."""
    warp, lane, jj, h, e = np.meshgrid(np.arange(8), np.arange(32), np.arange(16),
                                       np.arange(2), np.arange(2), indexing="ij")
    row = (warp // 4) * 64 + (warp % 4) * 16 + lane // 4 + 8 * h
    col = 2 * (lane % 4) + 8 * jj + e
    return row, col


@pytest.mark.parametrize("m_dim", M_REPLAY)
def test_p_stores_cover_the_lower_triangle_once(m_dim):
    """Over every tile, the stores write each P[i, j] with j <= i < M once,
    from the fragment of P^T[j, i], and nothing above the diagonal; the
    trace's Lu[i, j] is read where LuT's staged value was not a zero."""
    nrt = -(-m_dim // TILE)
    rowl, coll = _fragments()
    writes = np.zeros((m_dim, m_dim), np.int64)
    for ct in range(nrt):
        for rt in range(ct + 1):
            j, i = rt * TILE + rowl, ct * TILE + coll
            store = (i < m_dim) & (j <= i)
            np.add.at(writes, (i[store], j[store]), 1)
    assert np.all(writes == np.tri(m_dim, dtype=np.int64))
    src = _src()
    for line in ("const int row = rt * TM + wg * 64 + r;",
                 "const int col = ct * TN + 2 * (lane % 4);",
                 "const int i = col + 8 * jj + e, j = row + 8 * h;",
                 "const float u = (i < p.M && j <= i) ? lu_l[(int64_t)i * p.M + j] : 0.f;",
                 "if (i < p.M && j <= i) out_l[(int64_t)i * p.M + j] = tot[4 * jj + 2 * h + e];"):
        assert line in src, line
    body = _kernel(src)
    assert "= 0.f;" not in body[body.index("// P[l, i, j] for j <= i < M"):]


@pytest.mark.parametrize("m_dim", [3000, 3008])
def test_a_warps_p_store_is_four_whole_sectors(m_dim):
    """A warp's store (fixed jj, h, e) writes four rows i of eight
    consecutive j: where M is a multiple of 8 floats each run is one
    32-byte sector."""
    rowl, coll = _fragments()
    for warp in range(8):
        for jj in range(16):
            for h in range(2):
                for e in range(2):
                    j, i = rowl[warp, :, jj, h, e], coll[warp, :, jj, h, e]
                    addr = (i.astype(np.int64) * m_dim + j) * 4
                    assert len(set(i)) == 4
                    for ii in set(i):
                        run = np.sort(addr[i == ii])
                        np.testing.assert_array_equal(np.diff(run), 4)
                        assert len(run) == 8 and run[0] // 32 == run[-1] // 32


CASES = [(m, l_dim, form) for m in (130, 1100) for l_dim in (1, 3)
         for form in ("shared", "per-factor")]


@functools.cache
def _case(m_dim, l_dim, form):
    """K⁻¹ (SPD plus a part that is not symmetric), lower-triangular Lu (L,
    M, M), a cotangent g (L,), numpy float64, and JAX's dLu of g·trace."""
    rng = np.random.default_rng(11 * m_dim + l_dim)
    k_shape = (m_dim, m_dim) if form == "shared" else (l_dim, m_dim, m_dim)
    w = rng.standard_normal(k_shape) / np.sqrt(m_dim)
    k_inv = (w @ np.swapaxes(w, -1, -2) + np.eye(m_dim)
             + 0.1 / np.sqrt(m_dim) * rng.standard_normal(k_shape))
    lu = np.tril(rng.standard_normal((l_dim, m_dim, m_dim))) / np.sqrt(m_dim)
    g = rng.standard_normal(l_dim)

    def f(u):
        return jnp.sum(jnp.asarray(g) * jtri.tri_kl_trace(jnp.asarray(k_inv), u))
    return k_inv, lu, g, np.asarray(jax.grad(f)(jnp.asarray(lu)))


def _close(got, expect, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    expect = np.asarray(expect)
    np.testing.assert_allclose(got, expect, rtol=0,
                               atol=rtol * max(np.max(np.abs(expect)), 1e-300))


@pytest.mark.parametrize("m_dim,l_dim,form", CASES)
def test_backward_from_p_with_an_unwritten_upper_triangle(m_dim, l_dim, form):
    """The kernel leaves P's upper triangle as torch.empty gave it: with
    NaN there, TriKLTrace's backward still gives the recompute's dLu and
    JAX's."""
    k_inv, lu, g, want = _case(m_dim, l_dim, form)
    keep = tri_cuda.tri_kl_trace_p_plain
    kept = []

    def nan_above(k, u):
        trace, p = keep(k, u)
        p = p.clone()
        p[:, ~torch.ones(p.shape[1:], dtype=torch.bool).tril()] = math.nan
        kept.append(p)
        return trace, p
    lu_t = T(lu).requires_grad_()
    with mock.patch.object(tri_cuda, "tri_kl_trace_p_plain", nan_above):
        tri_cuda.tri_kl_trace(T(k_inv), lu_t).backward(T(g))
    assert len(kept) == 1 and bool(torch.isnan(kept[0]).any()) == (m_dim > 1)
    dlu = lu_t.grad
    assert torch.isfinite(dlu).all() and torch.all(dlu.triu(1) == 0)
    _close(dlu, tri_cuda.tri_kl_trace_bwd_plain(T(k_inv), T(lu), T(g)), 1e-8)
    _close(dlu, np.tril(want), 1e-8)
