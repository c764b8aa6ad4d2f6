"""Kernel 3's backward (``csrc/gram.cu`` ``rbf_gram_bwd_kernel``) on the
CPU: its one-launch plan replayed in Python with the kernel's own index
arithmetic and constants.

- every (row group, strip) is owned by exactly one block, at ragged N, M
  and L and the three VEC, on the persistent grid (blocks take items
  blockIdx.x, + gridDim.x, ...);
- the ring's cursor fills the consumer's (item, row group, factor) steps in
  the consumer's order, STAGES - 1 ahead, each into the stage consumed the
  step before;
- the helpers (the last blocks to finish their items, fewer than the SM
  count) share every unit of the fixed-order sums once, and every output
  once, only after every block is counted, whatever order the blocks
  finish in, and leave the counters at 0;
- the fixed-order sums of the partials in float64 (loads batched AHEAD at
  a time, slices, the tree with its last five levels as shuffles) give the
  same bits as the first design's reduction kernel, replayed as it was
  written;
- the grid is one wave of the blocks that fit, items spread within one;
- a float32 replay of the partials and the sums gives the closed form
  (``rbf_gram_bwd_plain``, float64) to float32 rounding;
- the ring and the shared buffers fit a block, two an SM at D = 1, 2.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gpzoo_tpu_torch.ops import gram_cuda

GRAM_CU = Path(__file__).resolve().parents[1] / "gpzoo_tpu_torch" / "ops" / "csrc" / "gram.cu"
SMS = 132  # an H100's
SMEM_PER_SM, SMEM_PER_BLOCK, SMEM_RESERVED = 233_472, 232_448, 1024


def _src():
    return GRAM_CU.read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _src()).group(1))


THREADS = _const("THREADS")
BWD_TX, BWD_ROWS, LC = _const("BWD_TX"), _const("BWD_ROWS"), _const("LC")
PLAN_BLOCKS_PER_SM, SLICES = _const("PLAN_BLOCKS_PER_SM"), _const("SLICES")
AHEAD, OUTS, STAGES = _const("AHEAD"), _const("OUTS"), _const("STAGES")
BWD_TY = THREADS // BWD_TX
GROUP_ROWS = BWD_TY * BWD_ROWS
WARPS = THREADS // 32

# (N, M, L): the paths' shapes and ragged ones (M % 4 = 0, 2 and odd)
SHAPES = [(5000, 1000, 10), (5000, 1000, 1), (1000, 1000, 10), (100, 100, 4), (529, 529, 4),
          (529, 720, 4), (500, 10000, 1), (1, 1, 1), (16, 256, 3), (33, 1, 2), (130, 150, 3),
          (37, 1030, 1), (7, 1025, 2), (129, 1023, 3), (5001, 998, 10), (300, 270, 37)]


def _plan(N, M, L, sms=SMS):
    """bwd_plan: (vec, strips, chunks, tiles, items, n_parts)."""
    vec = 4 if M % 4 == 0 else (2 if M % 2 == 0 else 1)
    strips = -(-M // (BWD_TX * vec))
    groups = -(-N // GROUP_ROWS)
    chunks = max(1, min(groups, groups * strips // (PLAN_BLOCKS_PER_SM * sms)))
    tiles = -(-groups // chunks)
    items = tiles * strips
    return vec, strips, chunks, tiles, items, items * chunks


def _grid(items, per_sm, sms=SMS):
    return min(items, per_sm * sms)


def test_plan_is_the_entry_points():
    src = _src()
    for line in ("a.strips = (int)((M + (int64_t)BWD_TX * p->vec - 1) / ((int64_t)BWD_TX * p->vec));",
                 "const int64_t chunks = groups * a.strips / ((int64_t)PLAN_BLOCKS_PER_SM * sms);",
                 "a.chunks = (int)(chunks < 1 ? 1 : (chunks > groups ? groups : chunks));",
                 "a.tiles = (int)((groups + a.chunks - 1) / a.chunks);",
                 "a.n_parts = items * a.chunks;",
                 "return (int)(p.args.items < wave ? p.args.items : wave);",
                 "for (int item = blockIdx.x; item < a.items; item += gridDim.x) {"):
        assert line in src, line


@pytest.mark.parametrize("per_sm", [1, 2, 3])
@pytest.mark.parametrize("N,M,L", SHAPES)
def test_every_row_group_and_strip_is_owned_once(N, M, L, per_sm):
    vec, strips, chunks, tiles, items, _ = _plan(N, M, L)
    grid = _grid(items, per_sm)
    groups = -(-N // GROUP_ROWS)
    owned = np.zeros((groups, strips), dtype=np.int64)
    for block in range(grid):
        for item in range(block, items, grid):
            tile, strip = divmod(item, strips)
            for c in range(chunks):
                group = tile * chunks + c
                if group < groups:
                    owned[group, strip] += 1
    assert (owned == 1).all()
    # and every column of a strip exists: VEC divides M
    assert M % vec == 0 and (strips - 1) * BWD_TX * vec < M


def _cursor_steps(block, grid, N, M, L, thread, count):
    """The Cursor's (item, c, l, n0, m0) from start() through next(), as
    gram.cu writes them."""
    vec, strips, chunks, *_ = _plan(N, M, L)
    item, c, l = block, 0, 0
    out = []
    for _ in range(count):
        strip, tile = item % strips, item // strips
        out.append((item, c, l, (tile * chunks + c) * GROUP_ROWS + thread // BWD_TX * BWD_ROWS,
                    (strip * BWD_TX + thread % BWD_TX) * vec))
        l += 1
        if l < L:
            continue
        l = 0
        c += 1
        if c == chunks:
            c, item = 0, item + grid
    return out


@pytest.mark.parametrize("N,M,L", [(5000, 1000, 10), (100, 100, 4), (33, 1, 2), (300, 270, 37),
                                   (500, 10000, 1), (1, 1, 1)])
def test_the_ring_fills_the_consumers_steps_ahead(N, M, L):
    vec, strips, chunks, tiles, items, _ = _plan(N, M, L)
    grid = _grid(items, 2)
    for block in sorted({0, grid // 2, grid - 1}):
        for thread in (0, 63, 64, 255):
            consumer = [(item, c, l) for item in range(block, items, grid)
                        for c in range(chunks) for l in range(L)]
            ahead = _cursor_steps(block, grid, N, M, L, thread, len(consumer) + STAGES - 1)
            assert [s[:3] for s in ahead[:len(consumer)]] == consumer
            assert all(s[0] >= items for s in ahead[len(consumer):])  # nothing past the end
            for step in range(len(consumer)):
                filled = step + STAGES - 1  # the step whose copies go out at this step
                assert filled % STAGES == (step - 1) % STAGES  # the stage consumed last
                assert filled % STAGES != step % STAGES
            # rows and columns as the consumer forms them
            for (item, c, _l, n0, m0) in ahead[:len(consumer)]:
                strip, tile = item % strips, item // strips
                assert n0 == (tile * chunks + c) * GROUP_ROWS + thread // BWD_TX * BWD_ROWS
                assert m0 == (strip * BWD_TX + thread % BWD_TX) * vec


def _atomic_inc(counters, at, limit):
    old = counters[at]
    counters[at] = 0 if old >= limit else old + 1
    return old


def _helpers_of(grid, sms=SMS):
    return min(grid, sms - 1 if sms > 1 else 1)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("N,M,L", [(5000, 1000, 10), (529, 529, 4), (500, 10000, 1), (1, 1, 1),
                                   (130, 150, 3), (100, 100, 4)])
def test_helpers_share_every_unit_once_and_leave_the_counters_at_zero(N, M, L, seed):
    vec, strips, chunks, tiles, items, _ = _plan(N, M, L)
    grid = _grid(items, 2)
    helpers = _helpers_of(grid)
    assert 1 <= helpers < SMS  # a block still to start always finds a slot
    D = 2
    units = 2 * L + -(-(N * D + M * D) // (32 * OUTS))
    DONE, EXITED = 0, 1
    counters = [0, 0]
    rng = np.random.default_rng(seed)
    places = {}
    for b in rng.permutation(grid):  # the order blocks finish their items in
        places[int(b)] = grid - 1 - counters[DONE]  # ticket: the last to finish is 0
        counters[DONE] += 1
    assert counters[DONE] == grid and sorted(places.values()) == list(range(grid))
    helper_blocks = sorted(b for b, h in places.items() if h < helpers)
    assert len(helper_blocks) == helpers
    done_units = np.zeros(units, dtype=np.int64)
    for b in rng.permutation(helper_blocks):  # each waits for DONE == grid, then sums
        assert counters[DONE] == grid  # not reset before every helper has seen it
        if _atomic_inc(counters, EXITED, helpers - 1) == helpers - 1:
            counters[DONE] = 0
        for u in range(places[b], units, helpers):
            done_units[u] += 1
    assert (done_units == 1).all()
    assert counters == [0, 0]  # a captured graph replays
    # outputs of a unit: OUTS a thread, 32 apart; every dx and dz output once
    outs = np.zeros(N * D + M * D, dtype=np.int64)
    for u in range(units - 2 * L):
        for lane in range(32):
            for q in range(OUTS):
                i = u * 32 * OUTS + lane + 32 * q
                if i < outs.size:
                    outs[i] += 1
    assert (outs == 1).all()
    src = _src()
    for line in ("if (threadIdx.x == 0) helper = gridDim.x - 1 - ticket(counters + DONE);",
                 "while (load_acquire(counters + DONE) < gridDim.x) __nanosleep(32);",
                 "for (int64_t u = h; u < units; u += helpers)",
                 "passed = atomicInc(counters + EXITED, helpers - 1);  // read after the sums",
                 "if (threadIdx.x == 0 && passed == (unsigned)helpers - 1) counters[DONE] = 0;",
                 "const int64_t first = (unit - hyper_units) * 32 * OUTS + lane;",
                 "const int most = sms > 1 ? sms - 1 : 1;"):
        assert line in src, line


def _parent_slab_sum(src, count, j):
    """The first design's reduction kernel for output j: slice t of SLICES
    sums slabs t, t + SLICES, ... in double, then the slices in order."""
    red = [0.0] * SLICES
    for slice_ in range(SLICES):
        s = 0.0
        t = slice_
        while t < count:
            s += float(src[t, j])
            t += SLICES
        red[slice_] = s
    total = 0.0
    for t in range(SLICES):
        total += red[t]
    return total


def _new_slab_sum(src, count, j):
    """sum_unit's slab sums: thread (slice, lane) loads AHEAD slabs t0 + u
    SLICES at once (t0 = slice, slice + AHEAD SLICES, ...) and adds them in
    order; then the slices in order."""
    red = [0.0] * SLICES
    for slice_ in range(SLICES):
        s = 0.0
        for t0 in range(slice_, count, AHEAD * SLICES):
            v = [float(src[t0 + u * SLICES, j]) if t0 + u * SLICES < count else 0.0
                 for u in range(AHEAD)]
            for u in range(AHEAD):
                if t0 + u * SLICES < count:
                    s += v[u]
        red[slice_] = s
    total = 0.0
    for t in range(SLICES):
        total += red[t]
    return total


def _parent_tree(p):
    """The reduction kernel's hyper block: thread t sums p[t], p[t + 256],
    ... in double, then red[t] += red[t + h] for h = 128, ..., 1."""
    red = [0.0] * THREADS
    for t in range(THREADS):
        s = 0.0
        for i in range(t, len(p), THREADS):
            s += float(p[i])
        red[t] = s
    h = THREADS // 2
    while h > 0:
        for t in range(h):
            red[t] = red[t] + red[t + h]
        h //= 2
    return red[0]


def _new_tree(p):
    """sum_unit's hyper sums: thread t loads AHEAD parts i0 + u 256 at once
    (i0 = t, t + AHEAD 256, ...) and adds them in order; h = 128 and 64 in
    shared memory, then warp 0: red[lane] + red[lane + 32] and shuffles
    down by 16, ..., 1 (a lane past 31 reads its own value)."""
    red = [0.0] * THREADS
    for t in range(THREADS):
        s = 0.0
        for i0 in range(t, len(p), AHEAD * THREADS):
            for u in range(AHEAD):
                if i0 + u * THREADS < len(p):
                    s += float(p[i0 + u * THREADS])
        red[t] = s
    for h in (128, 64):
        for t in range(h):
            red[t] += red[t + h]
    v = [red[lane] + red[lane + 32] for lane in range(32)]
    for o in (16, 8, 4, 2, 1):
        v = [v[lane] + (v[lane + o] if lane + o < 32 else v[lane]) for lane in range(32)]
    return v[0]


@pytest.mark.parametrize("count", [1, 4, 7, 9, 40, 157, 176])
def test_slab_sums_are_the_first_designs_bits(count):
    rng = np.random.default_rng(count)
    src = (rng.standard_normal((count, 24)) * 10.0 ** rng.integers(-6, 6, (count, 24))
           ).astype(np.float32)
    for j in range(src.shape[1]):
        a, b = _parent_slab_sum(src, count, j), _new_slab_sum(src, count, j)
        assert np.float32(a).tobytes() == np.float32(b).tobytes()
        assert a == b


@pytest.mark.parametrize("n_parts", [1, 7, 255, 256, 1256, 2560, 4001])
def test_hyper_tree_is_the_first_designs_bits(n_parts):
    rng = np.random.default_rng(n_parts)
    p = (rng.standard_normal(n_parts) * 10.0 ** rng.integers(-5, 5, n_parts)).astype(np.float32)
    assert _parent_tree(p) == _new_tree(p)
    src = _src()
    assert "for (int h = THREADS / 2; h >= 64; h >>= 1) {" in src
    assert "double v = red[tid] + red[tid + 32];" in src
    assert "for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);" in src


@pytest.mark.parametrize("per_sm", [1, 2, 3, 4])
@pytest.mark.parametrize("N,M,L", SHAPES)
def test_grid_is_one_wave_with_items_spread_within_one(N, M, L, per_sm):
    *_, items, _ = _plan(N, M, L)
    grid = _grid(items, per_sm)
    assert 1 <= grid <= per_sm * SMS  # every block resident at once
    counts = [len(range(b, items, grid)) for b in range(grid)]
    assert max(counts) - min(counts) <= 1 and sum(counts) == items
    if items <= per_sm * SMS:
        assert counts == [1] * items


def _warp_sum(vals):
    """The xor butterfly over the 32 lanes of a warp (axis 0), float32."""
    v = vals.astype(np.float32).copy()
    for o in (16, 8, 4, 2, 1):
        v = (v + v[np.arange(32) ^ o]).astype(np.float32)
    return v[0]


def _replay(g, k, x, z, ell, N, M, L, D):
    """The kernel's partials in float32, then its sums: (dx, dz, sum gk,
    sum gk d2) before the hyper scaling."""
    vec, strips, chunks, tiles, items, n_parts = _plan(N, M, L)
    f32 = np.float32
    pdx = np.zeros((strips, N, D), f32)
    pdz = np.zeros((tiles, M, D), f32)
    phyper = np.zeros((2, L, n_parts), f32)
    inv_ell2 = (f32(1) / (ell * ell).astype(f32)).astype(f32)
    for item in range(items):
        tile, strip = divmod(item, strips)
        dz_acc = np.zeros((BWD_TY, BWD_TX, vec, D), f32)
        for c in range(chunks):
            group = tile * chunks + c
            sdx = np.zeros((WARPS, BWD_ROWS, D), f32)
            part = np.zeros((L, 2, WARPS), f32)
            w_all = np.zeros((BWD_TY, BWD_TX, BWD_ROWS, vec), f32)
            for ty in range(BWD_TY):
                for half in range(BWD_TX // 32):
                    lanes = range(half * 32, half * 32 + 32)
                    warp = ty * (BWD_TX // 32) + half
                    s_gk = np.zeros((L, 32), f32)
                    s_gkd2 = np.zeros((L, 32), f32)
                    acc_dx = np.zeros((BWD_ROWS, D, 32), f32)
                    for li, tx in enumerate(lanes):
                        m0 = (strip * BWD_TX + tx) * vec
                        col_live = m0 < M
                        n0 = group * GROUP_ROWS + ty * BWD_ROWS
                        w = np.zeros((BWD_ROWS, vec), f32)
                        for l in range(L):
                            sg, sd = f32(0), f32(0)
                            for r in range(BWD_ROWS):
                                live = col_live and n0 + r < N
                                for v in range(vec):
                                    if not live:
                                        continue
                                    gk = f32(g[l, n0 + r, m0 + v] * k[l, n0 + r, m0 + v])
                                    d2 = f32(np.sum((x[n0 + r] - z[m0 + v]) ** 2, dtype=f32))
                                    sg = f32(sg + gk)
                                    sd = f32(sd + gk * d2)
                                    w[r, v] = f32(w[r, v] + gk * inv_ell2[l])
                            s_gk[l, li], s_gkd2[l, li] = sg, sd
                        for r in range(BWD_ROWS):
                            if col_live and n0 + r < N:
                                for d in range(D):
                                    acc_dx[r, d, li] = np.sum(
                                        w[r] * (z[m0:m0 + vec, d] - x[n0 + r, d]), dtype=f32)
                                for v in range(vec):
                                    dz_acc[ty, tx, v] += (w[r, v] * (x[n0 + r] - z[m0 + v])
                                                          ).astype(f32)
                        w_all[ty, tx] = w
                    for l in range(L):
                        part[l, 0, warp] = _warp_sum(s_gk[l])
                        part[l, 1, warp] = _warp_sum(s_gkd2[l])
                    for r in range(BWD_ROWS):
                        for d in range(D):
                            sdx[warp, r, d] = _warp_sum(acc_dx[r, d])
            part_at = group * strips + strip
            phyper[:, :, part_at] = np.transpose(part.sum(axis=2, dtype=f32), (1, 0))
            for row in range(GROUP_ROWS):
                n = group * GROUP_ROWS + row
                if n < N:
                    pdx[strip, n] = sdx[(row // BWD_ROWS) * 2:(row // BWD_ROWS) * 2 + 2,
                                        row % BWD_ROWS].sum(axis=0, dtype=f32)
        for tx in range(BWD_TX):
            m0 = (strip * BWD_TX + tx) * vec
            if m0 < M:
                pdz[tile, m0:m0 + vec] = dz_acc[:, tx].sum(axis=0, dtype=f32)
    dx = np.array([[_new_slab_sum(pdx.reshape(strips, -1), strips, n * D + d)
                    for d in range(D)] for n in range(N)])
    dz = np.array([[_new_slab_sum(pdz.reshape(tiles, -1), tiles, m * D + d)
                    for d in range(D)] for m in range(M)])
    sums = np.array([[_new_tree(phyper[q, l]) for l in range(L)] for q in range(2)])
    return dx, dz, sums


@pytest.mark.parametrize("N,M,L,D", [(21, 30, 3, 2), (16, 7, 2, 1), (5, 12, 33, 3)])
def test_replay_of_the_plan_gives_the_closed_form(N, M, L, D):
    rng = np.random.default_rng(N * M + L)
    x = (rng.random((N, D)) * 4 - 2).astype(np.float32)
    z = (rng.random((M, D)) * 4 - 2).astype(np.float32)
    sigma = np.linspace(0.5, 2.0, L).astype(np.float32)
    ell = np.linspace(0.3, 3.0, L).astype(np.float32)
    k = gram_cuda.rbf_gram_plain(*(torch.from_numpy(a).double() for a in (x, z, sigma, ell)))
    g = rng.standard_normal((L, N, M))
    dx, dz, sums = _replay(g.astype(np.float32), k.numpy().astype(np.float32), x, z, ell,
                           N, M, L, D)
    ref = gram_cuda.rbf_gram_bwd_plain(torch.from_numpy(g), *(
        torch.from_numpy(a).double() for a in (x, z, sigma, ell)), k)
    ell64 = ell.astype(np.float64)
    got = (dx, dz, 2.0 * sums[0] / sigma.astype(np.float64), sums[1] / ell64 ** 3)
    for a, b in zip(got, ref):
        b = b.numpy()
        assert np.abs(a - b).max() <= 2e-5 * max(1.0, np.abs(b).max())


def _static_smem(D, vec):
    """part, sdx, sdz and the helper's place."""
    return 4 * (2 * LC * 2 * WARPS + 2 * WARPS * BWD_ROWS * D + BWD_TY * vec * D * BWD_TX) + 4


def _ring_bytes(vec):
    return STAGES * 2 * BWD_ROWS * THREADS * vec * 4


def test_the_ring_and_shared_buffers_fit():
    src = _src()
    assert "constexpr int ring_bytes(int vec) { return STAGES * 2 * BWD_ROWS * THREADS * vec * 4; }" in src
    assert "__launch_bounds__(THREADS, D <= 2 ? 2 : 1)" in src
    for D in range(1, 9):
        for vec in (1, 2, 4):
            total = _static_smem(D, vec) + _ring_bytes(vec)
            assert total <= SMEM_PER_BLOCK
            assert _static_smem(D, vec) <= 48 * 1024  # static shared memory
            if D <= 2:  # two blocks an SM, as the launch bounds ask (the paths: D = 1, 2)
                assert 2 * (total + SMEM_RESERVED) <= SMEM_PER_SM
            # the sums' doubles reuse the ring once no copy is in flight
            assert 8 * THREADS * OUTS <= _ring_bytes(vec)
    assert "double* red = reinterpret_cast<double*>(ring);  // no copy is in flight any more" in src


@pytest.mark.parametrize("N,M,L", [(100, 800, 4), (12, 60, 4), (37, 30, 2), (5, 7, 3),
                                   (1000, 1000, 4), (250, 800, 4)])
def test_a_transposed_cotangent_is_read_in_place(N, M, L):
    """g with each plane transposed (a column-major solve's gradient, as the
    SVGP's Kzx gets it): fill's copies of g, a column's four rows at once
    where N % 4 == 0 (16 bytes, aligned, all four rows live) and one by one
    else, land where the consumer reads row r of column v, and read the
    element the contiguous layout would."""
    vec, strips, chunks, tiles, items, _ = _plan(N, M, L)
    g = np.arange(L * N * M, dtype=np.int64).reshape(L, N, M)
    gt_flat = np.ascontiguousarray(np.transpose(g, (0, 2, 1))).ravel()
    for item in range(items):
        tile, strip = divmod(item, strips)
        for c in range(chunks):
            for thread in range(THREADS):
                n0 = (tile * chunks + c) * GROUP_ROWS + thread // BWD_TX * BWD_ROWS
                m0 = (strip * BWD_TX + thread % BWD_TX) * vec
                if m0 >= M or n0 >= N:
                    continue  # col_live false, or no row of the group: no copy
                for l in range(L):
                    for v in range(vec):
                        col = l * N * M + (m0 + v) * N + n0
                        if N % 4 == 0:
                            assert col % 4 == 0 and n0 + 3 < N
                        for r in range(BWD_ROWS):
                            if n0 + r < N:
                                assert gt_flat[col + r] == g[l, n0 + r, m0 + v]
    # ring_gt covers exactly the g half of a stage, 16 bytes a (v, thread)
    half = BWD_ROWS * THREADS * vec
    offsets = sorted((v * THREADS + t) * BWD_ROWS for v in range(vec) for t in range(THREADS))
    assert offsets == list(range(0, half, BWD_ROWS))
    src = _src()
    assert "return ring + ((stage * 2 * VEC + v) * THREADS + (int)threadIdx.x) * BWD_ROWS;" in src
    assert "const float* col = g + cur.l * plane + (int64_t)(cur.m0 + v) * a.N + cur.n0;" in src


def test_wrapper_takes_a_transposed_cotangent_without_a_copy():
    """The wrapper reads g in place when its planes are transposed: on
    ``meta`` it refuses the device, as for a contiguous g, and counts no
    copy; the closed form on the CPU gives the same gradients for both
    layouts (to float32 rounding: its sums follow the strides)."""
    rng = np.random.default_rng(3)
    L, N, M = 3, 12, 9
    x, z = (torch.from_numpy(rng.random((n, 2))).float() for n in (N, M))
    sigma, ell = torch.full((L,), 1.3), torch.linspace(0.5, 2.0, L)
    k = gram_cuda.rbf_gram_plain(x, z, sigma, ell)
    g = torch.from_numpy(rng.standard_normal((L, N, M))).float()
    g_t = g.mT.contiguous().mT
    assert not g_t.is_contiguous() and g_t.mT.is_contiguous()
    for a, b in zip(gram_cuda.rbf_gram_bwd(g, x, z, sigma, ell, k),
                    gram_cuda.rbf_gram_bwd(g_t, x, z, sigma, ell, k)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    before = (gram_cuda.rbf_gram_bwd.launches, gram_cuda.rbf_gram_bwd.copies)
    meta = [t.to("meta") for t in (g_t, x, z, sigma, ell, k)]
    with pytest.raises(ValueError):  # no kernel for meta
        gram_cuda.rbf_gram_bwd(*meta)
    assert (gram_cuda.rbf_gram_bwd.launches, gram_cuda.rbf_gram_bwd.copies) == before
