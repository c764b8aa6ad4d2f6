// Triangular contraction c = Lu^T a for the NSF posterior variance, at
// float32 accuracy on Hopper's TF32 tensor cores (3xTF32).
//
// Replaces gpzoo_tpu/ops/tri_pallas.py:
//   tri_sq_colsum_fused (_fused_impl)  -> tri_sq_colsum_c_f32 (c null)
//       out[l, b] = sum_m (sum_{k>=m} Lu[l, k, m] a[k, b])^2
//   tri_t_matmul (_fwd_impl)           -> tri_t_matmul_f32
//       c[l, m, b] = sum_{k>=m} Lu[l, k, m] a[k, b]
// Lu (L, M, M) row-major, read as structurally lower-triangular (entries
// with k < m are never read); a row-major, factor l's (M, B) slab at
// a + l * a_stride: a_stride 0 shares one (M, B) a across all L (the
// north-star projection), a_stride M*B reads a per-factor (L, M, B) a (the
// MGGP W-form step's a = W Kzx).
//
// What bounds it on an H100: the tensor cores. At the main-path shape
// (L=20, M=3000, B=7000) the triangle is 1.26e12 multiply-adds x 2 FLOP
// against ~2.7 GB of operands and scratch. 3xTF32 runs three TF32
// products per product (lo*hi + hi*lo + hi*hi), 3.8e12 FLOP at 495 TFLOP/s:
// 7.6 ms, ten times the ~0.8 ms the bytes take. The f32 FMA pipe (67
// TFLOP/s, 18.8 ms for the same triangle) is not used in the main loop.
//
// What the design does about it:
//  * Staging (tri_stage_f32, one pass): wgmma reads tf32 operands from
//    shared memory only K-major, and both Lu[k, m] and a[k, b] have k as
//    their slow axis, so one transposing pass writes
//      LuT_hi, LuT_lo (L, Mp, Mp): LuT[m, k] = Lu[k, m] for k >= m, exact
//        zeros above the diagonal and in the padding;
//      aT_hi, aT_lo (La, B, Mp): aT[b, k] = a[k, b], zeros for k >= M;
//    Mp is M rounded up to the 128 tile, hi = tf32(x) rounded to nearest
//    (cvt.rna) and lo = tf32(x - hi), so hi + lo = x to 2^-22. The zeros
//    make the diagonal tile and the ragged edges need no masks in the MMA
//    loop. LuT blocks left of a row tile's first k are never read and not
//    written. The scratch is the wrapper's (torch.empty).
//  * Main loop (tri_mma_kernel): a 128 (m) x 128 (b) output tile per
//    block, k staged 32 deep (one 128-byte swizzled row of f32). One
//    producer warp keeps TMA loads of the four hi/lo tiles in a ring of 3
//    stages of 64 KB, each guarded by a full and an empty mbarrier. Two
//    consumer warpgroups (64 rows each) issue
//    wgmma.mma_async.m64n128k8.f32.tf32.tf32 three times per k8 step into
//    one f32 accumulator: lo*hi, hi*lo, then hi*hi. The tensor cores'
//    own f32 sum loses accuracy over a long k loop, so each stage's sum
//    is added into a second register tile with FADD, rounded to nearest.
//    The k loop of row tile m0 starts at k = m0: tiles above the diagonal
//    are never visited, half the dense FLOPs.
//  * tri_t_matmul: c is stored from the accumulator fragments, masked at
//    the ragged edges. The 1-D grid runs the row tiles with the longest k
//    loops (small m0) first, so the triangle leaves no tail of idle SMs.
//  * tri_sq_colsum: the TPU kernel carries the column sum across its
//    sequential grid; Hopper blocks run in no order, so each block owns one
//    (l, 128-column) strip and walks every row tile itself. Each finished
//    tile's fragments are squared, summed over the lanes that share a
//    column by shuffles, and added into one shared-memory slot per (warp,
//    column); the eight warps' slots are summed once at the end, in a fixed
//    order. c never reaches device memory, no atomics are used, and the
//    result is the same on every run. 20 * ceil(7000/128) = 1,100 blocks of
//    one block per SM fill 8.33 waves of 132 SMs (92.6%).
//  * Registers: 288 threads cap a thread at 168. Nine warps put three on
//    one of the SM's four quarters, each with 16,384 registers: 16,384 /
//    (3 x 32) = 170, allocated in steps of 8 (65,536 / 288 = 227 would hold
//    only if the register file were one pool). ptxas gives kernels 1 and 2
//    145 with no spill; the accumulator and its promoted copy take 128, so
//    kernel 1's column sums live in shared memory. Kernel 1 keeping c takes
//    all 168 with no spill (its c store from the fragments).
//  * Offsets into Lu, a and c are 64-bit: L*M*B is 4.2e8 elements.
//
// The backward of kernel 1 (gpzoo_tpu/ops/tri_pallas.py _fused_bwd, JAX's
// vjp of the panel-blocked colsum) for g (L, B). Where a gradient is taken,
// kernel 1 keeps c (tri_sq_colsum_c_f32, kColsumC: its loop and column sums
// unchanged, each row tile's c stored from the fragments as well, the same
// bits as kernel 2's c), and the backward reads c instead of running the
// triangle again. It takes one of two routes, by its a:
//  * a shared a that takes no gradient (the north-star projection ã and the
//    fast leg's ã = K^-1 Kzx with Z and the kernel frozen: [main], [nb],
//    [fast], [ngd]'s Adam arm, [checkpoint], [parallel]'s north-star and
//    fast ranks): one entry, tri_dlu_from_c_f32 (kernel 6 reading c, kDluC),
//    forms dc = 2 g[l, b] c[l, m, b] in its own operand loads, so no dc is
//    written;
//  * a per-factor a, or a shared one that trains (the MGGP W-form, the
//    hybrids, [parallel]'s MGGP ranks): where Lu trains, dc = 2 g[l, b]
//    c[l, m, b] is one pass of bytes (tri_split_f32 given g, rows only:
//    scale_rows_kernel, below) into dc's rows, which tri_dlu_f32 reads; da
//    is one entry, tri_da_from_c_f32 (kernel 7 reading c, kDaC), which forms
//    dc^T = 2 g c^T in its own operand loads, so no dcT is written on any
//    path.
// Five entry points, the first on no path since kernel 1 keeps c, the
// fourth only in the backward of kernel 2 (below):
//   tri_dc_f32   kernel 2's loop, another epilogue: dc = 2 g[l, b] c[l, m, b]
//   tri_dlu_f32  kernel 6: dLu[l, k, m] = sum_b a[(l,) k, b] dc[l, m, b],
//                k >= m, and exact zeros for k < m (the whole (L, M, M))
//   tri_dlu_from_c_f32  kernel 6 reading c: the same dLu for a shared a, with
//                dc = 2 g c formed from c in the operand loads (below)
//   tri_da_f32   kernel 7: da[l, k, b] = sum_{m<=k} Lu[l, k, m] dc[l, m, b]
//                per factor, from dcT; a shared a's da is its sum over l,
//                which the wrapper takes after the kernel (no path needs it
//                at full width)
//   tri_da_from_c_f32  kernel 7 reading c: the same da, with dc^T = 2 g c^T
//                formed from c in the operand loads (below)
// What bounds each on an H100: the same triangle of multiply-adds as
// kernels 1-2 (L B M(M+1) FLOP, three TF32 products each), 7.6 ms at the
// north-star shape at 495 TFLOP/s; the bytes (a, dc, dLu or da, scratch)
// take ~2-3 ms. So each runs the main loop above, the same 128 x 128 tiles,
// TMA ring and stage-wise FADD promotion, and differs only in which tiles a
// block takes, where its operands come from and what its epilogue stores:
//  * wgmma reads tf32 from shared memory only K-major. dLu contracts over
//    b, the fast axis of both a and dc: no transpose, only the split. da
//    contracts over m: Lu's rows are K-major as they stand (staged split,
//    zeros above the diagonal), but dc must be read with m fast, dcT.
//  * What bounds the main loop, measured (H100 80GB HBM3 at 700 W, 20
//    calls in a CUDA graph; PERF.md): the bytes each SM takes in. A stage
//    moves 64 KB (A and B, hi and lo) for 3.1 MFLOP. With the consumers
//    releasing each stage unread, the loads alone take as long as the loop
//    (the dc epilogue at the north-star shape 15.76 ms against 14.14,
//    kernel 6 15.57 against 12.99); the hi tiles alone (32 KB) load in 7.16
//    and 5.90. TMA multicast of A to a 2-CTA cluster lowers L2's reads but
//    not the bytes an SM takes in, and ties the pair's rings together: it
//    was 14-36% slower, and splitting f32 operands in shared memory 14-44%.
//  * So the dc epilogue and kernels 6 and 7 (reg_a()) read their operand A
//    in f32 (kDc: LuT staged whole; kDlu: a's rows in place where B is a
//    multiple of 4 floats, a 16-byte row stride, else copied with the row
//    stride Bp; kDa: Lu's rows staged whole) and split it in registers:
//    each thread loads its wgmma A fragments (rows r and r + 8, k and k + 4
//    of an 8-deep step; the 128-byte swizzle puts 16-byte chunk c of row r
//    at c ^ (r % 8)), rounds them as split_store does, and issues the same
//    three products per k8 step, A from registers, B from shared memory as
//    before. A
//    stage is 48 KB (A f32, B hi, B lo) and the ring holds four. The
//    fragments of stage s + 1 are loaded and split while the tensor cores
//    run stage s; that needs 232 registers a consumer thread, so these
//    instances have a producer warpgroup (384 threads) that hands its
//    registers over with setmaxnreg (40 to the producer, 232 to each
//    consumer: 32 x (232 + 232 + 40) per quarter). Each output element
//    sees the same operands in the same order as in the staged form: the
//    outputs are the same bits.
//  * Layout of dc (the dc epilogue's choice, DcOperand in the wrapper):
//    stored already split into TF32 hi and lo, rows (2, L, M, Bp) with Bp =
//    B rounded up to 32 floats (a 128-byte row stride, which TMA needs: B =
//    129 is 516 bytes), zeros in b >= B; and, for kernel 7 on a DcOperand
//    (the backward of kernel 2), dcT (2, L, B, Mp), zeros in m >= M: kernel
//    6 reads dc as its operand B, from shared memory. The epilogue stages the
//    tile in the (then idle) ring, so that both are written by whole
//    128-byte rows and g is read once a column. Only the per-factor route
//    writes it, rows only, where Lu trains (the scale pass: 8 L M Bp bytes,
//    3.4 GB at the MGGP shape); the shared route writes none.
//  * Kernel 6 reading c (kDluC) swaps kernel 6's operands: dLu^T[m, k] =
//    sum_b dc[m, b] a[k, b], A = dc's rows (output rows m), B = a's rows
//    (columns k). A is kernel 1's c in f32 through TMA, as kernel 6 reads a
//    (in place where B is a multiple of 4 floats, else copied with the row
//    stride Bp); each thread scales its fragments by 2 g[l, b] (b the
//    fragment's k index in the stage) as scale_rows_kernel does, then splits
//    them: A holds the TF32 values the scale pass writes. The stage's 32
//    values of 2 g come with it: the producer copies them (one 128-byte bulk
//    copy from 2 g laid out in rows of Bp, zeros past B) into the stage's slot
//    of the idle red, on the stage's mbarrier. Read from L2 by each consumer
//    instead (8 loads a stage, ahead of the stage's wait), they cost 1.5-4%
//    more at the north-star shape and its factor rank's (PERF.md): their
//    latency sits on the path of the next stage's split. The scaling itself
//    costs about 11% over the same loop on c unscaled. B is a's split,
//    shared by the factors: 2 M Bp floats (168 MB at the north-star shape)
//    written once a call, in the entry, against 3.4 GB of dc (the split and
//    2g's rows take 0.10 ms there). A stage still moves 48 KB; the three
//    products go in kDlu's order (a_lo dc_hi = A_hi B_lo, a_hi dc_lo = A_lo
//    B_hi, a_hi dc_hi), so each element sums the same products in the same
//    order. Tiles: (m tile, k tile >= m tile) pairs, decoded as kernel 8's,
//    factor slowest; the epilogue stores tile (m, k) as dLu[l, k, m]
//    straight from the fragments (a warp's store is 4 rows k of 8
//    consecutive m, whole 32-byte sectors), zeros where k < m, and a tile
//    off the diagonal zeroes its mirror above it, so every element of dLu
//    is written once.
//  * Kernel 7 reading c (kDaC) swaps kernel 7's operands: da^T[b, k] =
//    sum_m dc^T[b, m] Lu[k, m], A = dc^T's rows (output rows b), B = Lu's
//    rows (columns k). A is kernel 1's c in f32: a stage is c's 32 rows m
//    for the block's 128 b, landed by TMA as four 32 x 32 boxes (the 128-byte
//    swizzle caps a box at 32 floats inside) through a map with a slab a
//    factor, so that the rows m >= M of the last stage are zeros, not the
//    next factor's c (c in place where B is a multiple of 4 floats, else
//    copied with the row stride Bp). Each thread reads its fragments
//    transposed from that tile (a 2-way bank conflict, see load_a), scales
//    them by 2 g[l, b] and splits them: a fragment row is one b, so its two
//    values of 2 g (rows r and r + 8) stay in registers for the whole block,
//    with no slot a stage as kDluC has. B is Lu's rows split into hi and lo
//    (stage_lu_rows_kernel<false>, zeros above the diagonal and in the
//    padding, 2 L Mp^2 floats: 1.51 GB at the MGGP shape, against dcT's 3.44
//    GB), staged in the entry. A stage still moves 48 KB; the three products
//    go in kDa's order (Lu_lo dc_hi = A_hi B_lo, Lu_hi dc_lo = A_lo B_hi,
//    Lu_hi dc_hi), so each element sums the same products in the same order.
//    Tiles: factor slowest, then the k tile, the longest m loop first, then
//    the b tiles: one factor's Lu rows split (38 MB at M = 3,010) and the c
//    strips of the b tiles in flight do not fit L2 together, and kernel 7's
//    order (b tile before k tile) was 2.2 ms slower at the MGGP shape
//    (PERF.md). The epilogue stores tile (b, k) as da[l, k, b] through the
//    idle ring. Every grid takes this route: at the one-wave Hybrid-NSF
//    shape it was as fast as kernel 7's split loop on dcT (PERF.md).
//  * Kernel 7's operand A, Lu's rows, cannot be read in place: a row of M =
//    3,010 floats (12,040 bytes) or 529 (2,116) is no multiple of the 16
//    bytes TMA needs, and the diagonal tile needs zeros for m > k. An
//    elementwise pass in tri_da_f32 stages them once in f32 (L Mp^2 floats,
//    0.75 GB at the MGGP shape, half of a hi/lo split), zeros above the
//    diagonal and in the padding, only the blocks the loop reads. A grid of
//    one wave or less (the Hybrid-NSF shape: 120 blocks) is bound by its
//    longest block's latency, not by the bytes an SM takes in: there the
//    register split was 13% slower (PERF.md), so such a grid stages Lu's
//    rows split and runs kernels 1-2's loop (kDaSplit), with the same bits.
//  * The dc epilogue's tiles: factor slowest, then the column tile, then the
//    row tile, the longest k loop (small m0) first. The blocks in flight
//    read one factor's LuT, whole in f32 (19 MB at M = 3,010, which L2
//    holds; 38 MB split did not fit beside the aT strips, and this order
//    was then 11-41% slower), and each aT column strip once rather than
//    once a row tile.
//  * Kernel 6's tiles (and kernel 6 reading c's, transposed): the (k tile
//    >= m tile) pairs only, 300 a factor at M = 3,010, all with the same
//    B/32-stage loop, so the triangle leaves no tail; factor slowest, k
//    tiles in order, so the blocks in flight share a few tiles of a and the
//    dc tiles of one factor. A block below the diagonal also writes the
//    zeros of its mirror tile above it, so every element of dLu is written
//    once and the wrapper fills nothing.
//  * Kernel 7's tiles: factor slowest, then the b tile, then the k tiles,
//    longest m loop (k0 + 128) first; the blocks in flight share one
//    factor's Lu and a few dcT tiles. Tiles right of the diagonal are never
//    read (their Lu blocks are not staged).
//  * No atomics: each output element is summed inside one block in a fixed
//    order, so two runs give the same bits (the step checks replay floor
//    decisions and need that). Offsets into every tensor are 64-bit.
//
// The backward of kernel 2 (gpzoo_tpu/ops/tri_pallas.py _tri_bwd) for a
// dense cotangent g (L, M, B) of c: dLu = tril(a g^T) and da = Lu g over
// the lower triangle are kernels 6 and 7 with dc = g. One more entry,
//   tri_split_f32  g split into TF32 hi and lo in dc's layout above: rows
//                  (2, L, M, Bp), zeros for b >= B, and, unless rows_t is
//                  null, rows_t (2, L, B, Mp), zeros for m >= M,
// brings g into the operand layout kernels 6 and 7 read. It moves bytes
// only (g read once, 2 x 4 L M Bp written, twice that with rows_t): 32 x 32
// tiles through shared memory, g read and rows written along b, rows_t
// written along m, each by consecutive threads, and the same rounding
// (cvt.rna, then the remainder) as the dc epilogue. Given kernel 1's kept c
// and the colsum's cotangent g (L, B), the entry is the scale pass
// (scale_rows_kernel: blocks of 512 16-byte chunks of a row, no tile in
// shared memory), which scales first, v = (2 g[l, b]) c[l, m, b] as the dc epilogue
// multiplies, and writes rows only (no path asks for dcT since kernel 7
// reads c): kernel 1's backward then reads c once where the dc epilogue ran
// the triangle again (7.6 ms of bound at the north-star shape against 1.5
// ms of bytes).
//
// Kernel 8: the KL trace tr(K^-1 Lu Lu^T) of every step and its backward.
// It replaces no Pallas kernel: the JAX package leaves it to XLA
// (gpzoo_tpu/ops/tri_blocked.py:75 tri_kl_trace, six panel einsums; their
// backward is autograd's), which the port ran as panel bmm's, dots and
// full-size fills and adds of the (L, M, M) gradient. Three entry points:
//   tri_kl_trace_f32        out[l] = sum_{i >= j} P[l, i, j] Lu[l, i, j], and,
//                           given p (Lu per factor), P itself, tril, kept by
//                           the caller for the backward
//   tri_kl_trace_scale_f32  dLu[l, i, j] = (2 g[l]) P[l, i, j] for i >= j, else 0,
//                           from the kept P: the backward where Lu is per factor
//   tri_kl_trace_bwd_f32    the same dLu with P recomputed: the backward of one
//                           Lu under a per-factor K^-1 (below)
// with P = K_s Lu, K_s = (K^-1 + K^-T)/2. Lu Lu^T is symmetric, so
// tr(K_s Lu Lu^T) is the trace for any K^-1, and 2 K_s Lu is JAX's gradient
// (K^-1 + K^-T) Lu. K^-1 (M, M) is shared by all factors or per factor
// (Lk = L); Lu (Llu, M, M) per factor or one shared Lu (Llu = 1) under a
// per-factor K^-1, whose dLu is then sum_l 2 g[l] K_s[l] Lu: one factor of
// K_c = sum_l g[l] K_s[l], summed in the order of l when K^-1 is staged.
// Keeping the L products K_s[l] Lu for that form would take L times P's
// memory, so it recomputes; no leg of the paths runs it.
// What bounds it on an H100: the forward, the exact triangle, output (i >= j)
// and contraction (k >= j) alike, M^3/3 multiply-adds a factor, 2/3 M^3 L FLOP
// (3.6e11 at L = 20, M = 3,000), three TF32 products each: 2.2 ms at 495
// TFLOP/s, against 0.23 ms for the bytes (a shared K^-1, Lu's lower triangle
// and P's; 0.43 ms with a per-factor K^-1). The backward from P, bytes only:
// P's lower triangle read and dLu written whole, 1.09 GB, 0.32 ms at 3.35
// TB/s.
// So the forward runs the main loop above on P^T[j, i] = sum_{k >= j}
// Lu[k, j] K_s[i, k], with B = K_s staged split and symmetrized
// (stage_trace_kernel: 32 x 32 tiles through shared memory, K[i, k] and
// K[k, i] both read along their rows), rows and columns padded to Mp with
// zeros, and A, Lu's columns j, split in registers. Only the tiles with
// column tile ct >= row tile rt are visited (nrt (nrt + 1) / 2 a factor),
// each with the k loop from the row tile's first k.
//  * Keeping P (every path: trace_p_kernel, a persistent grid). Measured
//    (H100 80GB HBM3 at 700 W; PERF.md), the one-tile-a-block grid's call
//    (4.53-4.83 ms at the north-star shape against a 2.18-ms bound) was its
//    loop without P (~3.9-4.1), LuT's staging (~0.37; its only use was to
//    make Lu's columns the K-major operand A), P through the idle ring
//    (~0.2-0.4) and the zeros of a mirror tile above P's diagonal that no
//    one reads (~0.2). So: min(SMs, tiles) blocks, whose producers take the
//    tiles one at a time from a counter in the order of trace_tile (a
//    static list handed out round-robin left the tiles in flight far apart
//    in the list, ~0.9 ms slower), and run on into the next tile's stages
//    while the consumers finish this one; A read in place from Lu's rows
//    (TMA boxes of 32 j through a map with a slab a factor), transposed into
//    the fragments as kernel 7 reading c reads c, Lu's entries above its
//    diagonal set to 0 in the row tile's diagonal stages (where a row of Lu
//    is off 16 bytes, M % 4 != 0, from a copy of its rows with the row
//    stride Mp, trace_lu_rows_kernel: only what is read);
//    P stored straight from the fragments, below and on the diagonal only,
//    the ring left to the next tile's loads. The loop itself is as fast as
//    before: with operand A's loads, or B's, or the transposed read taken
//    out it runs ~7-10% faster, so no one of them bounds it (PERF.md).
//  * Without P (kTrace, no path) and the recompute (kTraceBwd): the
//    one-tile-a-block grid on LuT staged whole in f32 (stage_trace_kernel:
//    blocks z < Llu), factor slowest, then ct, the longest k loop (small rt)
//    first, as the dc epilogue orders its tiles.
//  * Trace epilogue (kTrace, trace_p_kernel): each thread sums its 64
//    elements of P^T times Lu[i, j] where j <= i < M, else 0 (LuT's zeros)
//    in double, then the warp's 32 sums by shuffles and the eight warps' in a
//    fixed order into one double a tile, at the tile's index in the
//    one-tile-a-block grid. The block then takes a ticket of its factor (an
//    acq_rel atomic add); the factor's last tile's block adds the factor's
//    partials in a fixed order (256 strided sums, then a tree) into out[l]
//    and sets the ticket back to 0, so a CUDA graph replays. No float
//    atomics: two runs give the same bits, and both grids the same.
//  * dLu epilogue (kTraceBwd, 2 g[l] P): the tile goes through the idle ring
//    in shared memory, as the dc epilogue's does, and the rows i are written
//    by consecutive threads along j, where i >= j and 0 above; a block off
//    the diagonal (ct > rt) also zeroes its mirror tile above it, so every
//    element is written once and nothing is filled. The backward from P
//    scales in one pass (trace_scale_kernel, a warp a row, 16 bytes a lane),
//    reading only P's lower triangle (its upper one is never written), with
//    the recomputing backward's arithmetic: the same tile, the same (2 g[l])
//    product, the same bits.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int TM = 128;                    // rows m per output tile
constexpr int TN = 128;                    // columns b per output tile
constexpr int TK = 32;                     // k per stage: 128 bytes of f32
constexpr int B_ALIGN = 32;                // floats: dc's and a's staged row stride
constexpr int STAGES = 3;
constexpr int CONSUMERS = 2;               // warpgroups, 64 rows each
constexpr int CONSUMER_WARPS = 4 * CONSUMERS;
constexpr int THREADS = 32 * CONSUMER_WARPS + 32;  // + one producer warp
constexpr int TILE_BYTES = TM * TK * 4;    // one 128 x 32 f32 operand tile
static_assert(TM == TN, "A and B tiles share TILE_BYTES and the TMA box");
constexpr int STAGE_BYTES = 4 * TILE_BYTES;  // A hi, A lo, B hi, B lo
constexpr int RED_BYTES = CONSUMER_WARPS * TN * 4;
static_assert(TN * 4 <= RED_BYTES, "the dc epilogue's 2g fits red");
static_assert(256 * 8 + 4 <= RED_BYTES, "kernel 8's 256 sums and its flag fit red");
static_assert(4 * TK * 4 <= RED_BYTES, "kernel 6 reading c's 2 g, a slot a stage, fits red");
constexpr int C_BOX = 32;                  // kernel 7 reading c: c's stage tile, boxes of 32 b
static_assert(TM / C_BOX * C_BOX * TK * 4 == TILE_BYTES, "four boxes of c fill operand A's tile");

// What a block of the main loop computes (the template argument of
// tri_mma_kernel, an int so that its instances are named <0>..<11>; 8 names
// no instance, only the sizes of trace_p_kernel, kernel 8 keeping P).
constexpr int kColsum = 0;  // kernel 1: colsum(c^2)
constexpr int kC = 1;       // kernel 2: c
constexpr int kDc = 2;      // kernel 2, dc epilogue: 2 g c, split (and dcT)
constexpr int kDlu = 3;     // kernel 6: dLu
constexpr int kDa = 4;      // kernel 7: da
constexpr int kDaSplit = 5; // kernel 7 on a grid of one wave: Lu's rows staged split
constexpr int kTrace = 6;   // kernel 8: the KL trace
constexpr int kTraceBwd = 7;  // kernel 8's backward, P recomputed: dLu
constexpr int kTraceP = 8;  // kernel 8 keeping P: the KL trace and P (trace_p_kernel)
constexpr int kColsumC = 9; // kernel 1 keeping c: colsum(c^2) and c
constexpr int kDluC = 10;   // kernel 6 reading c: dLu, dc = 2 g c formed in the A loads
constexpr int kDaC = 11;    // kernel 7 reading c: da, dc^T = 2 g c^T formed in the A loads
__host__ __device__ constexpr bool is_colsum(int mode) { return mode == kColsum || mode == kColsumC; }
__host__ __device__ constexpr bool is_da(int mode) { return mode == kDa || mode == kDaSplit; }
__host__ __device__ constexpr bool is_trace(int mode) {
  return mode == kTrace || mode == kTraceBwd || mode == kTraceP;
}

// The instances whose operand A crosses from L2 in f32 and is split into
// TF32 hi and lo in registers (wgmma's A from registers): a stage is A f32,
// B hi, B lo, 48 KB, and the ring holds four.
__host__ __device__ constexpr bool reg_a(int mode) {
  if (is_trace(mode)) return true;  // kernel 8: LuT whole, as the dc epilogue
  if (mode == kDluC) return true;   // kernel 6 reading c: c's rows, scaled by 2g
  if (mode == kDaC) return true;    // kernel 7 reading c: c's tile read transposed, scaled by 2g
  return mode == kDc || mode == kDlu || mode == kDa;
}
constexpr int REG_A_STAGES = 4;
constexpr int REG_A_STAGE_BYTES = 3 * TILE_BYTES;
// Their blocks have a producer warpgroup (one thread issues the loads) that
// gives its registers to the two consumer warpgroups (setmaxnreg): 2 x 128
// threads at 232 and 128 at 40 fill the 65,536; each quarter of the SM
// holds one warp of each warpgroup, 32 x (232 + 232 + 40) <= 16,384.
constexpr int REG_A_PRODUCER_REGS = 40;
constexpr int REG_A_CONSUMER_REGS = 232;
__host__ __device__ constexpr int threads(int mode) {
  return reg_a(mode) ? 32 * CONSUMER_WARPS + 128 : THREADS;
}
__host__ __device__ constexpr int stages(int mode) { return reg_a(mode) ? REG_A_STAGES : STAGES; }
__host__ __device__ constexpr int stage_bytes(int mode) {
  return reg_a(mode) ? REG_A_STAGE_BYTES : STAGE_BYTES;
}
__host__ __device__ constexpr int smem_bytes(int mode) {
  return 1024 + stages(mode) * stage_bytes(mode) + RED_BYTES + 2 * stages(mode) * 8;
}
static_assert(smem_bytes(kDc) <= 232448, "the ring fits a block's shared memory");
static_assert(TM * (TN + 1) * 4 <= REG_A_STAGES * REG_A_STAGE_BYTES,
              "the dc epilogue's tile fits the ring");

// The main loop's operands A (rows of the output tile) and B (its
// columns) are read through tensor maps; a factor l's slab starts at row
// l * a_slab (b_slab) of its map, 0 for an operand shared by all factors.
struct Args {
  float* out;        // colsum (L, B), c (L, M, B), dLu or P (L, M, M) or da (L, M, B)
  float* c;          // kColsumC: c (L, M, B) beside the colsum
  float* dc;         // kDc: dc hi, then lo at + L M Bp
  float* dct;        // kDc: dcT hi, then lo at + L B Mp; null: not written
  const float* g;    // kDc, kDaC: (L, B); kDluC: 2 g (L, Bp), 0 for b >= B;
                     // kTraceBwd: (L,), null: 1 (K_c)
  const float* lut;  // kTrace: LuT as staged (Llu, Mp, Mp)
  const float* lu;   // trace_p_kernel: Lu (L, M, M) as it stands, for the trace
  double* partial;   // kTrace, trace_p_kernel: one sum a tile
  float* trace;      // kTrace, trace_p_kernel: (L,)
  unsigned* tickets; // kTrace, trace_p_kernel: one a factor, 0 before and after
  int L, M, B, Mp, Bp;
  int a_slab, b_slab;
  int nk;            // stages of the whole contraction
};

__host__ __device__ constexpr int round_up(int x, int to) { return (x + to - 1) / to * to; }

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xffffe000u);
}

__device__ __forceinline__ void split_store(float v, float* hi, float* lo, int64_t i) {
  const float h = tf32_rna(v);
  hi[i] = h;
  lo[i] = tf32_rna(v - h);
}

// LuT[l, m, k] = Lu[l, k, m] for k >= m, else 0, for the blocks the MMA
// loop reads (k >= the first row of m's 128-row tile). 32 x 32 blocks
// through shared memory (t): reads coalesce along m, writes along k. Split
// into hi and lo, or (kF32, the dc epilogue's and kernel 8's operand A)
// whole into hi.
template <bool kF32>
__device__ __forceinline__ void stage_lu_tile(float (&t)[32][33], const float* __restrict__ lu,
                                              float* __restrict__ hi, float* __restrict__ lo,
                                              int M, int Mp, int l) {
  const int k0 = blockIdx.x * 32, m0 = blockIdx.y * 32;
  if (k0 < (m0 / TM) * TM) return;  // left of the row tile's first k
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const float* lu_l = lu + (int64_t)l * M * M;
#pragma unroll
  for (int r = ty; r < 32; r += 8) {
    const int k = k0 + r, m = m0 + tx;
    // k >= m also keeps m < M, since k < M
    t[r][tx] = (k < M && k >= m) ? lu_l[(int64_t)k * M + m] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int r = ty; r < 32; r += 8) {
    const int64_t i = ((int64_t)l * Mp + m0 + r) * Mp + k0 + tx;
    if constexpr (kF32) hi[i] = t[tx][r];
    else split_store(t[tx][r], hi, lo, i);
  }
}

template <bool kF32>
__global__ void __launch_bounds__(256)
stage_lu_kernel(const float* __restrict__ lu, float* __restrict__ hi,
                float* __restrict__ lo, int M, int Mp) {
  __shared__ float t[32][33];
  stage_lu_tile<kF32>(t, lu, hi, lo, M, Mp, blockIdx.z);
}

// aT[l, b, k] = a[l, k, b] for k < M, 0 for M <= k < Mp; rows b < B.
__global__ void __launch_bounds__(256)
stage_a_kernel(const float* __restrict__ a, float* __restrict__ hi,
               float* __restrict__ lo, int M, int B, int Mp, int64_t a_stride) {
  __shared__ float t[32][33];
  const int k0 = blockIdx.x * 32, b0 = blockIdx.y * 32, l = blockIdx.z;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const float* a_l = a + l * a_stride;
#pragma unroll
  for (int r = ty; r < 32; r += 8) {
    const int k = k0 + r, b = b0 + tx;
    t[r][tx] = (k < M && b < B) ? a_l[(int64_t)k * B + b] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int r = ty; r < 32; r += 8) {
    const int b = b0 + r;
    if (b < B) split_store(t[tx][r], hi, lo, ((int64_t)l * B + b) * Mp + k0 + tx);
  }
}

// Kernel 6's operand A where a's rows cannot be read in place (B not a
// multiple of 4 floats: TMA wants 16-byte row strides): a_rows[s, k, b] =
// a[s, k, b] with the row stride Bp, zeros for B <= b < Bp, in f32.
__global__ void __launch_bounds__(256)
stage_a_rows_kernel(const float* __restrict__ a, float* __restrict__ rows, int M, int B,
                    int Bp, int64_t a_stride) {
  const int b = blockIdx.x * 256 + threadIdx.x, k = blockIdx.y, s = blockIdx.z;
  if (b >= Bp) return;
  rows[((int64_t)s * M + k) * Bp + b] = b < B ? a[s * a_stride + (int64_t)k * B + b] : 0.f;
}

// Kernel 7's operand A: Lu's rows, lu_rows[l, k, m] = Lu[l, k, m] for
// m <= k < M, else 0, (L, Mp, Mp) with the row stride Mp (a multiple of 128
// floats: TMA wants 16-byte row strides, and M = 3,010 is 12,040 bytes);
// only the columns m below the end of k's row tile, all that kernel 7
// reads. In f32 (kF32, into rows) or split into hi (rows) and lo.
template <bool kF32>
__global__ void __launch_bounds__(256)
stage_lu_rows_kernel(const float* __restrict__ lu, float* __restrict__ rows,
                     float* __restrict__ lo, int M, int Mp) {
  const int m = blockIdx.x * 256 + threadIdx.x, k = blockIdx.y, l = blockIdx.z;
  if (m >= (k / TM + 1) * TM) return;
  // m <= k < M also keeps m < M
  const float v = (k < M && m <= k) ? lu[((int64_t)l * M + k) * M + m] : 0.f;
  const int64_t i = ((int64_t)l * Mp + k) * Mp + m;
  if constexpr (kF32) rows[i] = v;
  else split_store(v, rows, lo, i);
}

// Kernel 8 keeping P's operand A where Lu's rows cannot be read in place:
// stage_lu_rows_kernel<true>'s values in the same places, a block a row k
// (its columns m below the end of k's row tile), 16 bytes a thread: four
// reads (a row of Lu may be off 16 bytes) and one vector store.
__global__ void __launch_bounds__(256)
trace_lu_rows_kernel(const float* __restrict__ lu, float* __restrict__ rows, int M, int Mp) {
  const int k = blockIdx.x, l = blockIdx.y;
  const float* row = lu + ((int64_t)l * M + (k < M ? k : 0)) * M;
  float4* out = reinterpret_cast<float4*>(rows + ((int64_t)l * Mp + k) * Mp);
  for (int c = threadIdx.x; c < (k / TM + 1) * (TM / 4); c += blockDim.x) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = (k < M && 4 * c + e <= k) ? row[4 * c + e] : 0.f;
    out[c] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// Kernel 6 reading c's 2 g: g2[l, b] = 2 g[l, b] for b < B (scale_rows_kernel's
// product), 0 for B <= b < Bp; rows of Bp floats, so that each stage's 32
// are one 128-byte bulk copy.
__global__ void __launch_bounds__(256)
double_g_kernel(const float* __restrict__ g, float* __restrict__ g2, int L, int B, int Bp) {
  const int64_t i = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= (int64_t)L * Bp) return;
  const int l = (int)(i / Bp), b = (int)(i % Bp);
  g2[i] = b < B ? 2.f * g[(int64_t)l * B + b] : 0.f;
}

// x (L, M, B) split into rows (hi, then lo at + L M Bp) and, unless null,
// rows_t (hi, then lo at + L B Mp); one 32 x 32 (m, b) tile a block.
__global__ void __launch_bounds__(256)
split_kernel(const float* __restrict__ x, float* __restrict__ rows, float* __restrict__ rows_t,
             int L, int M, int B, int Mp, int Bp) {
  __shared__ float t[32][33];
  const int b0 = blockIdx.x * 32, m0 = blockIdx.y * 32, l = blockIdx.z;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const float* x_l = x + (int64_t)l * M * B;
  const int64_t lo_rows = (int64_t)L * M * Bp;
  const int b = b0 + tx;  // b < Bp: the grid covers Bp exactly
#pragma unroll
  for (int r = ty; r < 32; r += 8) {
    const int m = m0 + r;
    const float v = m < M && b < B ? x_l[(int64_t)m * B + b] : 0.f;
    t[r][tx] = v;
    if (m < M) split_store(v, rows, rows + lo_rows, ((int64_t)l * M + m) * Bp + b);
  }
  if (rows_t == nullptr) return;
  __syncthreads();
  const int64_t lo_t = (int64_t)L * B * Mp;
#pragma unroll
  for (int r = ty; r < 32; r += 8) {
    const int bt = b0 + r, m = m0 + tx;  // m < Mp: the grid covers Mp exactly
    if (bt < B) split_store(t[tx][r], rows_t, rows_t + lo_t, ((int64_t)l * B + bt) * Mp + m);
  }
}

// The scale pass (tri_split_f32 given g): dc = (2 g[l, b]) c[l, m, b] split
// into rows (hi, then lo at + L M Bp), the dc epilogue's product (2 g first,
// then times c, rounded once), so from kernel 1's c the dc epilogue's bits,
// with no tile in shared memory. Bytes only: c read once and the rows
// written, 1.51 ms at the MGGP shape at 3.35 TB/s. A block takes
// SCALE_PART = 512 16-byte chunks of one (l, m) row (rows of Bp floats, a
// multiple of 32, zeros for b >= B): thread t the chunks t + 128 j, j < 4,
// so a warp's load or store is 512 contiguous bytes, and all four chunks of
// c and of g are loaded before any is split and stored. c and g are read as
// float4 where B is a multiple of 4 floats and both start 16-byte aligned
// (kVec), one float at a time else. Small blocks keep the last wave short
// (with 8 whole rows a block it cost 8% at the MGGP shape): 1.75 ms there,
// where torch.frexp, one read and two writes of c's size, takes 1.77
// (PERF.md).
// No path asks for dcT since kernel 7 reads c, so the pass writes none.
constexpr int SCALE_THREADS = 128, SCALE_CHUNKS = 4;
constexpr int SCALE_PART = SCALE_THREADS * SCALE_CHUNKS;  // 16-byte chunks a block
template <bool kVec>
__global__ void __launch_bounds__(SCALE_THREADS)
scale_rows_kernel(const float* __restrict__ c, const float* __restrict__ g,
                  float* __restrict__ rows, int L, int M, int B, int Bp, int parts) {
  const int64_t row = blockIdx.x / parts;  // l M + m
  const int part = blockIdx.x % parts;
  const float* c_row = c + row * B;
  const float* g_row = g + row / M * B;
  float* hi_row = rows + row * Bp;
  float* lo_row = hi_row + (int64_t)L * M * Bp;
  float x[SCALE_CHUNKS][4], gb[SCALE_CHUNKS][4];
#pragma unroll
  for (int j = 0; j < SCALE_CHUNKS; ++j) {
    const int b = 4 * (part * SCALE_PART + j * SCALE_THREADS + (int)threadIdx.x);
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = gb[j][e] = 0.f;
    if (kVec && b < B) {  // b + 3 < B
      const float4 xv = *reinterpret_cast<const float4*>(c_row + b);
      const float4 gv = __ldg(reinterpret_cast<const float4*>(g_row + b));
      x[j][0] = xv.x, x[j][1] = xv.y, x[j][2] = xv.z, x[j][3] = xv.w;
      gb[j][0] = gv.x, gb[j][1] = gv.y, gb[j][2] = gv.z, gb[j][3] = gv.w;
    } else if (!kVec) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (b + e < B) x[j][e] = c_row[b + e], gb[j][e] = __ldg(g_row + b + e);
    }
  }
#pragma unroll
  for (int j = 0; j < SCALE_CHUNKS; ++j) {
    const int b = 4 * (part * SCALE_PART + j * SCALE_THREADS + (int)threadIdx.x);
    if (b >= Bp) break;
    float h[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // 2 g, then times c, rounded here, never contracted into v - hi; 0 for b >= B
      const float v = b + e < B ? __fmul_rn(2.f * gb[j][e], x[j][e]) : 0.f;
      h[e] = tf32_rna(v);
      lo[e] = tf32_rna(v - h[e]);
    }
    *reinterpret_cast<float4*>(hi_row + b) = make_float4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<float4*>(lo_row + b) = make_float4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// Kernel 8's operand B: K_s = (K + K^T)/2 split into hi and lo, (Ls, Mp, Mp)
// with zeros for i >= M or k >= M: slab s of K (one K, or one a factor), or
// (kCombine) the one slab sum_{l < L} g[l] (K_l + K_l^T)/2, summed in the
// order of l. One 32 x 32 (i, k) tile a block: K[i, k] read along k, K[k, i]
// along i through shared memory (t).
template <bool kCombine>
__device__ __forceinline__ void stage_ksym_tile(float (&t)[32][33], const float* __restrict__ k,
                                                const float* __restrict__ g,
                                                float* __restrict__ hi, float* __restrict__ lo,
                                                int M, int Mp, int L, int s) {
  const int k0 = blockIdx.x * 32, i0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int f = 0; f < (kCombine ? L : 1); ++f) {
    const float* k_f = k + (int64_t)(kCombine ? f : s) * M * M;
    __syncthreads();  // the last factor's reads of t are done
#pragma unroll
    for (int r = ty; r < 32; r += 8) {
      const int kk = k0 + r, i = i0 + tx;
      t[r][tx] = (kk < M && i < M) ? k_f[(int64_t)kk * M + i] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + ty + 8 * q, kk = k0 + tx;
      // t[tx][ty + 8 q] = K[k, i]
      const float v = (i < M && kk < M) ? 0.5f * (k_f[(int64_t)i * M + kk] + t[tx][ty + 8 * q])
                                        : 0.f;
      acc[q] = kCombine ? fmaf(g[f], v, acc[q]) : v;
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    split_store(acc[q], hi, lo, ((int64_t)s * Mp + i0 + ty + 8 * q) * Mp + k0 + tx);
}

// Kernel 8's staging in one launch: blocks z < Llu write factor z's LuT whole
// into lut (Llu, Mp, Mp), the others slab z - Llu of K_s (or the one K_c)
// split into k_hi and k_lo.
template <bool kCombine>
__global__ void __launch_bounds__(256)
stage_trace_kernel(const float* __restrict__ lu, float* __restrict__ lut,
                   const float* __restrict__ k, const float* __restrict__ g,
                   float* __restrict__ k_hi, float* __restrict__ k_lo, int M, int Mp, int Llu,
                   int L) {
  __shared__ float t[32][33];
  if ((int)blockIdx.z < Llu)
    stage_lu_tile<true>(t, lu, lut, nullptr, M, Mp, blockIdx.z);
  else
    stage_ksym_tile<kCombine>(t, k, g, k_hi, k_lo, M, Mp, L, blockIdx.z - Llu);
}

// Kernel 8's backward from the kept P (L, M, M): dlu[l, i, j] = (2 g[l])
// P[l, i, j] for j <= i, 0 above, every element written. A warp a row (l, i),
// 16 bytes a lane; the row's floats before its first 16-byte boundary (P and
// dLu, both 16-byte aligned, share it) and after its last go one a lane. P is
// read only in the chunks that hold some j <= i.
__global__ void __launch_bounds__(256)
trace_scale_kernel(const float* __restrict__ p, const float* __restrict__ g,
                   float* __restrict__ dlu, int L, int M) {
  const int64_t row = (int64_t)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (int64_t)L * M) return;
  const int l = (int)(row / M), i = (int)(row % M);
  const float s = 2.f * g[l];
  const int64_t base = row * M;
  const float* pr = p + base;
  float* dr = dlu + base;
  const int head = min((int)((4 - (base & 3)) & 3), M);
  const int n4 = (M - head) / 4, tail = head + 4 * n4;
  if (lane < head) dr[lane] = lane <= i ? s * pr[lane] : 0.f;
  if (tail + lane < M) dr[tail + lane] = tail + lane <= i ? s * pr[tail + lane] : 0.f;
  const float4* p4 = reinterpret_cast<const float4*>(pr + head);
  float4* d4 = reinterpret_cast<float4*>(dr + head);
#pragma unroll 4
  for (int c = lane; c < n4; c += 32) {
    const int j = head + 4 * c;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j <= i) {
      const float4 x = __ldcs(p4 + c);  // read once: evict first
      v.x = s * x.x;
      v.y = j + 1 <= i ? s * x.y : 0.f;
      v.z = j + 2 <= i ? s * x.z : 0.f;
      v.w = j + 3 <= i ? s * x.w : 0.f;
    }
    d4[c] = v;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// Adds 1 to *p and returns the old value, releasing the thread's earlier
// writes and acquiring what earlier adds released (gram.cu's ticket).
__device__ __forceinline__ unsigned ticket(unsigned* p) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;" : "=r"(old) : "l"(p) : "memory");
  return old;
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// One 32 (k) x 128 (row) box of a 2-D tensor map into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int k, int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row), "r"(bar)
      : "memory");
}

// One 32 (x) x rows (y) box of slab z of a 3-D tensor map into shared memory.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int x, int y,
                                            int z, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(bar)
      : "memory");
}

// ``bytes`` (a multiple of 16) from global memory into shared memory, both
// 16-byte aligned, completing on the mbarrier bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar) : "memory");
}

// wgmma descriptor of a K-major tile with 128-byte swizzle: rows of 128
// bytes, 8-row atoms 1024 bytes apart (SBO), LBO unused (1).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 f32 per thread, the m64n128 accumulator) = A·B (kAccumulate 0) or
// += A·B (1) for one k8 step, A (64 x 8) and B (128 x 8) K-major tf32
// tiles read through descriptors.
template <int kAccumulate>
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "n"(kAccumulate));
}

// The same product with A (64 x 8) from registers: each warp's 16 rows of
// the warpgroup's 64, a[0..3] at (row lane/4, column lane%4), (row + 8,
// column), (row, column + 4), (row + 8, column + 4), as TF32 bits.
template <int kAccumulate>
__device__ __forceinline__ void wgmma_tf32_ra(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(kAccumulate));
}

__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// The main loop. A block computes one 128 x 128 output tile (kernel 1: a
// column strip, every row tile in turn) as A (rows) times B^T (columns)
// over the stages [k_begin, k_end) of the contraction, A and B the staged
// hi/lo operands, then stores it as kMode says:
//   kColsum, kColsumC, kC, kDc: A = LuT (rows m), B = aT (columns b), k >= m0
//   kDlu: A = a's rows (rows k), B = dc (columns m), all of b
//   kDluC: A = c's rows scaled by 2g (rows m), B = a (columns k), all of b
//   kDa, kDaSplit: A = Lu's rows (rows k), B = dcT (columns b), m < k0 + 128
//   kDaC: A = c's tile read transposed, scaled by 2g (rows b), B = Lu's rows
//     (columns k), m < k0 + 128
// reg_a(kMode): A is read in f32 (kDc: LuT staged whole; kDlu: a's rows as
// they stand; kDluC: c's rows; kDa: Lu's rows staged whole; kDaC: c's tile)
// and split into hi and lo in registers.
template <int kMode>
__global__ void __launch_bounds__(threads(kMode), 1)
tri_mma_kernel(const __grid_constant__ CUtensorMap a_hi,
               const __grid_constant__ CUtensorMap a_lo,
               const __grid_constant__ CUtensorMap b_hi,
               const __grid_constant__ CUtensorMap b_lo, const Args p) {
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled tiles want 1024-byte alignment
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  constexpr bool kRegA = reg_a(kMode);
  constexpr int kStages = stages(kMode), kStageBytes = stage_bytes(kMode);
  float* red = reinterpret_cast<float*>(smem + kStages * kStageBytes);
  const uint32_t tiles = smem_u32(smem);
  const uint32_t full = smem_u32(smem + kStages * kStageBytes + RED_BYTES);
  const uint32_t empty = full + 8 * kStages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nrt = p.Mp / TM, nct = (p.B + TN - 1) / TN;
  // the block's factor l, column tile ct and row tiles [rt_begin, rt_end)
  int l, ct, rt_begin;
  if constexpr (is_colsum(kMode)) {
    ct = blockIdx.x;
    l = blockIdx.y;
    rt_begin = 0;
  } else if constexpr (kMode == kDlu) {
    // pair q of factor l: row tile kt >= column tile mt, q = kt(kt+1)/2 + mt
    const int pairs = nrt * (nrt + 1) / 2;
    l = blockIdx.x / pairs;
    const int q = blockIdx.x % pairs;
    int kt = (int)((sqrtf(8.f * q + 1.f) - 1.f) * 0.5f);
    while (kt * (kt + 1) / 2 > q) --kt;
    while ((kt + 1) * (kt + 2) / 2 <= q) ++kt;
    rt_begin = kt;
    ct = q - kt * (kt + 1) / 2;
  } else if constexpr (is_trace(kMode) || kMode == kDluC) {
    // pair q of factor l: column tile ct >= row tile rt, q = ct(ct+1)/2 +
    // rt, so the longest k loop (small rt) comes first in each ct (kDluC:
    // row tile m, column tile k >= m, every pair the same loop over b)
    const int pairs = nrt * (nrt + 1) / 2;
    l = blockIdx.x / pairs;
    const int q = blockIdx.x % pairs;
    ct = (int)((sqrtf(8.f * q + 1.f) - 1.f) * 0.5f);
    while (ct * (ct + 1) / 2 > q) --ct;
    while ((ct + 1) * (ct + 2) / 2 <= q) ++ct;
    rt_begin = q - ct * (ct + 1) / 2;
  } else if constexpr (is_da(kMode)) {
    // factor slowest, then the column tile, the longest m loop first
    l = blockIdx.x / (nct * nrt);
    const int r = blockIdx.x % (nct * nrt);
    ct = r / nrt;
    rt_begin = nrt - 1 - r % nrt;
  } else if constexpr (kMode == kDaC) {
    // factor slowest, then the column (k) tile, the longest m loop first,
    // then the row (b) tiles: the blocks in flight share a few k tiles' rows
    // of Lu and read c's rows m below them, which they share too
    l = blockIdx.x / (nct * nrt);
    const int r = blockIdx.x % (nct * nrt);
    ct = nrt - 1 - r / nct;
    rt_begin = r % nct;
  } else if constexpr (kMode == kDc) {
    // factor slowest, then the column tile, the longest k loop (small m0)
    // first: the blocks in flight read one factor's LuT, whole (f32: 19 MB
    // at M = 3,010, which L2 holds), and each aT column strip once
    l = blockIdx.x / (nct * nrt);
    const int r = blockIdx.x % (nct * nrt);
    ct = r / nrt;
    rt_begin = r % nrt;
  } else {
    // kC: row tile slowest, the longest k loops (small m0) launch first
    rt_begin = blockIdx.x / (p.L * nct);
    const int r = blockIdx.x % (p.L * nct);
    l = r / nct;
    ct = r % nct;
  }
  const int rt_end = is_colsum(kMode) ? nrt : rt_begin + 1;
  auto k_begin = [](int rt) {
    if (kMode == kDaC) return 0;
    return (kMode == kDlu || kMode == kDluC || is_da(kMode)) ? 0 : rt * (TM / TK);
  };
  // kernel 7 (reading c): the m stages up to the end of the k tile's diagonal block
  auto k_end = [&](int rt) {
    if (kMode == kDaC) return (ct + 1) * (TM / TK);
    return is_da(kMode) ? (rt + 1) * (TM / TK) : p.nk;
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {  // producer: one thread issues every load
    if constexpr (kRegA)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(REG_A_PRODUCER_REGS));
    if (warp == CONSUMER_WARPS && lane == 0) {
      const int b_row = l * p.b_slab + ct * TN;
      int it = 0;
      for (int rt = rt_begin; rt < rt_end; ++rt) {
        const int a_row = l * p.a_slab + rt * TM;
        for (int kt = k_begin(rt); kt < k_end(rt); ++kt, ++it) {
          const int s = it % kStages, round = it / kStages;
          if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
          const uint32_t st = tiles + s * kStageBytes, bar = full + 8 * s;
          mbar_expect_tx(bar, kStageBytes + (kMode == kDluC ? TK * 4 : 0));
          // kDluC: the stage's 32 values of 2 g into its slot in red
          if constexpr (kMode == kDluC)
            bulk_load(smem_u32(red) + s * TK * 4, p.g + (int64_t)l * p.Bp + kt * TK, TK * 4, bar);
          if constexpr (kMode == kDaC) {
            // c's rows m of the stage in factor l's slab (rows m >= M are
            // past the slab: zeros), the block's 128 b as four boxes of 32
            // (the 128-byte swizzle's widest row)
            for (int j = 0; j < TM / C_BOX; ++j)
              tma_load_3d(st + j * (TILE_BYTES / (TM / C_BOX)), &a_hi, rt * TM + j * C_BOX,
                          kt * TK, l, bar);
            tma_load(st + TILE_BYTES, &b_hi, kt * TK, b_row, bar);
            tma_load(st + 2 * TILE_BYTES, &b_lo, kt * TK, b_row, bar);
          } else if constexpr (kRegA) {  // A in f32 through the map a_hi
            tma_load(st, &a_hi, kt * TK, a_row, bar);
            tma_load(st + TILE_BYTES, &b_hi, kt * TK, b_row, bar);
            tma_load(st + 2 * TILE_BYTES, &b_lo, kt * TK, b_row, bar);
          } else {
            tma_load(st, &a_hi, kt * TK, a_row, bar);
            tma_load(st + TILE_BYTES, &a_lo, kt * TK, a_row, bar);
            tma_load(st + 2 * TILE_BYTES, &b_hi, kt * TK, b_row, bar);
            tma_load(st + 3 * TILE_BYTES, &b_lo, kt * TK, b_row, bar);
          }
        }
      }
    }
    return;
  }

  if constexpr (kRegA)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(REG_A_CONSUMER_REGS));
  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the row tile.
  // The tensor cores sum one stage (12 products, k = 32) into acc; each
  // stage's acc is then added into tot by FADD, rounded to nearest. Summing
  // the whole k loop in acc lost ~2.5e-5 of max|c| at M = 3,000 (H100),
  // against ~5e-7 for the same products summed in float32.
  const int wg = warp / 4;
  float acc[64], tot[64];
  // kernel 1's running column sums: the slots red[warp][8 j + 2 lane + e]
  // of lanes 0-3, each owned by one thread
  if constexpr (is_colsum(kMode)) {
    if (lane < 4)
      for (int j = 0; j < 16; ++j)
        for (int e = 0; e < 2; ++e) red[warp * TN + 8 * j + 2 * lane + e] = 0.f;
  }
  // reg_a: this warp's A fragments, split, of the current stage and of the
  // next, loaded while the current stage's products run
  uint32_t cur_hi[TK / 8][4], cur_lo[TK / 8][4], nxt_hi[TK / 8][4], nxt_lo[TK / 8][4];
  // kDaC: a fragment's row is one b, the same in every stage: 2 g[l, b] of
  // this thread's rows r and r + 8 (scale_rows_kernel's product; 0 for b >= B)
  [[maybe_unused]] float g2_row[2];
  if constexpr (kMode == kDaC) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = rt_begin * TM + wg * 64 + (warp % 4) * 16 + lane / 4 + 8 * h;
      g2_row[h] = b < p.B ? 2.f * p.g[(int64_t)l * p.B + b] : 0.f;
    }
  }
  // stage i's A fragments of this warp, split; waits for the stage to land.
  // kDluC: the stage holds b in [32 kt, 32 kt + 32) of c's rows and, in its
  // slot in red, 2 g[l, b] (0 for b >= B); each value is scaled first as
  // scale_rows_kernel scales (2 g, then times c, rounded, never contracted
  // into the split's v - hi). kDaC: the stage holds c's rows m in [32 kt,
  // 32 kt + 32) for the block's 128 b, four boxes of 32 b (C_BOX) 4 KB
  // apart, each row m 128 bytes with 16-byte chunk q at q ^ (m % 8); the
  // fragment (row b, column m) is read transposed from (m, b), scaled the
  // same way by its row's 2 g. A warp's read (fixed kk, e) touches 4 rows m
  // (lane % 4) by 8 consecutive b (lane / 4): the b's two 16-byte chunks
  // (bit 0 of the chunk, bits 1-2 fixed by the warp), XORed with m % 8 (bits
  // 0-1 by lane % 4, bit 2 by e), give 4 chunks of 4 banks each, two lanes a
  // bank: a 2-way conflict. Rows m >= M are TMA's zero fill (c's map has a
  // slab a factor), so no Inf or NaN of the next factor's c meets Lu's zeros.
  auto load_a = [&](int i, uint32_t (&hi)[TK / 8][4], uint32_t (&lo)[TK / 8][4]) {
    const int s = i % kStages;
    mbar_wait(full + 8 * s, (i / kStages) & 1);
    [[maybe_unused]] float g2[TK / 8][2];
    if constexpr (kMode == kDluC) {
      const uint32_t g32 = smem_u32(red) + s * TK * 4;
#pragma unroll
      for (int kk = 0; kk < TK / 8; ++kk)
#pragma unroll
        for (int u = 0; u < 2; ++u) g2[kk][u] = lds_f32(g32 + (8 * kk + lane % 4 + 4 * u) * 4);
    }
    const uint32_t a32 = tiles + s * kStageBytes + wg * (TILE_BYTES / 2);
    const int r = (warp % 4) * 16 + lane / 4;
#pragma unroll
    for (int kk = 0; kk < TK / 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r + 8 * (e & 1), k = 8 * kk + lane % 4 + 4 * (e >> 1);
        float v;
        if constexpr (kMode == kDaC) {
          // row = b - 64 wg: box row / 32 of the warpgroup's two, b % 32 = row % 32
          const int bb = row & (C_BOX - 1);
          v = lds_f32(a32 + (row / C_BOX) * (TILE_BYTES / (TM / C_BOX)) + k * 128 +
                      (((bb >> 2) ^ (k & 7)) << 4) + (bb & 3) * 4);
          v = __fmul_rn(g2_row[e & 1], v);
        } else {
          v = lds_f32(a32 + row * 128 + (((k >> 2) ^ (row & 7)) << 4) + (k & 3) * 4);
          if constexpr (kMode == kDluC) v = __fmul_rn(g2[kk][e >> 1], v);
        }
        const float h = tf32_rna(v);
        hi[kk][e] = __float_as_uint(h);
        lo[kk][e] = __float_as_uint(tf32_rna(v - h));
      }
  };
  int it = 0;
  for (int rt = rt_begin; rt < rt_end; ++rt) {
#pragma unroll
    for (int i = 0; i < 64; ++i) tot[i] = 0.f;
    for (int kt = k_begin(rt); kt < k_end(rt); ++kt, ++it) {
      const int s = it % kStages;
      mbar_wait(full + 8 * s, (it / kStages) & 1);
      if constexpr (kRegA) {
        if (kt == k_begin(rt)) load_a(it, cur_hi, cur_lo);
        const uint32_t bh = tiles + s * kStageBytes + TILE_BYTES;
        const uint32_t bl = bh + TILE_BYTES;
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < TK / 8; ++kk) {
          const uint32_t off = kk * 32;  // 8 f32 of k
          if constexpr (kMode == kDluC || kMode == kDaC) {
            // kDlu's order with A and B swapped (A = dc, B = a): a_lo dc_hi,
            // a_hi dc_lo, then a_hi dc_hi, so each element sums the same
            // products in the same order (kDaC: kDa's, A = dc^T, B = Lu's
            // rows: Lu_lo dc_hi, Lu_hi dc_lo, Lu_hi dc_hi)
            if (kk == 0)
              wgmma_tf32_ra<0>(acc, cur_hi[kk], smem_desc(bl + off));
            else
              wgmma_tf32_ra<1>(acc, cur_hi[kk], smem_desc(bl + off));
            wgmma_tf32_ra<1>(acc, cur_lo[kk], smem_desc(bh + off));
          } else {
            if (kk == 0)
              wgmma_tf32_ra<0>(acc, cur_lo[kk], smem_desc(bh + off));
            else
              wgmma_tf32_ra<1>(acc, cur_lo[kk], smem_desc(bh + off));
            wgmma_tf32_ra<1>(acc, cur_hi[kk], smem_desc(bl + off));
          }
          wgmma_tf32_ra<1>(acc, cur_hi[kk], smem_desc(bh + off));
        }
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        if (kt + 1 < k_end(rt)) load_a(it + 1, nxt_hi, nxt_lo);
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < TK / 8; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            cur_hi[kk][e] = nxt_hi[kk][e];
            cur_lo[kk][e] = nxt_lo[kk][e];
          }
      } else {
        const uint32_t ah = tiles + s * kStageBytes + wg * (TILE_BYTES / 2);
        const uint32_t al = ah + TILE_BYTES;
        const uint32_t bh = tiles + s * kStageBytes + 2 * TILE_BYTES;
        const uint32_t bl = bh + TILE_BYTES;
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < TK / 8; ++kk) {
          const uint32_t off = kk * 32;  // 8 f32 of k
          // the small terms first, into the same f32 accumulator
          if (kk == 0)
            wgmma_tf32<0>(acc, smem_desc(al + off), smem_desc(bh + off));
          else
            wgmma_tf32<1>(acc, smem_desc(al + off), smem_desc(bh + off));
          wgmma_tf32<1>(acc, smem_desc(ah + off), smem_desc(bl + off));
          wgmma_tf32<1>(acc, smem_desc(ah + off), smem_desc(bh + off));
        }
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      }
      if (lane == 0) mbar_arrive(empty + 8 * s);
#pragma unroll
      for (int i = 0; i < 64; ++i) tot[i] += acc[i];
    }
    // fragment i of the m64n128 accumulator: row lane/4 (+8 for i%4 >= 2)
    // of the warp's 16, column 8 (i/4) + 2 (lane%4) + i%2
    const int row = rt * TM + wg * 64 + (warp % 4) * 16 + lane / 4;
    const int col = ct * TN + 2 * (lane % 4);  // + 8 j + e
    if constexpr (is_colsum(kMode)) {
      // rows m >= M are exact zeros (LuT's padding rows). Lanes with the
      // same lane%4 hold the same columns: sum the squares over them, then
      // into the owner's slot (sums kept in shared memory, not registers,
      // so the k loop keeps its registers)
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = fmaf(tot[4 * j + e], tot[4 * j + e],
                         tot[4 * j + 2 + e] * tot[4 * j + 2 + e]);
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (lane < 4) red[warp * TN + 8 * j + 2 * lane + e] += v;
        }
      if constexpr (kMode == kColsumC) {
        // c's tile straight from the fragments, while the producer loads
        // the next row tile's stages: the four lanes of a quad hold one
        // row's 8 consecutive columns of each j, one 32-byte sector. An
        // even B starts every row 8 bytes aligned, so a lane stores its two
        // columns as one float2 (b even, so b < B means b + 1 < B); an odd
        // B stores them one by one. Plain stores: streaming ones (st.cs)
        // cost registers and spilled (PERF.md).
        const bool pairs = (p.B & 1) == 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (row + 8 * h >= p.M) continue;
          float* c_row = p.c + ((int64_t)l * p.M + row + 8 * h) * p.B;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int b = col + 8 * j;
            const float v0 = tot[4 * j + 2 * h], v1 = tot[4 * j + 2 * h + 1];
            if (pairs) {
              if (b < p.B) *reinterpret_cast<float2*>(c_row + b) = make_float2(v0, v1);
            } else {
              if (b < p.B) c_row[b] = v0;
              if (b + 1 < p.B) c_row[b + 1] = v1;
            }
          }
        }
      }
    } else if constexpr (kMode == kDc) {
      // Through shared memory, whose ring is free once both warpgroups are
      // past their last stage: the fragments go into a 128 x 129 tile, the
      // 2 g[l, b] of the block's columns beside it, then dc's rows and
      // dcT's rows are each written by consecutive threads along their fast
      // axis. Stored straight from the fragments, each thread would need
      // 32 values of g beside its 64 of tot.
      const int t = threadIdx.x;
      float* tile = reinterpret_cast<float*>(smem);
      asm volatile("bar.sync 1, %0;" :: "n"(32 * CONSUMER_WARPS) : "memory");
      const int r0 = row - rt * TM, c0 = col - ct * TN;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            tile[(r0 + 8 * h) * (TN + 1) + c0 + 8 * j + e] = tot[4 * j + 2 * h + e];
      if (t < TN) {
        const int b = ct * TN + t;
        red[t] = b < p.B ? 2.f * p.g[(int64_t)l * p.B + b] : 0.f;
      }
      asm volatile("bar.sync 1, %0;" :: "n"(32 * CONSUMER_WARPS) : "memory");
      // dc (L, M, Bp): column t % 128, rows t / 128 + 2 i; 0 for b >= B
      {
        const int c = t % TN, b = ct * TN + c;
        const float g2 = red[c];
        const int64_t lo_dc = (int64_t)p.L * p.M * p.Bp;
        if (b < p.Bp)
          for (int r = t / TN; r < TM; r += 2) {
            const int m = rt * TM + r;
            if (m >= p.M) break;
            const float v = b < p.B ? g2 * tile[r * (TN + 1) + c] : 0.f;
            const float hi = tf32_rna(v);
            const int64_t i = ((int64_t)l * p.M + m) * p.Bp + b;
            p.dc[i] = hi;
            p.dc[lo_dc + i] = tf32_rna(v - hi);
          }
      }
      // dcT (L, B, Mp): row m = t % 128 of the tile, columns t / 128 + 2 i;
      // 0 for m >= M
      if (p.dct != nullptr) {
        const int r = t % TM, m = rt * TM + r;
        const int64_t lo_dct = (int64_t)p.L * p.B * p.Mp;
        for (int c = t / TM; c < TN; c += 2) {
          const int b = ct * TN + c;
          if (b >= p.B) break;
          const float v = m < p.M ? red[c] * tile[r * (TN + 1) + c] : 0.f;
          const float hi = tf32_rna(v);
          const int64_t i = ((int64_t)l * p.B + b) * p.Mp + m;
          p.dct[i] = hi;
          p.dct[lo_dct + i] = tf32_rna(v - hi);
        }
      }
    } else if constexpr (is_trace(kMode)) {
      const int t = threadIdx.x;
      double* sums = reinterpret_cast<double*>(red);
      // the block's flag: it is its factor's last (past the 256 sums below)
      volatile unsigned* last = reinterpret_cast<unsigned*>(red) + RED_BYTES / 4 - 1;
      if constexpr (kMode != kTraceBwd) {
        // the tile of P^T[j, i] times LuT[j, i], whose zeros mask i < j and
        // the padding: each thread's 64 in double, then the warp's 32 by
        // shuffles, then the eight warps' in a fixed order
        const float* lut = p.lut + ((int64_t)l * p.a_slab + row) * p.Mp + col;
        double s = 0.0;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              s += (double)tot[4 * j + 2 * h + e] * (double)lut[(int64_t)(8 * h) * p.Mp + 8 * j + e];
#pragma unroll
        for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
        if (lane == 0) sums[warp] = s;
      }
      // both warpgroups are past their last stage: the ring is idle
      asm volatile("bar.sync 1, %0;" :: "n"(32 * CONSUMER_WARPS) : "memory");
      if constexpr (kMode != kTraceBwd) {
        if (t == 0) {
          double b = 0.0;
          for (int w = 0; w < CONSUMER_WARPS; ++w) b += sums[w];
          p.partial[blockIdx.x] = b;
          // a ticket in the order the factor's blocks finish, which releases
          // the partial: the last block adds the factor's partials
          *last = ticket(p.tickets + l) == (unsigned)(nrt * (nrt + 1) / 2 - 1);
        }
      }
      if constexpr (kMode != kTrace) {
        // dLu = 2 g[l] P, P[l, i, j] = P^T[j, i], for i >= j, else 0: the
        // tile (rows j, columns i) through the idle ring, then the rows i
        // written by consecutive threads along j
        float* tile = reinterpret_cast<float*>(smem);
        const int r0 = row - rt * TM, c0 = col - ct * TN;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              tile[(r0 + 8 * h) * (TN + 1) + c0 + 8 * j + e] = tot[4 * j + 2 * h + e];
        asm volatile("bar.sync 1, %0;" :: "n"(32 * CONSUMER_WARPS) : "memory");
        const float g2 = p.g != nullptr ? 2.f * p.g[l] : 2.f;
        float* out = p.out + (int64_t)l * p.M * p.M;
        const int jl = t % TM, j = rt * TM + jl;
        for (int il = t / TM; il < TN; il += 2) {
          const int i = ct * TN + il;
          if (i >= p.M) break;
          const float v = tile[jl * (TN + 1) + il];
          if (j < p.M) out[(int64_t)i * p.M + j] = i >= j ? g2 * v : 0.f;
        }
        // off the diagonal, the mirror tile above it: rows i of tile rt,
        // columns j of tile ct
        const int j2 = ct * TN + jl;
        if (ct > rt && j2 < p.M)
          for (int il = t / TM; il < TM; il += 2) {
            const int i = rt * TM + il;
            if (i >= p.M) break;
            out[(int64_t)i * p.M + j2] = 0.f;
          }
      }
      if constexpr (kMode != kTraceBwd) {
        asm volatile("bar.sync 1, %0;" :: "n"(32 * CONSUMER_WARPS) : "memory");
        if (*last) {
          // factor l's partials in a fixed order: 256 strided sums, then a
          // tree; L2's copy (the ticket acquired every other block's write)
          static_assert(32 * CONSUMER_WARPS == 256, "256 strided sums");
          const int n = nrt * (nrt + 1) / 2;
          const double* part = p.partial + (int64_t)l * n;
          double v = 0.0;
          for (int q = t; q < n; q += 256) v += __ldcg(part + q);
          sums[t] = v;
          asm volatile("bar.sync 1, %0;" :: "n"(32 * CONSUMER_WARPS) : "memory");
          for (int w = 128; w > 0; w >>= 1) {
            if (t < w) sums[t] += sums[t + w];
            asm volatile("bar.sync 1, %0;" :: "n"(32 * CONSUMER_WARPS) : "memory");
          }
          if (t == 0) {
            p.trace[l] = (float)sums[0];
            p.tickets[l] = 0;  // every block of the factor has taken its ticket
          }
        }
      }
    } else if constexpr (kMode == kDlu) {
      // rows k, columns m of dLu (L, M, M): the sum where k >= m, else 0;
      // a tile below the diagonal (rt > ct) also zeroes its mirror above it
      const int mirror_row = ct * TM + (row - rt * TM), mirror_col = rt * TN + (col - ct * TN);
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = row + 8 * h, m = col + 8 * j + e;
            if (k < p.M && m < p.M)
              p.out[((int64_t)l * p.M + k) * p.M + m] = k >= m ? tot[4 * j + 2 * h + e] : 0.f;
            const int k2 = mirror_row + 8 * h, m2 = mirror_col + 8 * j + e;
            if (rt > ct && k2 < p.M && m2 < p.M) p.out[((int64_t)l * p.M + k2) * p.M + m2] = 0.f;
          }
    } else if constexpr (kMode == kDluC) {
      // rows m, columns k of the tile, stored transposed as dLu[l, k, m]:
      // the sum where k >= m, else 0 (the diagonal tile); a tile right of
      // the diagonal (ct > rt) also zeroes its mirror dLu[l, k', m'], k' in
      // tile rt, m' in tile ct. The lanes with one lane % 4 hold 8
      // consecutive m of one row k: each store of a warp is whole 32-byte
      // sectors. Rows m >= M (the next factor's c, or zeros) are not stored.
      const int mirror_k = rt * TM + (col - ct * TN), mirror_m = ct * TN + (row - rt * TM);
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int m = row + 8 * h, k = col + 8 * j + e;
            if (k < p.M && m < p.M)
              p.out[((int64_t)l * p.M + k) * p.M + m] = k >= m ? tot[4 * j + 2 * h + e] : 0.f;
            const int k2 = mirror_k + 8 * j + e, m2 = mirror_m + 8 * h;
            if (ct > rt && k2 < p.M && m2 < p.M) p.out[((int64_t)l * p.M + k2) * p.M + m2] = 0.f;
          }
    } else if constexpr (kMode == kDaC) {
      // rows b, columns k of the tile, stored transposed as da[l, k, b] for
      // k < M and b < B, through the idle ring as the dc epilogue's tile:
      // then each row k is written by consecutive threads along b (a warp's
      // store is 128 contiguous bytes), every element of da once. Stored
      // straight from the fragments, the 32 row offsets k B were computed
      // before the k loop and spilled (PERF.md).
      const int t = threadIdx.x;
      float* tile = reinterpret_cast<float*>(smem);
      asm volatile("bar.sync 1, %0;" :: "n"(32 * CONSUMER_WARPS) : "memory");
      const int r0 = row - rt * TM, c0 = col - ct * TN;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            tile[(r0 + 8 * h) * (TN + 1) + c0 + 8 * j + e] = tot[4 * j + 2 * h + e];
      asm volatile("bar.sync 1, %0;" :: "n"(32 * CONSUMER_WARPS) : "memory");
      const int bl = t % TM, b = rt * TM + bl;
      if (b < p.B) {
        float* da = p.out + ((int64_t)l * p.M + ct * TN) * p.B + b;
        for (int kl = t / TM; kl < TN && ct * TN + kl < p.M; kl += 2)
          da[(int64_t)kl * p.B] = tile[bl * (TN + 1) + kl];
      }
    } else {
      // kC and kernel 7: rows (m or k) < M, columns b < B of an (L, M, B) output
      const int64_t out_row = (int64_t)l * p.M + row;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int b = col + 8 * j + e;
          if (b < p.B) {
            if (row < p.M) p.out[out_row * p.B + b] = tot[4 * j + e];
            if (row + 8 < p.M) p.out[(out_row + 8) * p.B + b] = tot[4 * j + 2 + e];
          }
        }
    }
  }
  if constexpr (is_colsum(kMode)) {
    // the eight warps' sums, in a fixed order
    asm volatile("bar.sync 1, %0;" :: "n"(32 * CONSUMER_WARPS) : "memory");
    if (threadIdx.x < TN) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < CONSUMER_WARPS; ++w) s += red[w * TN + threadIdx.x];
      const int b = ct * TN + threadIdx.x;
      if (b < p.B) p.out[(int64_t)l * p.B + b] = s;
    }
  }
}

// Kernel 8 keeping P, tile t of the persistent grid's list: (l, rt, ct >=
// rt). order 0: the one-tile-a-block grid's (l slowest, then ct, then rt,
// the longest k loop first in each ct), whose tiles in flight share one
// factor's few K_s column panels (a per-factor K^-1). order 1: the longest
// k loop first over every factor (rt slowest, then l, then ct), whose tiles
// in flight read the shared K_s's panels together.
__device__ __forceinline__ void trace_tile(int t, int L, int nrt, int order, int& l, int& rt,
                                           int& ct) {
  if (order == 0) {
    const int pairs = nrt * (nrt + 1) / 2;
    l = t / pairs;
    int q = t % pairs;
    ct = 0;
    while (q > ct) q -= ++ct;
    rt = q;
    return;
  }
  int r = t;
  rt = 0;
  while (r >= L * (nrt - rt)) r -= L * (nrt - rt++);
  l = r / (nrt - rt);
  ct = rt + r % (nrt - rt);
}

// Kernel 8's forward keeping P: a persistent grid, min(SMs, tiles) blocks, whose producers take the tiles
// of trace_tile's list one at a time from a counter (tickets[L], set back
// to 0 by the last block out, tickets[L + 1] counting them). The main loop
// is kTrace's (operand B = K_s split, the same 12 products a stage into
// acc, FADD into tot in the same k order), with operand A read in place:
// Lu's rows k of the stage for the tile's 128 j, four TMA boxes of 32 j
// through a map with a slab a factor (rows k >= M are zeros, not the next
// factor's rows), each fragment (row j, column k) read transposed from
// (k, j) as kDaC reads c, Lu's entries above its diagonal (k < j, in the
// tile's first four stages) set to 0 as stage_lu_tile does, then split.
// The producer runs on into the next tile's stages while the consumers
// finish this one: P is stored straight from the fragments (the ring stays
// the next tile's), P[l, i, j] for j <= i only, nothing above the diagonal.
// A warp's store is four rows i of eight consecutive j: whole 32-byte
// sectors where M is a multiple of 8. The trace's partial of the tile is
// kTrace's sum, Lu[i, j] read in place for LuT's staged zeros, keyed by the
// tile's index in kTrace's grid (l pairs + ct (ct + 1) / 2 + rt), so the
// factor's last tile to finish adds the same partials in the same order:
// the same bits.
template <int kOrder>
__global__ void __launch_bounds__(threads(kTraceP), 1)
trace_p_kernel(const __grid_constant__ CUtensorMap lu_map,
               const __grid_constant__ CUtensorMap k_hi,
               const __grid_constant__ CUtensorMap k_lo, const Args p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  constexpr int kStages = stages(kTraceP), kStageBytes = stage_bytes(kTraceP);
  double* sums = reinterpret_cast<double*>(smem + kStages * kStageBytes);
  // the block's flag: its tile is its factor's last (past the 256 sums)
  volatile unsigned* last = reinterpret_cast<unsigned*>(sums) + RED_BYTES / 4 - 1;
  const uint32_t tiles = smem_u32(smem);
  const uint32_t full = smem_u32(smem + kStages * kStageBytes + RED_BYTES);
  const uint32_t empty = full + 8 * kStages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nrt = p.Mp / TM, pairs = nrt * (nrt + 1) / 2, count = p.L * pairs;
  // the tile whose first stage is in ring slot s (-1: no tile is left),
  // written by the producer before that stage's full barrier (an arrive,
  // which releases it), read by the consumers after their wait on it
  volatile int* tile_of = reinterpret_cast<int*>(sums + 256);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {  // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(REG_A_PRODUCER_REGS));
    if (warp == CONSUMER_WARPS && lane == 0) {
      // the tiles are handed out in trace_tile's order by a counter, one at
      // a time as a block's ring frees, as the hardware hands a grid's
      // blocks to its SMs: the tiles in flight stay neighbours in the list
      unsigned* next = p.tickets + p.L;
      int it = 0;
      for (;;) {
        const int t = (int)atomicAdd(next, 1u);
        int s = it % kStages, round = it / kStages;
        if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
        tile_of[s] = t < count ? t : -1;
        if (t >= count) {
          mbar_arrive(full + 8 * s);
          break;
        }
        int l, rt, ct;
        trace_tile(t, p.L, nrt, kOrder, l, rt, ct);
        const int b_row = l * p.b_slab + ct * TN;
        for (int kt = rt * (TM / TK); kt < p.nk; ++kt, ++it) {
          s = it % kStages, round = it / kStages;
          if (kt > rt * (TM / TK) && round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
          const uint32_t st = tiles + s * kStageBytes, bar = full + 8 * s;
          mbar_expect_tx(bar, kStageBytes);
          // Lu's rows k of the stage in factor l's slab, the tile's 128 j
          // as four boxes of 32
          for (int j = 0; j < TM / C_BOX; ++j)
            tma_load_3d(st + j * (TILE_BYTES / (TM / C_BOX)), &lu_map, rt * TM + j * C_BOX,
                        kt * TK, l, bar);
          tma_load(st + TILE_BYTES, &k_hi, kt * TK, b_row, bar);
          tma_load(st + 2 * TILE_BYTES, &k_lo, kt * TK, b_row, bar);
        }
      }
      // every block's last hand-out is past the list once each has taken a
      // ticket here: the last to take one sets both counters back to 0
      if (ticket(p.tickets + p.L + 1) == gridDim.x - 1) {
        *next = 0;
        p.tickets[p.L + 1] = 0;
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(REG_A_CONSUMER_REGS));
  // consumers: warpgroup wg owns rows j [64 wg, 64 wg + 64) of the tile
  const int wg = warp / 4, t_id = threadIdx.x;
  const int r = (warp % 4) * 16 + lane / 4;
  float acc[64], tot[64];
  uint32_t cur_hi[TK / 8][4], cur_lo[TK / 8][4], nxt_hi[TK / 8][4], nxt_lo[TK / 8][4];
  // stage i (k tile kt) of row tile rt, this warp's A fragments split;
  // waits for the stage to land. Fragment (row j, column k) sits at (k, j)
  // of box j / 32 (kDaC's read and its 2-way bank conflict).
  auto load_a = [&](int i, int kt, int rt, uint32_t (&hi)[TK / 8][4],
                    uint32_t (&lo)[TK / 8][4]) {
    const int s = i % kStages;
    mbar_wait(full + 8 * s, (i / kStages) & 1);
    const uint32_t a32 = tiles + s * kStageBytes + wg * (TILE_BYTES / 2);
    // the row tile's diagonal stages: k - j = kd + k - row
    const bool diag = kt < (rt + 1) * (TM / TK);
    const int kd = kt * TK - rt * TM - wg * 64;
#pragma unroll
    for (int kk = 0; kk < TK / 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r + 8 * (e & 1), k = 8 * kk + lane % 4 + 4 * (e >> 1);
        const int bb = row & (C_BOX - 1);
        float v = lds_f32(a32 + (row / C_BOX) * (TILE_BYTES / (TM / C_BOX)) + k * 128 +
                          (((bb >> 2) ^ (k & 7)) << 4) + (bb & 3) * 4);
        if (diag && kd + k < row) v = 0.f;  // above Lu's diagonal
        const float h = tf32_rna(v);
        hi[kk][e] = __float_as_uint(h);
        lo[kk][e] = __float_as_uint(tf32_rna(v - h));
      }
  };
  int it = 0;
  for (;;) {
    mbar_wait(full + 8 * (it % kStages), (it / kStages) & 1);
    const int t = tile_of[it % kStages];
    if (t < 0) break;
    int l, rt, ct;
    trace_tile(t, p.L, nrt, kOrder, l, rt, ct);
    const int kb = rt * (TM / TK);
#pragma unroll
    for (int i = 0; i < 64; ++i) tot[i] = 0.f;
    load_a(it, kb, rt, cur_hi, cur_lo);
    for (int kt = kb; kt < p.nk; ++kt, ++it) {
      const int s = it % kStages;
      const uint32_t bh = tiles + s * kStageBytes + TILE_BYTES;
      const uint32_t bl = bh + TILE_BYTES;
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < TK / 8; ++kk) {
        const uint32_t off = kk * 32;  // 8 f32 of k
        // kTrace's order: Lu_lo K_hi, Lu_hi K_lo, then Lu_hi K_hi
        if (kk == 0)
          wgmma_tf32_ra<0>(acc, cur_lo[kk], smem_desc(bh + off));
        else
          wgmma_tf32_ra<1>(acc, cur_lo[kk], smem_desc(bh + off));
        wgmma_tf32_ra<1>(acc, cur_hi[kk], smem_desc(bl + off));
        wgmma_tf32_ra<1>(acc, cur_hi[kk], smem_desc(bh + off));
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      if (kt + 1 < p.nk) load_a(it + 1, kt + 1, rt, nxt_hi, nxt_lo);
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < TK / 8; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          cur_hi[kk][e] = nxt_hi[kk][e];
          cur_lo[kk][e] = nxt_lo[kk][e];
        }
      if (lane == 0) mbar_arrive(empty + 8 * s);
#pragma unroll
      for (int i = 0; i < 64; ++i) tot[i] += acc[i];
    }
    // fragment 4 jj + 2 h + e of the m64n128 accumulator: P^T[j, i], row j =
    // row + 8 h, column i = col + 8 jj + e
    const int row = rt * TM + wg * 64 + r;
    const int col = ct * TN + 2 * (lane % 4);
    // the tile of P^T[j, i] times Lu[i, j] where j <= i < M, else 0 (LuT's
    // staged zeros): each thread's 64 in double, then the warp's 32 by
    // shuffles, then the eight warps' in a fixed order
    const float* lu_l = p.lu + (int64_t)l * p.M * p.M;
    double s = 0.0;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = col + 8 * jj + e, j = row + 8 * h;
          const float u = (i < p.M && j <= i) ? lu_l[(int64_t)i * p.M + j] : 0.f;
          s += (double)tot[4 * jj + 2 * h + e] * (double)u;
        }
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
    if (lane == 0) sums[warp] = s;
    // P[l, i, j] for j <= i < M, straight from the fragments
    float* out_l = p.out + (int64_t)l * p.M * p.M;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = col + 8 * jj + e, j = row + 8 * h;
          if (i < p.M && j <= i) out_l[(int64_t)i * p.M + j] = tot[4 * jj + 2 * h + e];
        }
    asm volatile("bar.sync 1, %0;" :: "n"(32 * CONSUMER_WARPS) : "memory");
    if (t_id == 0) {
      double b = 0.0;
      for (int w = 0; w < CONSUMER_WARPS; ++w) b += sums[w];
      p.partial[(int64_t)l * pairs + ct * (ct + 1) / 2 + rt] = b;
      // a ticket in the order the factor's tiles finish, which releases the
      // partial: the last tile's block adds the factor's partials
      *last = ticket(p.tickets + l) == (unsigned)(pairs - 1);
    }
    asm volatile("bar.sync 1, %0;" :: "n"(32 * CONSUMER_WARPS) : "memory");
    if (*last) {
      // factor l's partials in kTrace's order: 256 strided sums, then a
      // tree; L2's copy (the ticket acquired every other tile's write)
      static_assert(32 * CONSUMER_WARPS == 256, "256 strided sums");
      const double* part = p.partial + (int64_t)l * pairs;
      double v = 0.0;
      for (int q = t_id; q < pairs; q += 256) v += __ldcg(part + q);
      sums[t_id] = v;
      asm volatile("bar.sync 1, %0;" :: "n"(32 * CONSUMER_WARPS) : "memory");
      for (int w = 128; w > 0; w >>= 1) {
        if (t_id < w) sums[t_id] += sums[t_id + w];
        asm volatile("bar.sync 1, %0;" :: "n"(32 * CONSUMER_WARPS) : "memory");
      }
      if (t_id == 0) {
        p.trace[l] = (float)sums[0];
        p.tickets[l] = 0;  // every tile of the factor has taken its ticket
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, found through the runtime, so the
// library needs no link against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (rows, inner) row-major f32 tensor read in box_rows x 32-column boxes
// with the 128-byte swizzle; rows and columns past the end read as zeros.
// With slabs > 0, a (slabs, rows, inner) tensor, a box within one slab: rows
// past a slab's end read as zeros too.
int make_map(CUtensorMap* map, const float* base, uint64_t inner, uint64_t rows,
             uint32_t box_rows = TM, uint64_t slabs = 0) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return -1;
  const cuuint64_t dims[3] = {inner, rows, slabs};
  const cuuint64_t strides[2] = {inner * sizeof(float), inner * rows * sizeof(float)};
  const cuuint32_t box[3] = {TK, box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, slabs > 0 ? 3 : 2,
                         const_cast<float*>(base),
                         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -1000 - (int)r;
}

struct Scratch {
  int Mp, La;
  float *lu_hi, *lu_lo, *a_hi, *a_lo;
};

// scratch: LuT hi, LuT lo (L, Mp, Mp) each, then aT hi, aT lo (La, B, Mp)
// each, La = L for a per-factor a (a_stride != 0), else 1; kLuF32 (the dc
// epilogue): LuT whole (L, Mp, Mp), no lo part, then aT hi, aT lo.
template <bool kLuF32>
Scratch layout(float* scratch, int L, int M, int B, long long a_stride) {
  Scratch s;
  s.Mp = round_up(M, TM);
  s.La = a_stride != 0 ? L : 1;
  s.lu_hi = scratch;
  s.lu_lo = kLuF32 ? nullptr : s.lu_hi + (int64_t)L * s.Mp * s.Mp;
  s.a_hi = s.lu_hi + (kLuF32 ? 1 : 2) * (int64_t)L * s.Mp * s.Mp;
  s.a_lo = s.a_hi + (int64_t)s.La * B * s.Mp;
  return s;
}

template <bool kLuF32>
int stage(const float* lu, const float* a, const Scratch& s, int L, int M, int B,
          long long a_stride, cudaStream_t stream) {
  stage_lu_kernel<kLuF32><<<dim3(s.Mp / 32, s.Mp / 32, L), 256, 0, stream>>>(
      lu, s.lu_hi, s.lu_lo, M, s.Mp);
  stage_a_kernel<<<dim3(s.Mp / 32, (B + 31) / 32, s.La), 256, 0, stream>>>(
      a, s.a_hi, s.a_lo, M, B, s.Mp, a_stride);
  return (int)cudaGetLastError();
}

// A kernel's shared-memory size, set once a device (its first launch
// there; done holds a bit a device), not on every call.
int allow_smem(const void* kernel, int bytes, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const uint64_t bit = uint64_t(1) << (dev % 64);
  if (done.load() & bit) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return (int)err;
}

// The main loop's instance kMode.
template <int kMode>
int allow_smem() {
  static std::atomic<uint64_t> done{0};
  return allow_smem(reinterpret_cast<const void*>(tri_mma_kernel<kMode>), smem_bytes(kMode),
                    done);
}

// The main loop over operand A (a_rows rows of a_inner floats, hi and lo;
// reg_a: f32 through a_hi, a_lo unused) and B (b_rows rows of b_inner
// floats, hi and lo), on `grid` blocks.
template <int kMode>
int launch(const float* a_hi, const float* a_lo, uint64_t a_inner, uint64_t a_rows,
           const float* b_hi, const float* b_lo, uint64_t b_inner, uint64_t b_rows,
           const Args& p, dim3 grid, cudaStream_t stream) {
  CUtensorMap maps[4];
  int err;
  // kDaC: c (L, M, B) a slab a factor, in boxes of 32 rows m (by C_BOX = 32 b)
  const uint32_t a_box_rows = kMode == kDaC ? TK : TM;
  const uint64_t a_slabs = kMode == kDaC ? p.L : 0;
  if ((err = make_map(&maps[0], a_hi, a_inner, a_rows, a_box_rows, a_slabs)) != 0) return err;
  if ((err = make_map(&maps[1], a_lo, a_inner, a_rows, a_box_rows, a_slabs)) != 0) return err;
  if ((err = make_map(&maps[2], b_hi, b_inner, b_rows)) != 0) return err;
  if ((err = make_map(&maps[3], b_lo, b_inner, b_rows)) != 0) return err;
  if ((err = allow_smem<kMode>()) != 0) return err;
  tri_mma_kernel<kMode><<<grid, threads(kMode), smem_bytes(kMode), stream>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return (int)cudaGetLastError();
}

// The device's SM count, read once a device.
int sm_count(int* out) {
  static std::atomic<int> counts[64];  // zero: not read yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int n = counts[dev % 64].load();
  if (n == 0) {
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    counts[dev % 64].store(n);
  }
  *out = n;
  return 0;
}

// Kernel 8 keeping P on the persistent grid: Lu's rows (L slabs of lu_dim
// rows of lu_dim floats: Lu itself, M, or its rows staged, Mp; what lies
// past Lu reads as zeros) and K_s split (k_rows rows of Mp), on min(SMs,
// tiles) blocks.
int launch_trace_p(const float* lu_rows, int lu_dim, const float* k_hi, const float* k_lo,
                   uint64_t k_rows, const Args& p, cudaStream_t stream) {
  static std::atomic<uint64_t> smem_done[2];
  CUtensorMap maps[3];
  int err;
  if ((err = make_map(&maps[0], lu_rows, lu_dim, lu_dim, TK, p.L)) != 0) return err;
  if ((err = make_map(&maps[1], k_hi, p.Mp, k_rows)) != 0) return err;
  if ((err = make_map(&maps[2], k_lo, p.Mp, k_rows)) != 0) return err;
  // trace_tile's order 0 for a per-factor K^-1 (a K_s slab a factor), 1
  // for a shared one
  const int order = p.b_slab != 0 ? 0 : 1;
  const auto kernel = order == 0 ? trace_p_kernel<0> : trace_p_kernel<1>;
  if ((err = allow_smem(reinterpret_cast<const void*>(kernel), smem_bytes(kTraceP),
                        smem_done[order])) != 0)
    return err;
  int sms = 0;
  if ((err = sm_count(&sms)) != 0) return err;
  const int nrt = p.Mp / TM, count = p.L * (nrt * (nrt + 1) / 2);
  kernel<<<count < sms ? count : sms, threads(kTraceP), smem_bytes(kTraceP), stream>>>(
      maps[0], maps[1], maps[2], p);
  return (int)cudaGetLastError();
}

Args args(int L, int M, int B) {
  Args p{};
  p.L = L;
  p.M = M;
  p.B = B;
  p.Mp = round_up(M, TM);
  p.Bp = round_up(B, B_ALIGN);
  return p;
}

// Kernels 1 and 2 (either epilogue): the staging pass, then the main loop
// over LuT and aT.
template <int kMode>
int run(const float* lu, const float* a, Args p, long long a_stride, float* scratch,
        cudaStream_t stream) {
  constexpr bool kLuF32 = reg_a(kMode);
  const Scratch s = layout<kLuF32>(scratch, p.L, p.M, p.B, a_stride);
  const int err = stage<kLuF32>(lu, a, s, p.L, p.M, p.B, a_stride, stream);
  if (err != 0) return err;
  p.a_slab = s.Mp;
  p.b_slab = a_stride != 0 ? p.B : 0;
  p.nk = s.Mp / TK;
  const int nct = (p.B + TN - 1) / TN, nrt = s.Mp / TM;
  const dim3 grid = is_colsum(kMode) ? dim3(nct, p.L) : dim3(nrt * p.L * nct);
  // kLuF32: LuT's map twice (a_lo is not read)
  return launch<kMode>(s.lu_hi, kLuF32 ? s.lu_hi : s.lu_lo, s.Mp, (uint64_t)p.L * s.Mp, s.a_hi,
                       s.a_lo, s.Mp, (uint64_t)s.La * p.B, p, grid, stream);
}

// Kernel 8's staging, one launch: LuT whole (Llu, Mp, Mp) into lut, and K_s
// (or, with g, K_c = sum_l g[l] K_s[l] over Lk factors, one slab) split into
// hi and lo; the returned Args carry the slabs and the stage count.
int stage_trace(const float* k_inv, const float* g, const float* lu, float* lut, float* k_hi,
                float* k_lo, int M, int Lk, int Llu, Args* p, cudaStream_t st) {
  const int Mp = p->Mp;
  const dim3 grid(Mp / 32, Mp / 32, Llu + (g != nullptr ? 1 : Lk));
  if (g != nullptr)
    stage_trace_kernel<true><<<grid, 256, 0, st>>>(lu, lut, k_inv, g, k_hi, k_lo, M, Mp, Llu, Lk);
  else
    stage_trace_kernel<false><<<grid, 256, 0, st>>>(lu, lut, k_inv, nullptr, k_hi, k_lo, M, Mp,
                                                    Llu, Lk);
  p->a_slab = Llu > 1 ? Mp : 0;
  p->b_slab = (g == nullptr && Lk > 1) ? Mp : 0;
  p->nk = Mp / TK;
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry point returns 0, a CUDA error code, -1 when libcuda has no
// cuTensorMapEncodeTiled, or -1000 - CUresult when it refuses a map.
// `scratch` holds 2 L Mp^2 + 2 La B Mp floats (see `layout`) for kernels 1
// and 2, L Mp^2 + 2 La B Mp for the dc epilogue, La M Bp for kernel 6 where
// B is not a multiple of 4 (else none), L Mp^2 for kernel 7 (2 L Mp^2 where
// its grid, L ceil(B / 128) Mp / 128 blocks, is no more than the SMs); kernel
// 7 reading c: see tri_da_from_c_f32.

extern "C" int tri_stage_f32(const float* lu, const float* a, float* scratch, int L, int M,
                             int B, long long a_stride, void* stream) {
  return stage<false>(lu, a, layout<false>(scratch, L, M, B, a_stride), L, M, B, a_stride,
                      (cudaStream_t)stream);
}

extern "C" int tri_t_matmul_f32(const float* lu, const float* a, float* c, int L, int M, int B,
                                long long a_stride, float* scratch, void* stream) {
  Args p = args(L, M, B);
  p.out = c;
  return run<kC>(lu, a, p, a_stride, scratch, (cudaStream_t)stream);
}

// Kernel 1 into out (L, B); unless c is null, c = Lu^T a (L, M, B) too, for
// the backward (tri_split_f32 with g scales it into dc).
extern "C" int tri_sq_colsum_c_f32(const float* lu, const float* a, float* out, float* c,
                                   int L, int M, int B, long long a_stride, float* scratch,
                                   void* stream) {
  Args p = args(L, M, B);
  p.out = out;
  p.c = c;
  if (c != nullptr) return run<kColsumC>(lu, a, p, a_stride, scratch, (cudaStream_t)stream);
  return run<kColsum>(lu, a, p, a_stride, scratch, (cudaStream_t)stream);
}

// dc = 2 g c into dc (2, L, M, Bp), and dcT into dct (2, L, B, Mp) unless
// dct is null: see the header for the layout.
extern "C" int tri_dc_f32(const float* lu, const float* a, const float* g, float* dc,
                          float* dct, int L, int M, int B, long long a_stride, float* scratch,
                          void* stream) {
  Args p = args(L, M, B);
  p.g = g;
  p.dc = dc;
  p.dct = dct;
  return run<kDc>(lu, a, p, a_stride, scratch, (cudaStream_t)stream);
}

// dLu (L, M, M) from a and dc (2, L, M, Bp) as tri_dc_f32 wrote it. a's rows
// are read in place where B is a multiple of 4 floats (a 16-byte row stride,
// which TMA needs; the k loop's reads past B come back as zeros), else from
// a copy with the row stride Bp in scratch (La M Bp floats).
extern "C" int tri_dlu_f32(const float* a, const float* dc, float* dlu, int L, int M, int B,
                           long long a_stride, float* scratch, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  Args p = args(L, M, B);
  const int La = a_stride != 0 ? L : 1;
  const float* a_rows = a;
  uint64_t a_inner = B;
  if (B % 4 != 0) {
    stage_a_rows_kernel<<<dim3((p.Bp + 255) / 256, M, La), 256, 0, st>>>(a, scratch, M, B,
                                                                        p.Bp, a_stride);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    a_rows = scratch;
    a_inner = p.Bp;
  }
  p.out = dlu;
  p.a_slab = a_stride != 0 ? M : 0;
  p.b_slab = M;
  p.nk = p.Bp / TK;
  const int nrt = p.Mp / TM;
  return launch<kDlu>(a_rows, a_rows, a_inner, (uint64_t)La * M, dc,
                      dc + (int64_t)L * M * p.Bp, p.Bp, (uint64_t)L * M, p,
                      dim3(L * (nrt * (nrt + 1) / 2)), st);
}

// da (L, M, B) of a per-factor a, from Lu and dcT (2, L, B, Mp) as
// tri_dc_f32 wrote it.
extern "C" int tri_da_f32(const float* lu, const float* dct, float* da, int L, int M, int B,
                          float* scratch, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  Args p = args(L, M, B);
  p.out = da;
  p.a_slab = p.Mp;
  p.b_slab = B;
  p.nk = p.Mp / TK;
  const int nct = (B + TN - 1) / TN, nrt = p.Mp / TM;
  const dim3 grid(L * nct * nrt), rows_grid((p.Mp + 255) / 256, p.Mp, L);
  const float* dct_lo = dct + (int64_t)L * B * p.Mp;
  int sms = 0;
  int err = sm_count(&sms);
  if (err != 0) return err;
  if ((int)grid.x <= sms) {  // one wave: Lu's rows split, kernels 1-2's loop
    float* lo = scratch + (int64_t)L * p.Mp * p.Mp;
    stage_lu_rows_kernel<false><<<rows_grid, 256, 0, st>>>(lu, scratch, lo, M, p.Mp);
    if ((err = (int)cudaGetLastError()) != 0) return err;
    return launch<kDaSplit>(scratch, lo, p.Mp, (uint64_t)L * p.Mp, dct, dct_lo, p.Mp,
                            (uint64_t)L * B, p, grid, st);
  }
  stage_lu_rows_kernel<true><<<rows_grid, 256, 0, st>>>(lu, scratch, nullptr, M, p.Mp);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  // Lu's rows in f32: their map twice (a_lo is not read)
  return launch<kDa>(scratch, scratch, p.Mp, (uint64_t)L * p.Mp, dct, dct_lo, p.Mp,
                     (uint64_t)L * B, p, grid, st);
}

// x (L, M, B) into rows (2, L, M, Bp) and, unless rows_t is null, rows_t
// (2, L, B, Mp): the layout tri_dlu_f32 and tri_da_f32 read dc in. Unless g
// is null, x is kernel 1's c and g (L, B) the colsum's cotangent: what is
// split is dc = (2 g) c, the scale pass, into rows only.
extern "C" int tri_split_f32(const float* x, const float* g, float* rows, float* rows_t, int L,
                             int M, int B, void* stream) {
  const Args p = args(L, M, B);
  if (g != nullptr) {  // the scale pass
    if (rows_t != nullptr) return (int)cudaErrorInvalidValue;  // dcT: kernel 7 reads c
    const int parts = (p.Bp / 4 + SCALE_PART - 1) / SCALE_PART;  // blocks a row
    const unsigned blocks = (unsigned)((int64_t)L * M * parts);
    const cudaStream_t st = (cudaStream_t)stream;
    if (B % 4 == 0 && ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g)) & 15) == 0)
      scale_rows_kernel<true><<<blocks, SCALE_THREADS, 0, st>>>(x, g, rows, L, M, B, p.Bp, parts);
    else
      scale_rows_kernel<false><<<blocks, SCALE_THREADS, 0, st>>>(x, g, rows, L, M, B, p.Bp, parts);
    return (int)cudaGetLastError();
  }
  const int m_tiles = (rows_t != nullptr ? p.Mp : round_up(M, 32)) / 32;
  const dim3 grid(p.Bp / 32, m_tiles, L);
  const cudaStream_t st = (cudaStream_t)stream;
  split_kernel<<<grid, 256, 0, st>>>(x, rows, rows_t, L, M, B, p.Mp, p.Bp);
  return (int)cudaGetLastError();
}

// Kernel 6 reading c: dLu (L, M, M), every element written, from a shared a
// (M, B), kernel 1's kept c (L, M, B) and the colsum's cotangent g (L, B),
// dc = 2 g c formed in the A loads (kDluC). a is split into TF32 hi and lo
// rows of stride Bp first (tri_split_f32's pass, in this entry) and 2 g laid
// out in rows of Bp (double_g_kernel); c's rows are read in place where B is
// a multiple of 4 floats, else from a copy with the row stride Bp. scratch
// holds (2 M + L) Bp floats, and L M Bp more where B is not a multiple of 4.
extern "C" int tri_dlu_from_c_f32(const float* a, const float* c, const float* g, float* dlu,
                                  int L, int M, int B, float* scratch, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  Args p = args(L, M, B);
  float* a_rows = scratch;  // hi (M, Bp), then lo
  float* g2 = a_rows + 2 * (int64_t)M * p.Bp;
  int err = tri_split_f32(a, nullptr, a_rows, nullptr, 1, M, B, stream);
  if (err != 0) return err;
  double_g_kernel<<<(unsigned)(((int64_t)L * p.Bp + 255) / 256), 256, 0, st>>>(g, g2, L, B, p.Bp);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  const float* c_rows = c;
  uint64_t c_inner = B;
  if (B % 4 != 0) {
    float* copy = g2 + (int64_t)L * p.Bp;
    stage_a_rows_kernel<<<dim3((p.Bp + 255) / 256, M, L), 256, 0, st>>>(c, copy, M, B, p.Bp,
                                                                       (int64_t)M * B);
    if ((err = (int)cudaGetLastError()) != 0) return err;
    c_rows = copy;
    c_inner = p.Bp;
  }
  p.out = dlu;
  p.g = g2;
  p.a_slab = M;
  p.b_slab = 0;
  p.nk = p.Bp / TK;
  const int nrt = p.Mp / TM;
  // c's map twice (a_lo is not read); a's hi and lo rows, (M, Bp) each
  return launch<kDluC>(c_rows, c_rows, c_inner, (uint64_t)L * M, a_rows,
                       a_rows + (int64_t)M * p.Bp, p.Bp, (uint64_t)M, p,
                       dim3(L * (nrt * (nrt + 1) / 2)), st);
}

// Kernel 7 reading c: da (L, M, B), every element written, da[l, k, b] =
// sum_{m <= k} Lu[l, k, m] dc[l, m, b] for a per-factor a, from Lu, kernel
// 1's kept c (L, M, B) and the colsum's cotangent g (L, B), dc = 2 g c formed
// in the A loads (kDaC); a shared a's da is the sum over l (the wrapper's).
// Lu's rows are staged split into hi and lo (stage_lu_rows_kernel<false>, in
// this entry); c is read in place where B is a multiple of 4 floats, else
// from a copy with the row stride Bp. scratch holds 2 L Mp^2 floats, and L M
// Bp more where B is not a multiple of 4.
extern "C" int tri_da_from_c_f32(const float* lu, const float* c, const float* g, float* da,
                                 int L, int M, int B, float* scratch, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  Args p = args(L, M, B);
  p.out = da;
  p.g = g;
  p.b_slab = p.Mp;
  float* lu_lo = scratch + (int64_t)L * p.Mp * p.Mp;
  stage_lu_rows_kernel<false><<<dim3((p.Mp + 255) / 256, p.Mp, L), 256, 0, st>>>(
      lu, scratch, lu_lo, M, p.Mp);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const float* c_rows = c;
  uint64_t c_inner = B;
  if (B % 4 != 0) {
    float* copy = lu_lo + (int64_t)L * p.Mp * p.Mp;
    stage_a_rows_kernel<<<dim3((p.Bp + 255) / 256, M, L), 256, 0, st>>>(c, copy, M, B, p.Bp,
                                                                       (int64_t)M * B);
    if ((err = (int)cudaGetLastError()) != 0) return err;
    c_rows = copy;
    c_inner = p.Bp;
  }
  const int nct = (B + TN - 1) / TN, nrt = p.Mp / TM;
  // c's map twice (a_lo is not read), M rows a slab; Lu's hi and lo rows,
  // (L Mp, Mp) each
  return launch<kDaC>(c_rows, c_rows, c_inner, (uint64_t)M, scratch, lu_lo, p.Mp,
                      (uint64_t)L * p.Mp, p, dim3(L * nct * nrt), st);
}

// Kernel 8, the trace: out (L,) from K^-1 (Lk, M, M) and Lu (Llu, M, M),
// Lk and Llu each 1 or L; tickets L + 2 zeros, left at zero. With p null, the
// trace alone (kTrace): scratch holds Llu Mp^2 + 2 Lk Mp^2 floats (LuT
// whole, K_s hi and lo), then L nrt (nrt + 1) / 2 doubles of block partials
// (nrt = Mp / 128). Else (Llu = L) P = tril(K_s Lu) into p (L, M, M) too,
// below and on the diagonal only (the persistent grid, trace_p_kernel, Lu
// read in place): scratch holds 2 Lk Mp^2 floats (K_s hi and lo), then,
// where Lu's rows cannot be read in place (M not a multiple of 4 floats, or
// lu not 16-byte aligned: TMA wants 16-byte strides and addresses), L Mp^2
// floats of Lu's rows staged with the row stride Mp, then the partials.
extern "C" int tri_kl_trace_f32(const float* k_inv, const float* lu, float* out, float* p_out,
                                unsigned* tickets, int L, int M, int Lk, int Llu,
                                float* scratch, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (p_out != nullptr && Llu != L) return (int)cudaErrorInvalidValue;
  Args p = args(L, M, M);
  const int64_t mp2 = (int64_t)p.Mp * p.Mp;
  p.out = p_out;
  p.trace = out;
  p.tickets = tickets;
  if (p_out != nullptr) {
    float *k_hi = scratch, *k_lo = k_hi + Lk * mp2, *rows = k_lo + Lk * mp2;
    int err = stage_trace(k_inv, nullptr, lu, nullptr, k_hi, k_lo, M, Lk, 0, &p, st);
    if (err != 0) return err;
    const bool copy = M % 4 != 0 || (reinterpret_cast<uintptr_t>(lu) & 15) != 0;
    const float* lu_rows = lu;
    int lu_dim = M;
    if (copy) {  // Lu's rows in f32 with the row stride Mp: only what is read
      trace_lu_rows_kernel<<<dim3(p.Mp, L), 256, 0, st>>>(lu, rows, M, p.Mp);
      if ((err = (int)cudaGetLastError()) != 0) return err;
      lu_rows = rows;
      lu_dim = p.Mp;
    }
    p.lu = lu;
    p.partial = reinterpret_cast<double*>(rows + (copy ? L * mp2 : 0));
    return launch_trace_p(lu_rows, lu_dim, k_hi, k_lo, (uint64_t)Lk * p.Mp, p, st);
  }
  float *lut = scratch, *k_hi = lut + Llu * mp2, *k_lo = k_hi + Lk * mp2;
  int err = stage_trace(k_inv, nullptr, lu, lut, k_hi, k_lo, M, Lk, Llu, &p, st);
  if (err != 0) return err;
  p.lut = lut;
  p.partial = reinterpret_cast<double*>(k_lo + Lk * mp2);
  const int nrt = p.Mp / TM;
  return launch<kTrace>(lut, lut, p.Mp, (uint64_t)Llu * p.Mp, k_hi, k_lo, p.Mp,
                        (uint64_t)Lk * p.Mp, p, dim3(L * (nrt * (nrt + 1) / 2)), st);
}

// Kernel 8's backward from the P that tri_kl_trace_f32 kept (L, M, M), into
// dlu (L, M, M), every element written; p and dlu 16-byte aligned.
extern "C" int tri_kl_trace_scale_f32(const float* p, const float* g, float* dlu, int L, int M,
                                      void* stream) {
  if ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(dlu)) & 15)
    return (int)cudaErrorMisalignedAddress;
  const int64_t rows = (int64_t)L * M;
  trace_scale_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, (cudaStream_t)stream>>>(p, g, dlu, L,
                                                                                 M);
  return (int)cudaGetLastError();
}

// Kernel 8's backward with P recomputed: dLu from K^-1, Lu and g (L,) as
// above, every element written. A per-factor Lu (Llu = L) gets dLu (L, M, M); a shared Lu under a
// per-factor K^-1 (Llu = 1 < Lk = L) gets its one dLu (1, M, M) from K_c.
// scratch holds Llu Mp^2 + 2 Ls Mp^2 floats, Ls = 1 for the shared Lu,
// else Lk.
extern "C" int tri_kl_trace_bwd_f32(const float* k_inv, const float* lu, const float* g,
                                    float* dlu, int L, int M, int Lk, int Llu, float* scratch,
                                    void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const bool combine = Llu == 1 && L > 1;
  const int Ls = combine ? 1 : Lk, Lo = combine ? 1 : L;
  Args p = args(Lo, M, M);
  const int64_t mp2 = (int64_t)p.Mp * p.Mp;
  float *lut = scratch, *k_hi = lut + Llu * mp2, *k_lo = k_hi + Ls * mp2;
  const int err = stage_trace(k_inv, combine ? g : nullptr, lu, lut, k_hi, k_lo, M, Lk, Llu,
                              &p, st);
  if (err != 0) return err;
  p.out = dlu;
  p.g = combine ? nullptr : g;
  const int nrt = p.Mp / TM;
  return launch<kTraceBwd>(lut, lut, p.Mp, (uint64_t)Llu * p.Mp, k_hi, k_lo, p.Mp,
                           (uint64_t)Ls * p.Mp, p, dim3(Lo * (nrt * (nrt + 1) / 2)), st);
}
