// L-batched RBF Gram from raw coordinates, f32.
//
// Replaces gpzoo_tpu/ops/gram_pallas.py: rbf_gram (_rbf_gram_fwd_impl)
//   out[l, n, m] = sigma[l]^2 * exp(-1/2 ||x_n - z_m||^2 / lengthscale[l]^2)
//               = sigma2[l] * 2^(scale2[l] * ||x_n - z_m||^2),
//   sigma2[l] = sigma[l]^2, scale2[l] = -1/2 log2(e) / lengthscale[l]^2;
//   x (N, D), z (M, D), D <= 8, any L.
//
// What bounds it on an H100: the write of the (L, N, M) result. At the
// north-star Kzx (1 x 3,000 x 45,000) that is 540 MB, at the VNNGP
// posterior's Kxz (10 x 100,000 x 1,000) 4 GB, against a few hundred KB of
// coordinates and ~D+2 FLOP plus one exponential per element: the kernel
// is limited by device-memory bandwidth (3.35 TB/s: 0.16 ms and 1.19 ms).
//
// What the design does about it: each output element is written exactly
// once, with 16-byte streaming stores, and nothing else goes to device
// memory. The entry point rbf_gram_f32 owns the tile plan and the shape
// limits; the wrapper passes only the shapes.
//  * The output is cut into tiles of `rows` rows by one strip of
//    256 * VEC columns, one block per tile, in row order: blocks start in
//    order, so the rows being written at any moment stay a narrow band.
//    The plan takes rows * L ~ 8 row-planes a block (8 rows at L = 1, 1 row
//    from L = 8 on, so the posterior's L = 10 too), and fewer rows where a
//    small output would leave fewer than 8 blocks per SM (the SM count is
//    read from the device). (A persistent grid, blocks striding over the
//    tiles, was slower on an H100: its blocks drift apart and write across
//    ~1,000 tiles x L planes at once.)
//  * Each thread owns VEC = 4 neighbouring columns of its strip. D is a
//    template parameter: the thread's 4 x D coordinates of z stay in
//    registers across its tile, the row's x coordinates are warp-uniform
//    loads, and d^2 is formed directly (no N x M distance matrix as in the
//    expanded ||x||^2 - 2 x.z + ||z||^2 form).
//  * Factor by factor, each thread forms sigma2[l] and scale2[l] in
//    registers from sigma[l] and lengthscale[l] (read-only cache loads), so
//    a call is one launch and takes any L, then writes that factor's rows of
//    its tile, forming d^2 again per factor (D FMAs a row). The exponential
//    is one ex2.approx, with log2(e) folded into scale2.
//  * Each row of 4 results goes out as one st.global.cs.v4 (cache-streaming:
//    the result is far larger than the 50 MB L2). Output offsets are 64-bit.
//  * A row of M floats is 16-byte aligned only if M % 4 == 0. For other M
//    the same kernel runs with VEC = 1 and 4-byte streaming stores.
// The direct distance differs from the plain expanded form only by
// rounding near d = 0.
// Registers (nvcc -Xptxas -v, sm_90a; chip_smoke.py prints them): 32 for
// the paths' instance (D = 2, VEC = 4), 58 at D = 8; no instance spills.
//
// The backward (rbf_gram_bwd_f32) replaces gram_pallas.py _rbf_gram_bwd.
// For the cotangent g (L, N, M) and the forward's k (JAX's residual), with
// gk = g k and d2 = ||x_n - z_m||^2:
//   dsigma[l] = 2 sum_nm gk / sigma[l],  dell[l] = sum_nm gk d2 / ell[l]^3,
//   w[n, m] = sum_l gk / ell[l]^2,
//   dx[n] = sum_m w[n, m] (z_m - x_n),  dz[m] = sum_n w[n, m] (x_n - z_m).
// What bounds it on an H100: reading g and k, 8 L N M bytes (400 MB at the
// VNNGP sweep's Kxz, 10 x 5,000 x 1,000: 0.119 ms at 3.35 TB/s), against
// ~4 FLOP an element and ~7 D a pair; no (L, N, M) or (N, M) tensor needs
// to be written. At the paths' small shapes (a few hundred KB) the fixed
// cost of a call sets the time: launches, and dependent trips to memory.
// What the design does about it:
//  * The partials are those of the first design, so that the sums keep
//    their bits. Each of 256 threads owns BWD_ROWS = 4 rows by VEC
//    neighbouring columns (VEC 4, 2 or 1 as M allows 16-, 8- or 4-byte
//    loads) of a strip of BWD_TX * VEC columns; BWD_TY = 4 thread-rows make
//    a row group of 16 rows; an item is `chunks` row groups of one strip
//    (a tile), items in tile-major order. w stays in registers across the
//    factors; the per-factor sums of gk and gk d2 are reduced over each
//    warp by shuffles and over the block in shared memory, one partial a
//    row group and factor; dx's sums over the strip go out once a row
//    group, dz's once an item. `chunks` is planned for 4 blocks an SM, as
//    the first design planned it: it fixes dz's partials, hence its bits.
//  * One launch a call, on a persistent grid of whole waves: as many
//    blocks as fit on the card (the occupancy of the instance, read from
//    the device), each taking items blockIdx.x, + gridDim.x, ... .
//  * g and k go through a ring of STAGES = 2 (row group, factor) steps in
//    shared memory, filled by cp.async: each thread copies its own 4 rows
//    and reads back only what it copied (no barrier for the ring), and the
//    copies run a step ahead, across factors, row groups and items (three
//    or four steps were no faster on an H100). The ring replaces the first design's registers, which were
//    spent on loads that were waited for before the next factor's went out.
//  * The fixed-order sums follow in the same launch, with no float atomics.
//    When a block has done its items it takes a ticket (an acq_rel atomic
//    add on a counter, after a barrier: its partials are released). The
//    last `helpers` blocks to take one wait for the count to reach the grid
//    and then share the first design's reduction, in its order (dx and dz:
//    eight interleaved slices of the partials, then the slices in order,
//    four outputs a thread; dsigma and dell: 256 interleaved slices, then a
//    pairwise tree), each in double, so two runs give the same bits, and
//    the same bits as that design's second kernel gave. Fewer blocks wait
//    than there are SMs, so a block still to start always finds a slot;
//    the last helper past its wait sets the counters back to 0, so a CUDA
//    graph replays.
//  * The row group's block-wide sums of dx and of the factors' partials
//    share one barrier (their shared buffers alternate between row groups).
// Registers and resident blocks: chip_smoke.py prints ptxas's registers;
// tools/kernel_anatomy.py and tools/gram_vnngp_bwd_ab.py the occupancy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAXD = 8;        // coordinate widths the kernel is instantiated for
constexpr int ROW_PLANES = 8;  // rows x factors a block writes of its strip
constexpr int BLOCKS_PER_SM = 8;
constexpr int INT_MAX_ = 2147483647;
constexpr float NEG_HALF_LOG2E = -0.72134752044448170f;  // -1/2 log2(e)

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

template <int D, int VEC>
__global__ void __launch_bounds__(THREADS)
rbf_gram_kernel(const float* __restrict__ x, const float* __restrict__ z,
                const float* __restrict__ sigma, const float* __restrict__ lengthscale,
                float* __restrict__ out, int N, int M, int L, int rows, int n_strips) {
  const int strip = blockIdx.x % n_strips;
  const int n0 = blockIdx.x / n_strips * rows;
  const int m = (strip * THREADS + (int)threadIdx.x) * VEC;
  if (m >= M) return;  // VEC = 4 implies M % 4 == 0: all 4 columns exist
  float zr[VEC][D];
#pragma unroll
  for (int v = 0; v < VEC; ++v)
#pragma unroll
    for (int d = 0; d < D; ++d) zr[v][d] = __ldg(z + (int64_t)(m + v) * D + d);
  const int64_t plane = (int64_t)N * M;
  const int n1 = N - n0 < rows ? N : n0 + rows;
  float* first = out + (int64_t)n0 * M + m;
  for (int l = 0; l < L; ++l, first += plane) {
    const float sg = __ldg(sigma + l), ell = __ldg(lengthscale + l);
    const float s2 = sg * sg, sc = NEG_HALF_LOG2E / (ell * ell);
    float* row = first;
    for (int n = n0; n < n1; ++n, row += M) {
      float xr[D];
#pragma unroll
      for (int d = 0; d < D; ++d) xr[d] = __ldg(x + (int64_t)n * D + d);
      float d2[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        d2[v] = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const float diff = xr[d] - zr[v][d];
          d2[v] = fmaf(diff, diff, d2[v]);
        }
      }
      if constexpr (VEC == 4) {
        __stcs(reinterpret_cast<float4*>(row),
               make_float4(s2 * ex2(d2[0] * sc), s2 * ex2(d2[1] * sc),
                           s2 * ex2(d2[2] * sc), s2 * ex2(d2[3] * sc)));
      } else {
        __stcs(row, s2 * ex2(d2[0] * sc));
      }
    }
  }
}

constexpr int BWD_TX = 64;                    // threads across a strip
constexpr int BWD_TY = THREADS / BWD_TX;      // thread-rows of a block
constexpr int BWD_ROWS = 4;                   // rows a thread owns in a row group
constexpr int GROUP_ROWS = BWD_TY * BWD_ROWS;  // rows of a row group
constexpr int WARPS = THREADS / 32;
constexpr int ROW_WARPS = BWD_TX / 32;        // warps of a thread-row
constexpr int LC = 32;                        // factors of per-warp sums in shared memory
constexpr int PLAN_BLOCKS_PER_SM = 4;         // the partials' plan: sets chunks
constexpr int SLICES = 8;                     // interleaved slices of the final sums
constexpr int AHEAD = 8;                      // slabs a thread loads at once in a sum
constexpr int OUTS = 4;                       // outputs a thread sums in a unit
constexpr int STAGES = 2;                     // (row group, factor) steps in the ring
// counters: the blocks that finished their items, the helpers that finished
// the sums
constexpr int DONE = 0, EXITED = 1, COUNTERS = 2;

template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  else if constexpr (VEC == 2)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

template <int VEC>
__device__ __forceinline__ void load_smem(float (&dst)[VEC], const float* src) {
  if constexpr (VEC == 4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x, dst[1] = v.y, dst[2] = v.z, dst[3] = v.w;
  } else if constexpr (VEC == 2) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    dst[0] = v.x, dst[1] = v.y;
  } else {
    dst[0] = *src;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The backward's shape and plan, as the kernel and its entry share them.
struct BwdArgs {
  int N, M, L, strips, chunks, tiles, items;
  int64_t n_parts;
};

// Where a block's copies stand: the (item, row group, factor) step they
// fill next, with the rows and columns it touches.
struct Cursor {
  int item, c, l, n0, m0;
  bool col_live;
  __device__ void start(int it, const BwdArgs& a, int vec) {
    item = it, c = 0, l = 0;
    rows(a, vec);
  }
  __device__ void rows(const BwdArgs& a, int vec) {
    const int strip = item % a.strips, tile = item / a.strips;
    m0 = (strip * BWD_TX + (int)threadIdx.x % BWD_TX) * vec;
    col_live = m0 < a.M;
    n0 = (tile * a.chunks + c) * GROUP_ROWS + (int)threadIdx.x / BWD_TX * BWD_ROWS;
  }
  __device__ void next(const BwdArgs& a, int vec) {
    if (++l < a.L) return;
    l = 0;
    if (++c == a.chunks) c = 0, item += gridDim.x;
    rows(a, vec);
  }
};

// Row r's VEC elements of q = g or k for this thread in the ring's stage.
template <int VEC>
__device__ __forceinline__ float* ring_at(float* ring, int stage, int q, int r) {
  return ring + (((stage * 2 + q) * BWD_ROWS + r) * THREADS + (int)threadIdx.x) * VEC;
}

// With g's planes transposed (GT): column v's BWD_ROWS elements of g for
// this thread, in the place of g's rows.
template <int VEC>
__device__ __forceinline__ float* ring_gt(float* ring, int stage, int v) {
  return ring + ((stage * 2 * VEC + v) * THREADS + (int)threadIdx.x) * BWD_ROWS;
}

// Copies the step under the cursor into `stage` (nothing past the last
// item or outside the output) and commits it as one group. k is (L, N, M);
// g too, or with GT each plane transposed (g[l, n, m] at l N M + m N + n,
// the layout a column-major solve's gradient arrives in): then the copies
// of g take a column's four rows at once where N % 4 == 0.
template <int VEC, bool GT>
__device__ __forceinline__ void fill(float* ring, int stage, const Cursor& cur,
                                     const float* __restrict__ g,
                                     const float* __restrict__ k, const BwdArgs& a) {
  if (cur.item < a.items && cur.col_live) {
    const int64_t plane = (int64_t)a.N * a.M;
#pragma unroll
    for (int r = 0; r < BWD_ROWS; ++r) {
      if (cur.n0 + r < a.N) {
        const int64_t at = cur.l * plane + (int64_t)(cur.n0 + r) * a.M + cur.m0;
        if constexpr (!GT) cp_async<VEC>(ring_at<VEC>(ring, stage, 0, r), g + at);
        cp_async<VEC>(ring_at<VEC>(ring, stage, 1, r), k + at);
      }
    }
    if constexpr (GT) {
      if (cur.n0 < a.N) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float* col = g + cur.l * plane + (int64_t)(cur.m0 + v) * a.N + cur.n0;
        if (a.N % 4 == 0) {  // n0 % 4 == 0: the four rows are live together, 16 bytes
          cp_async<4>(ring_gt<VEC>(ring, stage, v), col);
        } else {
#pragma unroll
          for (int r = 0; r < BWD_ROWS; ++r)
            if (cur.n0 + r < a.N) cp_async<1>(ring_gt<VEC>(ring, stage, v) + r, col + r);
        }
      }
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One unit of the fixed-order sums, with the first design's reduction
// kernel's threads and order. Units [0, 2L): hyper[q, l] from phyper[q,
// l, :] (dsigma = 2 sum / sigma for q = 0, dell = sum / ell^3 for q = 1):
// each thread sums the parts i = thread, + 256, ... in double, then a
// pairwise tree (red[t] += red[t + h] for h = 128, ..., 1; the last five
// levels as shuffles down). Then units of 32 consecutive outputs of dx (N
// D, over `strips` slabs of pdx) and dz (M D, over `tiles` slabs of pdz),
// 32 OUTS of them a unit, a thread taking OUTS outputs 32 apart: slice t of
// SLICES sums the slabs t, t + SLICES, ... in double, then the slices in
// order. Partials are read from L2 (ld.global.cg): other blocks wrote them.
__device__ void sum_unit(int64_t unit, const float* pdx, const float* pdz,
                         const float* phyper, const BwdArgs& a, int D, const float* sigma,
                         const float* lengthscale, float* __restrict__ dx,
                         float* __restrict__ dz, float* __restrict__ hyper, double* red) {
  const int tid = threadIdx.x;
  const int hyper_units = hyper != nullptr ? 2 * a.L : 0;
  if (unit < hyper_units) {
    const float* p = phyper + unit * a.n_parts;
    double sum = 0.0;
    for (int64_t i0 = tid; i0 < a.n_parts; i0 += (int64_t)AHEAD * THREADS) {
      float v[AHEAD];
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        const int64_t i = i0 + (int64_t)u * THREADS;
        v[u] = i < a.n_parts ? __ldcg(p + i) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < AHEAD; ++u)
        if (i0 + (int64_t)u * THREADS < a.n_parts) sum += (double)v[u];
    }
    red[tid] = sum;
    __syncthreads();
#pragma unroll
    for (int h = THREADS / 2; h >= 64; h >>= 1) {
      if (tid < h) red[tid] += red[tid + h];
      __syncthreads();
    }
    if (tid < 32) {
      double v = red[tid] + red[tid + 32];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
      if (tid == 0) {
        const int q = (int)unit / a.L, l = (int)unit % a.L;
        const double ell = (double)lengthscale[l];
        hyper[unit] = (float)(q == 0 ? 2.0 * v / (double)sigma[l] : v / (ell * ell * ell));
      }
    }
    __syncthreads();
    return;
  }
  const int64_t nx = dx != nullptr ? (int64_t)a.N * D : 0;
  const int64_t nz = dz != nullptr ? (int64_t)a.M * D : 0;
  const int slice = tid / 32, lane = tid % 32;
  const int64_t first = (unit - hyper_units) * 32 * OUTS + lane;
  const float* src[OUTS];
  int64_t j[OUTS], stride[OUTS];
  int count[OUTS], most = 0;
  double sum[OUTS];
#pragma unroll
  for (int q = 0; q < OUTS; ++q) {  // outputs first + 32 q: dx's, then dz's
    const int64_t i = first + 32 * q;
    const bool is_dx = i < nx;
    j[q] = is_dx ? i : i - nx;
    src[q] = is_dx ? pdx : pdz;
    stride[q] = is_dx ? nx : nz;
    count[q] = j[q] < stride[q] ? (is_dx ? a.strips : a.tiles) : 0;
    most = count[q] > most ? count[q] : most;
    sum[q] = 0.0;
  }
  for (int t0 = slice; t0 < most; t0 += AHEAD * SLICES) {
    float v[OUTS][AHEAD];
#pragma unroll
    for (int q = 0; q < OUTS; ++q)
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        const int t = t0 + u * SLICES;
        v[q][u] = t < count[q] ? __ldcg(src[q] + (int64_t)t * stride[q] + j[q]) : 0.f;
      }
#pragma unroll
    for (int q = 0; q < OUTS; ++q)
#pragma unroll
      for (int u = 0; u < AHEAD; ++u)
        if (t0 + u * SLICES < count[q]) sum[q] += (double)v[q][u];
  }
#pragma unroll
  for (int q = 0; q < OUTS; ++q) red[q * THREADS + tid] = sum[q];
  __syncthreads();
  if (slice == 0) {
#pragma unroll
    for (int q = 0; q < OUTS; ++q) {
      if (count[q] == 0) continue;
      double total = 0.0;
#pragma unroll
      for (int t = 0; t < SLICES; ++t) total += red[q * THREADS + t * 32 + lane];
      (src[q] == pdx ? dx : dz)[j[q]] = (float)total;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Adds 1 to *p and returns the old value, releasing every write of the
// block before the last barrier (cumulative over it, as CUTLASS's
// semaphores rely on) and acquiring what earlier adds released.
__device__ __forceinline__ unsigned ticket(unsigned* p) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;" : "=r"(old) : "l"(p) : "memory");
  return old;
}

// Partials: pdx (strips, N, D) where dx is wanted, pdz (tiles, M, D) where
// dz is, phyper (2, L, n_parts) where dsigma or dell is, n_parts = items *
// chunks, row group r of strip s at r * strips + s; counters: COUNTERS of
// them, 0 before and after a launch. The last `helpers` blocks to finish
// their items wait for the others and then share the fixed-order sums:
// fewer than an SM count of them, so the blocks that wait never hold every
// slot a block still to start needs.
template <int D, int VEC, bool GT>
__global__ void __launch_bounds__(THREADS, D <= 2 ? 2 : 1)
rbf_gram_bwd_kernel(const float* __restrict__ g, const float* __restrict__ k,
                    const float* __restrict__ x, const float* __restrict__ z,
                    const float* __restrict__ sigma, const float* __restrict__ lengthscale,
                    float* __restrict__ dx, float* __restrict__ dz, float* __restrict__ hyper,
                    float* __restrict__ pdx, float* __restrict__ pdz,
                    float* __restrict__ phyper, unsigned* __restrict__ counters, BwdArgs a,
                    int helpers) {
  extern __shared__ __align__(16) float ring[];  // [STAGES][2][BWD_ROWS][THREADS][VEC]
  __shared__ float part[2][LC][2][WARPS];
  __shared__ float sdx[2][WARPS][BWD_ROWS][D];
  __shared__ float sdz[BWD_TY][VEC][D][BWD_TX];
  __shared__ unsigned helper;
  const int N = a.N, M = a.M, L = a.L, strips = a.strips;
  const int tx = threadIdx.x % BWD_TX, ty = threadIdx.x / BWD_TX;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  Cursor ahead;
  ahead.start(blockIdx.x, a, VEC);
  for (int s = 0; s < STAGES - 1; ++s) {
    fill<VEC, GT>(ring, s, ahead, g, k, a);
    ahead.next(a, VEC);
  }
  int step = 0, buf = 0;
  for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
    const int strip = item % strips, tile = item / strips;
    const int m0 = (strip * BWD_TX + tx) * VEC;
    const bool col_live = m0 < M;  // VEC divides M: all VEC columns exist
    float zr[VEC][D], dz_acc[VEC][D];
#pragma unroll
    for (int v = 0; v < VEC; ++v)
#pragma unroll
      for (int d = 0; d < D; ++d) {
        zr[v][d] = col_live ? __ldg(z + (int64_t)(m0 + v) * D + d) : 0.f;
        dz_acc[v][d] = 0.f;
      }
    for (int c = 0; c < a.chunks; ++c, buf ^= 1) {
      const int group = tile * a.chunks + c;
      const int n0 = group * GROUP_ROWS + ty * BWD_ROWS;
      float xr[BWD_ROWS][D], d2[BWD_ROWS][VEC], w[BWD_ROWS][VEC];
      bool live[BWD_ROWS];
#pragma unroll
      for (int r = 0; r < BWD_ROWS; ++r) {
        live[r] = col_live && n0 + r < N;
#pragma unroll
        for (int d = 0; d < D; ++d)
          xr[r][d] = n0 + r < N ? __ldg(x + (int64_t)(n0 + r) * D + d) : 0.f;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          float acc = 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) {
            const float diff = xr[r][d] - zr[v][d];
            acc = fmaf(diff, diff, acc);
          }
          d2[r][v] = acc;
          w[r][v] = 0.f;
        }
      }
      const int64_t part_at = (int64_t)group * strips + strip;
      for (int l = 0; l < L; ++l, ++step) {
        fill<VEC, GT>(ring, (step + STAGES - 1) % STAGES, ahead, g, k, a);
        ahead.next(a, VEC);
        asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1) : "memory");
        const int stage = step % STAGES;
        const float ell = __ldg(lengthscale + l);
        const float inv_ell2 = 1.f / (ell * ell);
        float s_gk = 0.f, s_gkd2 = 0.f;
        float gt[VEC][BWD_ROWS];  // GT: this thread's g, column by column
        if constexpr (GT) {
#pragma unroll
          for (int v = 0; v < VEC; ++v) load_smem<BWD_ROWS>(gt[v], ring_gt<VEC>(ring, stage, v));
        }
#pragma unroll
        for (int r = 0; r < BWD_ROWS; ++r) {
          float gv[VEC], kv[VEC];
          if (live[r]) {
            if constexpr (GT) {
#pragma unroll
              for (int v = 0; v < VEC; ++v) gv[v] = gt[v][r];
            } else {
              load_smem<VEC>(gv, ring_at<VEC>(ring, stage, 0, r));
            }
            load_smem<VEC>(kv, ring_at<VEC>(ring, stage, 1, r));
          } else {
#pragma unroll
            for (int v = 0; v < VEC; ++v) gv[v] = kv[v] = 0.f;
          }
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            const float gk = gv[v] * kv[v];
            s_gk += gk;
            s_gkd2 = fmaf(gk, d2[r][v], s_gkd2);
            w[r][v] = fmaf(gk, inv_ell2, w[r][v]);
          }
        }
        if (phyper != nullptr) {
          s_gk = warp_sum(s_gk);
          s_gkd2 = warp_sum(s_gkd2);
          const int slot = l % LC;
          if (lane == 0) {
            part[buf][slot][0][warp] = s_gk;
            part[buf][slot][1][warp] = s_gkd2;
          }
          if (slot == LC - 1 && l < L - 1) {  // more than LC factors: flush these LC
            __syncthreads();
            const int l0 = l - slot;
            for (int i = threadIdx.x; i < 2 * LC; i += THREADS) {
              const int kk = i / 2, q = i % 2;
              float sum = 0.f;
#pragma unroll
              for (int wp = 0; wp < WARPS; ++wp) sum += part[buf][kk][q][wp];
              phyper[((int64_t)q * L + l0 + kk) * a.n_parts + part_at] = sum;
            }
            __syncthreads();
          }
        }
      }
      if (pdx != nullptr) {
        // dx[n] over this strip: the thread's columns, the warp, then (below)
        // the thread-row's warps
#pragma unroll
        for (int r = 0; r < BWD_ROWS; ++r)
#pragma unroll
          for (int d = 0; d < D; ++d) {
            float acc = 0.f;
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc = fmaf(w[r][v], zr[v][d] - xr[r][d], acc);
            acc = warp_sum(live[r] ? acc : 0.f);
            if (lane == 0) sdx[buf][warp][r][d] = acc;
          }
      }
      if (phyper != nullptr || pdx != nullptr) {
        __syncthreads();
        if (phyper != nullptr) {
          const int slot = (L - 1) % LC, l0 = L - 1 - slot;
          for (int i = threadIdx.x; i < 2 * (slot + 1); i += THREADS) {
            const int kk = i / 2, q = i % 2;
            float sum = 0.f;
#pragma unroll
            for (int wp = 0; wp < WARPS; ++wp) sum += part[buf][kk][q][wp];
            phyper[((int64_t)q * L + l0 + kk) * a.n_parts + part_at] = sum;
          }
        }
        if (pdx != nullptr) {
          for (int i = threadIdx.x; i < GROUP_ROWS * D; i += THREADS) {
            const int row = i / D, d = i % D, n = group * GROUP_ROWS + row;
            if (n < N) {
              float sum = 0.f;
#pragma unroll
              for (int h = 0; h < ROW_WARPS; ++h)
                sum += sdx[buf][(row / BWD_ROWS) * ROW_WARPS + h][row % BWD_ROWS][d];
              pdx[((int64_t)strip * N + n) * D + d] = sum;
            }
          }
        }
      }
      if (pdz != nullptr) {
#pragma unroll
        for (int r = 0; r < BWD_ROWS; ++r) {
          if (!live[r]) continue;
#pragma unroll
          for (int v = 0; v < VEC; ++v)
#pragma unroll
            for (int d = 0; d < D; ++d)
              dz_acc[v][d] = fmaf(w[r][v], xr[r][d] - zr[v][d], dz_acc[v][d]);
        }
      }
    }
    if (pdz != nullptr) {
      // dz[m] over the item's rows: the four thread-rows, in order
#pragma unroll
      for (int v = 0; v < VEC; ++v)
#pragma unroll
        for (int d = 0; d < D; ++d) sdz[ty][v][d][tx] = dz_acc[v][d];
      __syncthreads();
      if (ty == 0 && col_live) {
#pragma unroll
        for (int v = 0; v < VEC; ++v)
#pragma unroll
          for (int d = 0; d < D; ++d) {
            float sum = 0.f;
#pragma unroll
            for (int t = 0; t < BWD_TY; ++t) sum += sdz[t][v][d][tx];
            pdz[((int64_t)tile * M + m0 + v) * D + d] = sum;
          }
      }
      // sdz is written again at the next item's end: its row groups' barriers
      // keep that apart from these reads, or this one where they have none
      if (pdx == nullptr && phyper == nullptr) __syncthreads();
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  // this block's items are done: a ticket in the order blocks finish; the
  // last `helpers` wait for every block, then share the sums
  __syncthreads();
  if (threadIdx.x == 0) helper = gridDim.x - 1 - ticket(counters + DONE);
  __syncthreads();
  const unsigned h = helper;
  if (h >= (unsigned)helpers) return;
  unsigned passed = 0;  // helpers past their wait before this one
  if (threadIdx.x == 0) {
    if (h > 0)  // the last block's own ticket acquired every other block's
      while (load_acquire(counters + DONE) < gridDim.x) __nanosleep(32);
    passed = atomicInc(counters + EXITED, helpers - 1);  // read after the sums
  }
  __syncthreads();
  const int64_t units = (hyper != nullptr ? 2 * L : 0) +
                        ((dx != nullptr ? (int64_t)N * D : 0) +
                         (dz != nullptr ? (int64_t)M * D : 0) + 32 * OUTS - 1) / (32 * OUTS);
  double* red = reinterpret_cast<double*>(ring);  // no copy is in flight any more
  for (int64_t u = h; u < units; u += helpers)
    sum_unit(u, pdx, pdz, phyper, a, D, sigma, lengthscale, dx, dz, hyper, red);
  // the last helper past its wait leaves the counters at 0 for the next
  // launch: every block has read them for the last time
  if (threadIdx.x == 0 && passed == (unsigned)helpers - 1) counters[DONE] = 0;
}

struct BwdPlan {
  int vec, sms;
  BwdArgs args;
  int64_t floats;  // scratch: pdx, pdz, phyper
};

// The backward's partials; false for a shape it does not take.
bool bwd_plan(int N, int M, int D, int L, BwdPlan* p) {
  if (N < 1 || M < 1 || L < 1 || D < 1 || D > MAXD || N > INT_MAX_ - GROUP_ROWS ||
      M > INT_MAX_ - 4 * BWD_TX || L > INT_MAX_ / 2)
    return false;
  int device, sms;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return false;
  p->sms = sms;
  BwdArgs& a = p->args;
  a.N = N, a.M = M, a.L = L;
  p->vec = M % 4 == 0 ? 4 : (M % 2 == 0 ? 2 : 1);
  a.strips = (int)((M + (int64_t)BWD_TX * p->vec - 1) / ((int64_t)BWD_TX * p->vec));
  const int64_t groups = (N + (int64_t)GROUP_ROWS - 1) / GROUP_ROWS;
  const int64_t chunks = groups * a.strips / ((int64_t)PLAN_BLOCKS_PER_SM * sms);
  a.chunks = (int)(chunks < 1 ? 1 : (chunks > groups ? groups : chunks));
  a.tiles = (int)((groups + a.chunks - 1) / a.chunks);
  const int64_t items = (int64_t)a.tiles * a.strips;
  if (items > INT_MAX_ / 2) return false;  // a block's next item stays inside int
  a.items = (int)items;
  a.n_parts = items * a.chunks;
  p->floats = (int64_t)a.strips * N * D + (int64_t)a.tiles * M * D + 2 * (int64_t)L * a.n_parts;
  return true;
}

constexpr int ring_bytes(int vec) { return STAGES * 2 * BWD_ROWS * THREADS * vec * 4; }

// One wave of the blocks that fit, at most one block an item.
int grid_of(const BwdPlan& p, int per_sm) {
  const int64_t wave = (int64_t)per_sm * p.sms;
  return (int)(p.args.items < wave ? p.args.items : wave);
}

// Blocks that share the fixed-order sums: fewer than the SM count, so that
// at least one slot (a block fits on every SM) is never held by a block
// that waits.
int helpers_of(int grid, int sms) {
  const int most = sms > 1 ? sms - 1 : 1;
  return grid < most ? grid : most;
}

// The instance's blocks that fit on an SM with its ring (asked for once),
// or a CUDA error as a negative number.
template <int D, int VEC, bool GT>
int resident_blocks() {
  static int blocks = 0;
  if (blocks > 0) return blocks;
  auto kernel = rbf_gram_bwd_kernel<D, VEC, GT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         ring_bytes(VEC));
  int got = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&got, kernel, THREADS, ring_bytes(VEC));
  if (err != cudaSuccess) return -(int)err;
  if (got < 1) return -(int)cudaErrorInvalidConfiguration;
  return blocks = got;
}

template <int D, int VEC, bool GT>
int launch_bwd(const float* g, const float* k, const float* x, const float* z,
               const float* sigma, const float* lengthscale, float* dx, float* dz,
               float* hyper, float* scratch, unsigned* counters, const BwdPlan& p,
               cudaStream_t st) {
  const int per_sm = resident_blocks<D, VEC, GT>();
  if (per_sm < 0) return -per_sm;
  const BwdArgs& a = p.args;
  const int grid = grid_of(p, per_sm);
  float* pdx = dx != nullptr ? scratch : nullptr;
  float* pdz = dz != nullptr ? scratch + (int64_t)a.strips * a.N * D : nullptr;
  float* phyper = hyper != nullptr ? scratch + (int64_t)a.strips * a.N * D +
                                         (int64_t)a.tiles * a.M * D
                                   : nullptr;
  rbf_gram_bwd_kernel<D, VEC, GT><<<grid, THREADS, ring_bytes(VEC), st>>>(
      g, k, x, z, sigma, lengthscale, dx, dz, hyper, pdx, pdz, phyper, counters, a,
      helpers_of(grid, p.sms));
  return (int)cudaGetLastError();
}

template <int VEC, bool GT>
int launch_bwd_d(const float* g, const float* k, const float* x, const float* z,
                 const float* sigma, const float* lengthscale, float* dx, float* dz,
                 float* hyper, float* scratch, unsigned* counters, int D, const BwdPlan& p,
                 cudaStream_t st) {
#define GRAM_BWD_CASE(DV)                                                                  \
  case DV:                                                                                 \
    return launch_bwd<DV, VEC, GT>(g, k, x, z, sigma, lengthscale, dx, dz, hyper, scratch, \
                                   counters, p, st);
  switch (D) {
    GRAM_BWD_CASE(1) GRAM_BWD_CASE(2) GRAM_BWD_CASE(3) GRAM_BWD_CASE(4)
    GRAM_BWD_CASE(5) GRAM_BWD_CASE(6) GRAM_BWD_CASE(7) GRAM_BWD_CASE(8)
  }
#undef GRAM_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

template <int VEC>
int launch(const float* x, const float* z, const float* sigma, const float* lengthscale,
           float* out, int N, int M, int D, int L, int rows, int n_strips, int n_tiles,
           cudaStream_t st) {
#define GRAM_CASE(DV)                                                          \
  case DV:                                                                     \
    rbf_gram_kernel<DV, VEC><<<n_tiles, THREADS, 0, st>>>(                     \
        x, z, sigma, lengthscale, out, N, M, L, rows, n_strips);               \
    return (int)cudaGetLastError();
  switch (D) {
    GRAM_CASE(1) GRAM_CASE(2) GRAM_CASE(3) GRAM_CASE(4)
    GRAM_CASE(5) GRAM_CASE(6) GRAM_CASE(7) GRAM_CASE(8)
  }
#undef GRAM_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The tile plan: 16-byte stores (VEC 4) when rows are 16-byte aligned,
// else 4-byte ones; rows * L ~ ROW_PLANES row-planes a tile, fewer rows
// where that would leave fewer than BLOCKS_PER_SM tiles per SM. Returns
// cudaErrorInvalidValue, before any launch, for a shape the kernel does
// not take: D outside 1..8, or row, column or tile indices (which run up
// to one tile past N and M) outside int.
extern "C" int rbf_gram_f32(const float* x, const float* z, const float* sigma,
                            const float* lengthscale, float* out, int N, int M, int D,
                            int L, void* stream) {
  if (N < 1 || M < 1 || L < 1 || D < 1 || D > MAXD || N > INT_MAX_ - ROW_PLANES ||
      M > INT_MAX_ - 4 * THREADS)
    return (int)cudaErrorInvalidValue;
  int device, sms;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int vec = M % 4 == 0 ? 4 : 1;
  const int64_t n_strips = (M + (int64_t)THREADS * vec - 1) / ((int64_t)THREADS * vec);
  const int64_t fill = ((int64_t)N * n_strips + (int64_t)BLOCKS_PER_SM * sms - 1) /
                       ((int64_t)BLOCKS_PER_SM * sms);
  const int64_t per_l = L < ROW_PLANES ? ROW_PLANES / L : 1;
  const int rows = (int)(fill < per_l ? (fill < 1 ? 1 : fill) : per_l);
  const int64_t n_tiles = (N + (int64_t)rows - 1) / rows * n_strips;
  if (n_tiles > INT_MAX_) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return vec == 4 ? launch<4>(x, z, sigma, lengthscale, out, N, M, D, L, rows,
                              (int)n_strips, (int)n_tiles, st)
                  : launch<1>(x, z, sigma, lengthscale, out, N, M, D, L, rows,
                              (int)n_strips, (int)n_tiles, st);
}

// The backward's scratch in floats for this shape on the current device,
// or -1 for a shape it refuses (D outside 1..8, indices outside int).
extern "C" long long rbf_gram_bwd_scratch(int N, int M, int D, int L) {
  BwdPlan p;
  return bwd_plan(N, M, D, L, &p) ? (long long)p.floats : -1;
}

// The backward's counters (unsigned ints) for this shape, or -1: they must
// be 0 before the first launch, and every launch leaves them at 0.
extern "C" long long rbf_gram_bwd_counters(int N, int M, int D, int L) {
  BwdPlan p;
  return bwd_plan(N, M, D, L, &p) ? (long long)COUNTERS : -1;
}

// The backward's plan for this shape on the current device, into out[0..9]:
// VEC, strips, chunks, tiles, items, the grid, the instance's blocks an
// SM, the SM count, the ring's bytes and the helpers. 0, or a CUDA error.
extern "C" int rbf_gram_bwd_plan(int N, int M, int D, int L, long long* out) {
  BwdPlan p;
  if (!bwd_plan(N, M, D, L, &p)) return (int)cudaErrorInvalidValue;
  int per_sm = 0;
#define GRAM_OCC(DV, V) \
  if (D == DV && p.vec == V) per_sm = resident_blocks<DV, V, false>();
#define GRAM_OCC_D(DV) GRAM_OCC(DV, 1) GRAM_OCC(DV, 2) GRAM_OCC(DV, 4)
  GRAM_OCC_D(1) GRAM_OCC_D(2) GRAM_OCC_D(3) GRAM_OCC_D(4)
  GRAM_OCC_D(5) GRAM_OCC_D(6) GRAM_OCC_D(7) GRAM_OCC_D(8)
#undef GRAM_OCC_D
#undef GRAM_OCC
  if (per_sm < 0) return -per_sm;
  const BwdArgs& a = p.args;
  const int grid = grid_of(p, per_sm);
  const long long v[10] = {p.vec, a.strips, a.chunks, a.tiles, a.items, grid, per_sm, p.sms,
                           ring_bytes(p.vec), helpers_of(grid, p.sms)};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}

// dx (N, D), dz (M, D) and hyper (2, L) = (dsigma, dell) for the cotangent
// g (L, N, M) and the forward's k (L, N, M), each written where it is not
// null; scratch holds rbf_gram_bwd_scratch(N, M, D, L) floats and counters
// rbf_gram_bwd_counters(N, M, D, L) zeros. g_transposed: each plane of g
// is stored transposed (g[l, n, m] at l N M + m N + n). One launch.
extern "C" int rbf_gram_bwd_f32(const float* g, const float* k, const float* x,
                                const float* z, const float* sigma,
                                const float* lengthscale, float* dx, float* dz,
                                float* hyper, float* scratch, unsigned* counters, int N,
                                int M, int D, int L, int g_transposed, void* stream) {
  BwdPlan p;
  if (!bwd_plan(N, M, D, L, &p) || scratch == nullptr || counters == nullptr)
    return (int)cudaErrorInvalidValue;
  if (dx == nullptr && dz == nullptr && hyper == nullptr) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define GRAM_BWD_VEC(V)                                                                   \
  case V:                                                                                 \
    return g_transposed ? launch_bwd_d<V, true>(g, k, x, z, sigma, lengthscale, dx, dz,   \
                                                hyper, scratch, counters, D, p, st)       \
                        : launch_bwd_d<V, false>(g, k, x, z, sigma, lengthscale, dx, dz,  \
                                                 hyper, scratch, counters, D, p, st);
  switch (p.vec) {
    GRAM_BWD_VEC(4) GRAM_BWD_VEC(2) GRAM_BWD_VEC(1)
  }
#undef GRAM_BWD_VEC
  return (int)cudaErrorInvalidValue;
}
