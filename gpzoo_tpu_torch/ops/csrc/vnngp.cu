// VNNGP per-point K x K conditioning, f32.
//
// Replaces gpzoo_tpu/ops/vnngp_pallas.py: block_conditional (_kernel).
// For each point n, with B = kzz[n] + jitter * I (K x K, K <= 16):
//   w = B^-1 kxz[n],  mean[n] = w . mu[n],
//   cov[n] = kxx[n] + w (s[n] - B) w^T.
// kzz, s (n, K, K) row-major; kxz, mu (n, K); kxx, mean, cov (n).
// The jitter is added twice on purpose: to the diagonal that is factored
// and to the diagonal that is subtracted, since the callers' kzz blocks
// already carry the Kzz jitter (the JAX package replicates its reference).
//
// What bounds it on an H100: device memory at the posterior's size, the
// latency of its loads at a training step's. At K = 8 a point reads
// (2*64 + 2*8 + 1) * 4 = 580 B and writes 8 B for ~550 FLOP, about one
// FLOP per byte against the card's ~20 FLOP/B f32 balance (67 TFLOP/s over
// 3.35 TB/s). At the posterior's n = 1,000,000 that is 588 MB, 0.18 ms at
// full bandwidth; at a step's n = 5,000 (2.9 MB, 0.9 us) the time is set
// by how many dependent trips to memory each warp makes.
//
// What the design does about it:
//  * One thread per point, K a template parameter (1..16), every loop
//    unrolled, so the Cholesky factor, the two substitutions and w stay in
//    registers and nothing but mean and cov is written.
//  * A block is one warp and owns 32 consecutive points, so a step's
//    n = 5,000 gives 157 blocks for the 132 SMs. It copies their kzz, kxz,
//    mu and s into shared memory with 4-byte cp.async copies:
//    consecutive lanes take consecutive words of the contiguous source
//    (coalesced), no copy waits on another, and every word is in flight
//    at once, so a warp pays one trip to memory, not one per word. kzz,
//    kxz and mu form the first commit group and s the second: the
//    Cholesky starts when the first lands, while s is still on its way.
//  * The copies transpose: element e of the block's point t lands at
//    e * 33 + t (element-major, as the JAX kernel's layout, with an odd
//    row stride), so when each lane reads element e of its own point the
//    32 lanes hit 32 different banks. Waits are cp.async.wait_group and
//    __syncwarp: there is no block-wide barrier.
//  * Offsets into the (n, K, K) arrays are 64-bit: n*K*K reaches 6.4e7 at
//    the posterior shape and passes 2^31 for a larger N or L.
// Shared memory: (2K^2 + 2K) * 33 * 4 B a block, 19 KB at K = 8, 70 KB at
// K = 16. Blocks of 2 or 4 warps were no faster at n = 10^6 on an H100.
// Registers (nvcc -Xptxas -v, sm_90a; chip_smoke.py prints them): 88 and
// no spills at K = 8; K = 15 reaches the 255-register cap without
// spilling, K = 16 spills 168 B a thread (its 136-entry factor).
// Not yet done: reading Kzz and S by neighbour index inside the kernel
// instead of the caller's materialized (n, K, K) copies of their blocks.
//
// The backward (block_conditional_bwd_f32) replaces vnngp_pallas.py _bwd,
// JAX's vjp of _xla_reference, in closed form. Per point, for the
// cotangents gm = d/d mean[n] and gc = d/d cov[n], with B = L L^T as above:
//   w = B^-1 kxz,  diff = s - B,
//   dw = gm mu + gc (diff + diff^T) w,  v = B^-1 dw,
//   dkzz = -1/2 (v w^T + w v^T) - gc w w^T,  ds = gc w w^T,
//   dkxz = v,  dmu = gm w  (and dkxx = gc, which the wrapper returns).
// (diff + diff^T), not 2 diff: the gathered s is not bit-symmetric, and the
// vjp differentiates w (s - B) w^T as written. The -1/2 (v w^T + w v^T) is
// the Cholesky's symmetrized gradient, as jnp.linalg.cholesky and
// torch.linalg.cholesky both give it.
// What bounds it on an H100: device memory at the posterior's size, the
// latency of its loads at a step's, as for the forward. At K = 8 a point
// reads (2*64 + 2*8 + 2) * 4 = 584 B and writes (2*64 + 2*8) * 4 = 576 B
// for ~1,100 FLOP; at the VNNGP sweep's n = 50,000 that is 58 MB, 17 us at
// 3.35 TB/s. One thread a point (the forward's layout) makes the whole
// K = 8 chain serial in that thread and leaves a step's n = 5,000 at about
// one warp an SM.
// What the design does about it: rows a lane. A point takes G lanes, K
// rounded up to a power of two (8 at K = 8: four points a warp), and lane
// i of its group owns row i of the point's kzz and s:
//  * Lane i reads rows i of kzz and s, K contiguous floats (16-byte loads
//    when K % 4 == 0 and the operands are 16-byte aligned), and every lane
//    of the point reads its kxz: the warp's loads are coalesced and nothing
//    is staged or transposed in shared memory.
//  * The Cholesky runs right-looking over the lanes: at step k the pivot
//    comes from lane k by a shuffle, each lane scales its l_ik, and column
//    k of L goes round by shuffles, so every a_ij subtracts l_ik l_jk for
//    k = 0, 1, ..., j - 1 in order, as cholesky<K> does; every lane ends up
//    holding all of L and the reciprocals of its diagonal.
//  * The solves for w and v then run in every lane of the point with
//    chol_solve<K>, the forward's code, so each sum keeps its order; dw_i
//    is lane i's: column i of kzz and s, which (diff + diff^T) needs, comes
//    from L1, where the warp's row loads just put it; dw goes round by
//    shuffles before the second solve.
//  * Lane i writes row i of dkzz and ds straight from registers (16-byte
//    stores when aligned), and element i of dkxz and dmu; only the outputs
//    asked for (non-null) are written.
//  * Blocks of BWD_WARPS = 2 warps on a grid of whole waves: as many
//    blocks as fit on the card (the instance's occupancy, read from the
//    device), each warp taking groups of points warp, + all the grid's
//    warps, ... (blocks of 4 or 8 warps were slower on an H100), and
//    loading the next group's inputs before this group's arithmetic. A
//    step's n = 5,000 is 1,250 warps, about ten an SM.
// Every output is the same bits as the one-thread-a-point kernel's: each
// sum runs in the same order with the same contractions.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;      // points (threads) per block
constexpr int LD = WARP + 1;  // element-major row stride, in words

template <int K>
struct Shape {
  static constexpr int KK = K * K;
  static constexpr int SMEM = (2 * KK + 2 * K) * LD * (int)sizeof(float);
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// Copies `count` contiguous ROWS-element records from src into the block's
// element-major buffer dst: element e of record t goes to dst[e * LD + t].
template <int ROWS>
__device__ __forceinline__ void stage_async(float* dst, const float* __restrict__ src,
                                            int count, int lane) {
  for (int i = lane; i < count * ROWS; i += WARP) {
    const int t = i / ROWS;
    cp_async4(dst + (i - t * ROWS) * LD + t, src + i);
  }
}

// The lower Cholesky factor l of B = blk + jitter I (blk element-major,
// element e at blk[e * LD]) and the reciprocals of its diagonal.
template <int K>
__device__ __forceinline__ void cholesky(const float* blk, float jitter, float (&l)[K][K],
                                         float (&inv_diag)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float acc = blk[(i * K + j) * LD];
      if (i == j) acc += jitter;
#pragma unroll
      for (int k = 0; k < j; ++k) acc -= l[i][k] * l[j][k];
      if (i == j) {
        l[i][i] = sqrtf(acc);
        inv_diag[i] = 1.f / l[i][i];
      } else {
        l[i][j] = acc * inv_diag[j];
      }
    }
  }
}

// x = B^-1 b from the factor: forward then back substitution.
template <int K>
__device__ __forceinline__ void chol_solve(const float (&l)[K][K], const float (&inv_diag)[K],
                                           const float (&b)[K], float (&x)[K]) {
  float y[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float acc = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) acc -= l[i][k] * y[k];
    y[i] = acc * inv_diag[i];
  }
#pragma unroll
  for (int i = K - 1; i >= 0; --i) {
    float acc = y[i];
#pragma unroll
    for (int k = i + 1; k < K; ++k) acc -= l[k][i] * x[k];
    x[i] = acc * inv_diag[i];
  }
}

template <int K>
__global__ void __launch_bounds__(WARP)
block_conditional_kernel(const float* __restrict__ kzz, const float* __restrict__ s,
                         const float* __restrict__ kxz, const float* __restrict__ mu,
                         const float* __restrict__ kxx, float* __restrict__ mean_out,
                         float* __restrict__ cov_out, long long n, float jitter) {
  using S = Shape<K>;
  extern __shared__ float kzz_s[];  // then s, kxz, mu
  const int lane = threadIdx.x;
  const long long p0 = (long long)blockIdx.x * WARP;
  const int count = (int)(n - p0 < WARP ? n - p0 : WARP);
  float* s_s = kzz_s + S::KK * LD;
  float* kxz_s = s_s + S::KK * LD;
  float* mu_s = kxz_s + K * LD;

  stage_async<S::KK>(kzz_s, kzz + p0 * S::KK, count, lane);
  stage_async<K>(kxz_s, kxz + p0 * K, count, lane);
  stage_async<K>(mu_s, mu + p0 * K, count, lane);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  stage_async<S::KK>(s_s, s + p0 * S::KK, count, lane);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  const bool active = lane < count;
  const long long p = p0 + lane;
  const float kxx_p = active ? kxx[p] : 0.f;
  const float* blk = kzz_s + lane;  // element e of this lane's point: blk[e * LD]

  asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // kzz, kxz, mu
  __syncwarp();

  float w[K];
  float neg_bw[K];  // -(B w)_j, the subtracted half of w (s - B)
  float mean = 0.f;
  if (active) {
    // Cholesky of B = kzz + jitter I, lower triangle, row by row.
    float l[K][K];
    float inv_diag[K];
    cholesky<K>(blk, jitter, l, inv_diag);
    // w = B^-1 kxz
    float b[K];
#pragma unroll
    for (int i = 0; i < K; ++i) b[i] = kxz_s[i * LD + lane];
    chol_solve<K>(l, inv_diag, b, w);
#pragma unroll
    for (int i = 0; i < K; ++i) mean = fmaf(w[i], mu_s[i * LD + lane], mean);
    // -(B w)_j from the kzz block still in shared memory
#pragma unroll
    for (int j = 0; j < K; ++j) {
      float acc = -jitter * w[j];
#pragma unroll
      for (int k = 0; k < K; ++k) acc -= w[k] * blk[(k * K + j) * LD];
      neg_bw[j] = acc;
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // s
  __syncwarp();
  if (!active) return;
  const float* sblk = s_s + lane;
  float quad = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    float wd = neg_bw[j];
#pragma unroll
    for (int k = 0; k < K; ++k) wd = fmaf(w[k], sblk[(k * K + j) * LD], wd);
    quad = fmaf(wd, w[j], quad);
  }
  mean_out[p] = mean;
  cov_out[p] = kxx_p + quad;
}

constexpr int BWD_WARPS = 2;  // warps of a backward block
constexpr unsigned FULL = 0xffffffffu;

// Lanes a point takes in the backward: K rounded up to a power of two.
template <int K>
struct Rows {
  static constexpr int G = K <= 1 ? 1 : K <= 2 ? 2 : K <= 4 ? 4 : K <= 8 ? 8 : 16;
  static constexpr int POINTS = WARP / G;  // points a warp
};

// K floats from src into dst: 16-byte loads where `vec` (K % 4 == 0 and
// src 16-byte aligned), else 4-byte ones.
template <int K>
__device__ __forceinline__ void load_row(float (&dst)[K], const float* src, bool vec) {
  if constexpr (K % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int j = 0; j < K; j += 4) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(src + j));
        dst[j] = v.x, dst[j + 1] = v.y, dst[j + 2] = v.z, dst[j + 3] = v.w;
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) dst[j] = __ldg(src + j);
}

template <int K>
__device__ __forceinline__ void store_row(float* dst, const float (&src)[K], bool vec) {
  if constexpr (K % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int j = 0; j < K; j += 4)
        *reinterpret_cast<float4*>(dst + j) = make_float4(src[j], src[j + 1], src[j + 2],
                                                          src[j + 3]);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) dst[j] = src[j];
}

// Element `row` of a K-vector every lane holds (a select, no local memory).
template <int K>
__device__ __forceinline__ float pick(const float (&v)[K], int row) {
  float r = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) r = j == row ? v[j] : r;
  return r;
}

// (A minimum of 3 blocks an SM lets ptxas take 147 registers at K = 8
// instead of 128: 12 warps an SM, and 3-10% faster on an H100.)
template <int K>
__global__ void __launch_bounds__(BWD_WARPS * WARP, 3)
block_conditional_bwd_kernel(const float* __restrict__ kzz, const float* __restrict__ s,
                             const float* __restrict__ kxz, const float* __restrict__ mu,
                             const float* __restrict__ g_mean,
                             const float* __restrict__ g_cov, float* __restrict__ dkzz,
                             float* __restrict__ ds, float* __restrict__ dkxz,
                             float* __restrict__ dmu, long long n, float jitter, bool vec) {
  constexpr int G = Rows<K>::G, POINTS = Rows<K>::POINTS, KK = K * K;
  const int lane = threadIdx.x % WARP;
  const int row = lane % G, base = lane - row;  // this lane's row; its point's first lane
  const long long groups = (n + POINTS - 1) / POINTS;
  const long long stride = (long long)gridDim.x * BWD_WARPS;
  // inputs of the lane's point: its rows of kzz and s, all of kxz, its mu
  // and both cotangents (zeros past n or K); the next group's are loaded
  // before this group's arithmetic
  struct Inputs {
    float krow[K], srow[K], b[K], gm, gc, mu_i;
  };
  auto load = [&](Inputs& in, long long grp) {
    const long long p = grp * POINTS + lane / G;
#pragma unroll
    for (int j = 0; j < K; ++j) in.krow[j] = in.srow[j] = in.b[j] = 0.f;
    in.gm = in.gc = in.mu_i = 0.f;
    if (grp < groups && p < n) {
      load_row<K>(in.b, kxz + p * K, vec);
      in.gm = __ldg(g_mean + p), in.gc = __ldg(g_cov + p);
      if (row < K) {
        load_row<K>(in.krow, kzz + p * KK + row * K, vec);
        load_row<K>(in.srow, s + p * KK + row * K, vec);
        in.mu_i = __ldg(mu + p * K + row);
      }
    }
  };
  long long grp = (long long)blockIdx.x * BWD_WARPS + threadIdx.x / WARP;
  Inputs next;
  load(next, grp);
  for (; grp < groups; grp += stride) {
    const Inputs cur = next;
    load(next, grp + stride);
    const float(&krow)[K] = cur.krow;
    const float(&srow)[K] = cur.srow;
    const float(&b)[K] = cur.b;
    const float gm = cur.gm, gc = cur.gc, mu_i = cur.mu_i;
    const long long p = grp * POINTS + lane / G;
    const bool mine = p < n && row < K;  // lanes past K, or past n, hold zeros
    // Cholesky of B = kzz + jitter I, right-looking: lane i holds row i
    float a[K], l[K][K], inv_diag[K];
#pragma unroll
    for (int j = 0; j < K; ++j) a[j] = j == row ? krow[j] + jitter : krow[j];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float lkk = sqrtf(__shfl_sync(FULL, a[k], base + k));
      l[k][k] = lkk;
      inv_diag[k] = 1.f / lkk;
      if (row > k) a[k] = a[k] * inv_diag[k];
#pragma unroll
      for (int j = k + 1; j < K; ++j) {
        l[j][k] = __shfl_sync(FULL, a[k], base + j);
        if (row >= j) a[j] -= a[k] * l[j][k];
      }
    }
    // w = B^-1 kxz in every lane of the point
    float w[K];
    chol_solve<K>(l, inv_diag, b, w);
    // dw_i = gm mu_i + gc ((s + s^T - kzz - kzz^T - 2 jitter I) w)_i: columns
    // i of s and kzz from L1
    const float w_i = pick<K>(w, row);
    float acc = -2.f * jitter * w_i;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float s_ji = mine ? __ldg(s + p * KK + j * K + row) : 0.f;
      const float k_ji = mine ? __ldg(kzz + p * KK + j * K + row) : 0.f;
      acc = fmaf(srow[j] + s_ji - krow[j] - k_ji, w[j], acc);
    }
    const float dw_i = fmaf(gm, mu_i, gc * acc);
    float dw[K], v[K];
#pragma unroll
    for (int j = 0; j < K; ++j) dw[j] = __shfl_sync(FULL, dw_i, base + j);
    chol_solve<K>(l, inv_diag, dw, v);
    if (!mine) continue;
    const float v_i = pick<K>(v, row);
    if (dkzz != nullptr || ds != nullptr) {
      float out_k[K], out_s[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float gww = gc * w_i * w[j];
        out_k[j] = -0.5f * fmaf(v_i, w[j], w_i * v[j]) - gww;
        out_s[j] = gww;
      }
      if (dkzz != nullptr) store_row<K>(dkzz + p * KK + row * K, out_k, vec);
      if (ds != nullptr) store_row<K>(ds + p * KK + row * K, out_s, vec);
    }
    if (dkxz != nullptr) dkxz[p * K + row] = v_i;
    if (dmu != nullptr) dmu[p * K + row] = gm * w_i;
  }
}

// Above 48 KB (K >= 14) a block must ask for its dynamic shared memory,
// once for each kernel instance.
template <typename Kernel>
int ask_smem(Kernel kernel, int bytes, bool* asked) {
  if (bytes <= 48 * 1024 || *asked) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  *asked = true;
  return 0;
}

long long grid_of(long long n) {
  const long long blocks = (n + WARP - 1) / WARP;
  return n < 1 || blocks > 0x7fffffffLL ? -1 : blocks;
}

template <int K>
int launch(const float* kzz, const float* s, const float* kxz, const float* mu,
           const float* kxx, float* mean, float* cov, long long n, float jitter,
           cudaStream_t stream) {
  const long long blocks = grid_of(n);
  if (blocks < 0) return (int)cudaErrorInvalidValue;
  static bool asked = false;
  const int err = ask_smem(block_conditional_kernel<K>, Shape<K>::SMEM, &asked);
  if (err != 0) return err;
  block_conditional_kernel<K><<<(unsigned)blocks, WARP, Shape<K>::SMEM, stream>>>(
      kzz, s, kxz, mu, kxx, mean, cov, n, jitter);
  return (int)cudaGetLastError();
}

// The instance's blocks that fit on an SM, or a CUDA error as a negative
// number.
template <int K>
int bwd_resident_blocks() {
  static int blocks = 0;
  if (blocks > 0) return blocks;
  int got = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &got, block_conditional_bwd_kernel<K>, BWD_WARPS * WARP, 0);
  if (err != cudaSuccess) return -(int)err;
  if (got < 1) return -(int)cudaErrorInvalidConfiguration;
  return blocks = got;
}

bool aligned16(const void* ptr) { return ptr == nullptr || (uintptr_t)ptr % 16 == 0; }

// The backward's grid for n points: blocks of BWD_WARPS warps, at most one
// wave of those that fit. 0 and out = {grid, blocks an SM, SM count}, or
// a CUDA error.
template <int K>
int bwd_grid(long long n, long long (&out)[3]) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int per_sm = bwd_resident_blocks<K>();
  if (per_sm < 0) return -per_sm;
  int device, sms;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long groups = (n + Rows<K>::POINTS - 1) / Rows<K>::POINTS;
  const long long blocks = (groups + BWD_WARPS - 1) / BWD_WARPS;
  const long long wave = (long long)per_sm * sms;
  out[0] = blocks < wave ? blocks : wave, out[1] = per_sm, out[2] = sms;
  return 0;
}

template <int K>
int launch_bwd(const float* kzz, const float* s, const float* kxz, const float* mu,
               const float* g_mean, const float* g_cov, float* dkzz, float* ds, float* dkxz,
               float* dmu, long long n, float jitter, cudaStream_t stream) {
  long long grid[3];
  const int err = bwd_grid<K>(n, grid);
  if (err != 0) return err;
  const bool vec = K % 4 == 0 && aligned16(kzz) && aligned16(s) && aligned16(kxz) &&
                   aligned16(dkzz) && aligned16(ds);
  block_conditional_bwd_kernel<K><<<(unsigned)grid[0], BWD_WARPS * WARP, 0, stream>>>(
      kzz, s, kxz, mu, g_mean, g_cov, dkzz, ds, dkxz, dmu, n, jitter, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int block_conditional_f32(const float* kzz, const float* s,
                                     const float* kxz, const float* mu,
                                     const float* kxx, float* mean, float* cov,
                                     long long n, int k, float jitter,
                                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define VNNGP_CASE(KV)                                                        \
  case KV:                                                                    \
    return launch<KV>(kzz, s, kxz, mu, kxx, mean, cov, n, jitter, st);
  switch (k) {
    VNNGP_CASE(1) VNNGP_CASE(2) VNNGP_CASE(3) VNNGP_CASE(4)
    VNNGP_CASE(5) VNNGP_CASE(6) VNNGP_CASE(7) VNNGP_CASE(8)
    VNNGP_CASE(9) VNNGP_CASE(10) VNNGP_CASE(11) VNNGP_CASE(12)
    VNNGP_CASE(13) VNNGP_CASE(14) VNNGP_CASE(15) VNNGP_CASE(16)
  }
#undef VNNGP_CASE
  return (int)cudaErrorInvalidValue;
}

// dkzz, ds (n, K, K) and dkxz, dmu (n, K) for the cotangents g_mean, g_cov
// (n,); each output is written only where its pointer is not null.
extern "C" int block_conditional_bwd_f32(const float* kzz, const float* s,
                                         const float* kxz, const float* mu,
                                         const float* g_mean, const float* g_cov,
                                         float* dkzz, float* ds, float* dkxz, float* dmu,
                                         long long n, int k, float jitter, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define VNNGP_CASE(KV)                                                        \
  case KV:                                                                    \
    return launch_bwd<KV>(kzz, s, kxz, mu, g_mean, g_cov, dkzz, ds, dkxz, dmu, n, \
                          jitter, st);
  switch (k) {
    VNNGP_CASE(1) VNNGP_CASE(2) VNNGP_CASE(3) VNNGP_CASE(4)
    VNNGP_CASE(5) VNNGP_CASE(6) VNNGP_CASE(7) VNNGP_CASE(8)
    VNNGP_CASE(9) VNNGP_CASE(10) VNNGP_CASE(11) VNNGP_CASE(12)
    VNNGP_CASE(13) VNNGP_CASE(14) VNNGP_CASE(15) VNNGP_CASE(16)
  }
#undef VNNGP_CASE
  return (int)cudaErrorInvalidValue;
}

// The backward's grid for n points at this K on the current device, into
// out[0..3]: points a warp, the grid, the instance's blocks an SM, the SM
// count. 0, or a CUDA error.
extern "C" int block_conditional_bwd_plan(long long n, int k, long long* out) {
  long long grid[3];
  int err = (int)cudaErrorInvalidValue, points = 0;
#define VNNGP_PLAN(KV)                  \
  case KV:                              \
    err = bwd_grid<KV>(n, grid);        \
    points = Rows<KV>::POINTS;          \
    break;
  switch (k) {
    VNNGP_PLAN(1) VNNGP_PLAN(2) VNNGP_PLAN(3) VNNGP_PLAN(4)
    VNNGP_PLAN(5) VNNGP_PLAN(6) VNNGP_PLAN(7) VNNGP_PLAN(8)
    VNNGP_PLAN(9) VNNGP_PLAN(10) VNNGP_PLAN(11) VNNGP_PLAN(12)
    VNNGP_PLAN(13) VNNGP_PLAN(14) VNNGP_PLAN(15) VNNGP_PLAN(16)
  }
#undef VNNGP_PLAN
  if (err != 0) return err;
  out[0] = points, out[1] = grid[0], out[2] = grid[1], out[3] = grid[2];
  return 0;
}
