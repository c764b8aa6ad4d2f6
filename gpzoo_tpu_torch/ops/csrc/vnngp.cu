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
// 3.35 TB/s.
// What the design does about it: the forward's layout. One thread a point,
// one warp of 32 points a block, the four inputs brought in by cp.async
// into element-major rows of stride LD (kzz, kxz and mu first, then s),
// the factor, w, v and the cotangents in registers. Each lane then writes
// its point's dkzz, ds, dkxz and dmu over its own column of the same
// shared rows, and the warp copies them out record by record, so that
// consecutive lanes store consecutive words (coalesced), as the loads
// were. Only the outputs asked for (non-null) are written. Registers: 72
// at K = 8, 168 at K = 15, 249 at K = 16, no spills.

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

// The inverse of stage_async: the block's element-major buffer src back to
// `count` contiguous ROWS-element records at dst, consecutive lanes storing
// consecutive words.
template <int ROWS>
__device__ __forceinline__ void unstage(float* __restrict__ dst, const float* src,
                                        int count, int lane) {
  for (int i = lane; i < count * ROWS; i += WARP) {
    const int t = i / ROWS;
    dst[i] = src[(i - t * ROWS) * LD + t];
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

template <int K>
__global__ void __launch_bounds__(WARP)
block_conditional_bwd_kernel(const float* __restrict__ kzz, const float* __restrict__ s,
                             const float* __restrict__ kxz, const float* __restrict__ mu,
                             const float* __restrict__ g_mean,
                             const float* __restrict__ g_cov, float* __restrict__ dkzz,
                             float* __restrict__ ds, float* __restrict__ dkxz,
                             float* __restrict__ dmu, long long n, float jitter) {
  using S = Shape<K>;
  extern __shared__ float kzz_s[];  // then s, kxz, mu; dkzz, ds, dkxz, dmu after
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
  const float gm = active ? g_mean[p] : 0.f;
  const float gc = active ? g_cov[p] : 0.f;
  const float* blk = kzz_s + lane;  // element e of this lane's point: blk[e * LD]
  const float* sblk = s_s + lane;

  asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // kzz, kxz, mu
  __syncwarp();
  float l[K][K];
  float inv_diag[K];
  float w[K];
  if (active) {
    cholesky<K>(blk, jitter, l, inv_diag);
    float b[K];
#pragma unroll
    for (int i = 0; i < K; ++i) b[i] = kxz_s[i * LD + lane];
    chol_solve<K>(l, inv_diag, b, w);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // s
  __syncwarp();
  if (active) {
    // dw = gm mu + gc (diff + diff^T) w, diff + diff^T = s + s^T - kzz - kzz^T - 2 jitter I
    float dw[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      float acc = -2.f * jitter * w[i];
#pragma unroll
      for (int j = 0; j < K; ++j)
        acc = fmaf(sblk[(i * K + j) * LD] + sblk[(j * K + i) * LD] - blk[(i * K + j) * LD] -
                       blk[(j * K + i) * LD],
                   w[j], acc);
      dw[i] = fmaf(gm, mu_s[i * LD + lane], gc * acc);
    }
    float v[K];
    chol_solve<K>(l, inv_diag, dw, v);
    // each lane over its own column of the shared rows: no lane reads another's
#pragma unroll
    for (int i = 0; i < K; ++i) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float gww = gc * w[i] * w[j];
        if (dkzz != nullptr)
          kzz_s[(i * K + j) * LD + lane] = -0.5f * fmaf(v[i], w[j], w[i] * v[j]) - gww;
        if (ds != nullptr) s_s[(i * K + j) * LD + lane] = gww;
      }
      kxz_s[i * LD + lane] = v[i];
      mu_s[i * LD + lane] = gm * w[i];
    }
  }
  __syncwarp();
  if (dkzz != nullptr) unstage<S::KK>(dkzz + p0 * S::KK, kzz_s, count, lane);
  if (ds != nullptr) unstage<S::KK>(ds + p0 * S::KK, s_s, count, lane);
  if (dkxz != nullptr) unstage<K>(dkxz + p0 * K, kxz_s, count, lane);
  if (dmu != nullptr) unstage<K>(dmu + p0 * K, mu_s, count, lane);
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

template <int K>
int launch_bwd(const float* kzz, const float* s, const float* kxz, const float* mu,
               const float* g_mean, const float* g_cov, float* dkzz, float* ds, float* dkxz,
               float* dmu, long long n, float jitter, cudaStream_t stream) {
  const long long blocks = grid_of(n);
  if (blocks < 0) return (int)cudaErrorInvalidValue;
  static bool asked = false;
  const int err = ask_smem(block_conditional_bwd_kernel<K>, Shape<K>::SMEM, &asked);
  if (err != 0) return err;
  block_conditional_bwd_kernel<K><<<(unsigned)blocks, WARP, Shape<K>::SMEM, stream>>>(
      kzz, s, kxz, mu, g_mean, g_cov, dkzz, ds, dkxz, dmu, n, jitter);
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
