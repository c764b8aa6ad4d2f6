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
// What bounds it on an H100: device memory. At K = 8 a point reads
// (2*64 + 2*8 + 1) * 4 = 580 B and writes 8 B for ~550 FLOP, about one
// FLOP per byte against the card's ~20 FLOP/B f32 balance (67 TFLOP/s over
// 3.35 TB/s). At the posterior's n = 1,000,000 that is 588 MB, 0.18 ms at
// full bandwidth; at a training step's n = 5,000 (2.9 MB) the launch
// itself costs more than the bytes.
//
// What the design does about it:
//  * One thread per point, K a template parameter (1..16), every loop
//    unrolled, so the Cholesky factor, the two substitutions and w stay in
//    registers and nothing but mean and cov is written.
//  * The (K, K) blocks are 256 B apart at K = 8, so a thread reading its
//    own block would stride the warp's loads. A block of P points instead
//    copies its P contiguous blocks of kzz into shared memory with
//    neighbouring threads on neighbouring addresses (coalesced), factors
//    them, then reuses the same buffer for s. Each point's row in the
//    buffer is padded to K*K + 1 words (odd), so the 32 threads of a warp
//    read 32 different banks.
//  * P = 128 points for K <= 8 and 32 for K > 8 keeps the buffer at
//    about 32 KB of static shared memory.
//  * Offsets into the (n, K, K) arrays are 64-bit: n*K*K reaches 6.4e7 at
//    the posterior shape and passes 2^31 for a larger N or L.
// Register use (nvcc -Xptxas -v, sm_90a; chip_smoke.py prints it): 94
// registers and no spills at K = 8; K = 15 and K = 16 reach the 255-register
// cap and spill 12 B and 96 B a thread to local memory (the 136-entry
// factor at K = 16); K <= 14 spills nothing.
// Not yet done: fusing the block gathers into the kernel (reading Kzz and
// S by neighbour index instead of the caller's materialized (n, K, K)
// copies), more points per block at K > 8, and more loads in flight per
// thread in the staging copy when few blocks run (n = 5,000 fills 40 of
// 132 SMs).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int K>
struct Shape {
  static constexpr int P = K <= 8 ? 128 : 32;  // points (threads) per block
  static constexpr int KK = K * K;
  static constexpr int STRIDE = KK + 1;        // odd: conflict-free rows
};

// Copies `count` contiguous (K, K) blocks starting at src into buf, one
// padded row per point, with consecutive threads on consecutive addresses.
template <int K>
__device__ __forceinline__ void stage(float* buf, const float* __restrict__ src,
                                     int count) {
  using S = Shape<K>;
  for (int i = threadIdx.x; i < count * S::KK; i += S::P)
    buf[(i / S::KK) * S::STRIDE + i % S::KK] = src[i];
}

template <int K>
__global__ void __launch_bounds__(Shape<K>::P)
block_conditional_kernel(const float* __restrict__ kzz, const float* __restrict__ s,
                         const float* __restrict__ kxz, const float* __restrict__ mu,
                         const float* __restrict__ kxx, float* __restrict__ mean_out,
                         float* __restrict__ cov_out, long long n, float jitter) {
  using S = Shape<K>;
  __shared__ float buf[S::P * S::STRIDE];
  const long long p0 = (long long)blockIdx.x * S::P;
  const int count = (int)(n - p0 < S::P ? n - p0 : S::P);
  const int t = threadIdx.x;
  const bool active = t < count;
  const long long p = p0 + t;
  const float* blk = buf + t * S::STRIDE;

  stage<K>(buf, kzz + p0 * S::KK, count);
  __syncthreads();

  float w[K];
  float neg_bw[K];  // -(B w)_j, the subtracted half of w (s - B)
  float mean = 0.f;
  if (active) {
    // Cholesky of B = kzz + jitter I, lower triangle, row by row.
    float l[K][K];
    float inv_diag[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        float acc = blk[i * K + j];
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
    // w = B^-1 kxz: forward then back substitution.
    const float* kxz_p = kxz + p * K;
    float y[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      float acc = kxz_p[i];
#pragma unroll
      for (int k = 0; k < i; ++k) acc -= l[i][k] * y[k];
      y[i] = acc * inv_diag[i];
    }
#pragma unroll
    for (int i = K - 1; i >= 0; --i) {
      float acc = y[i];
#pragma unroll
      for (int k = i + 1; k < K; ++k) acc -= l[k][i] * w[k];
      w[i] = acc * inv_diag[i];
    }
    const float* mu_p = mu + p * K;
#pragma unroll
    for (int i = 0; i < K; ++i) mean = fmaf(w[i], mu_p[i], mean);
    // -(B w)_j from the kzz block still in shared memory
#pragma unroll
    for (int j = 0; j < K; ++j) {
      float acc = -jitter * w[j];
#pragma unroll
      for (int k = 0; k < K; ++k) acc -= w[k] * blk[k * K + j];
      neg_bw[j] = acc;
    }
  }
  __syncthreads();  // every thread is done with kzz: the buffer takes s
  stage<K>(buf, s + p0 * S::KK, count);
  __syncthreads();
  if (!active) return;
  float quad = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    float wd = neg_bw[j];
#pragma unroll
    for (int k = 0; k < K; ++k) wd = fmaf(w[k], blk[k * K + j], wd);
    quad = fmaf(wd, w[j], quad);
  }
  mean_out[p] = mean;
  cov_out[p] = kxx[p] + quad;
}

template <int K>
int launch(const float* kzz, const float* s, const float* kxz, const float* mu,
           const float* kxx, float* mean, float* cov, long long n, float jitter,
           cudaStream_t stream) {
  const long long blocks = (n + Shape<K>::P - 1) / Shape<K>::P;
  if (n < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  block_conditional_kernel<K><<<(unsigned)blocks, Shape<K>::P, 0, stream>>>(
      kzz, s, kxz, mu, kxx, mean, cov, n, jitter);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int block_conditional_f32(const float* kzz, const float* s,
                                     const float* kxz, const float* mu,
                                     const float* kxx, float* mean, float* cov,
                                     long long n, int k, float jitter,
                                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define VNNGP_CASE(KV) \
  case KV:             \
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
