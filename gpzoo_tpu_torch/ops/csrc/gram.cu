// L-batched RBF Gram from raw coordinates, f32.
//
// Replaces gpzoo_tpu/ops/gram_pallas.py: rbf_gram (_rbf_gram_fwd_impl)
//   out[l, n, m] = sigma2[l] * exp(scale[l] * ||x_n - z_m||^2),
//   scale[l] = -1/2 / lengthscale[l]^2;  x (N, D), z (M, D), D <= 8.
//
// What bounds it on an H100: the write of the (L, N, M) result. At the
// main-path Kzx (1 x 3000 x 45,000) that is 540 MB against a few hundred
// KB of coordinates and ~D+2 FLOP per element plus one expf, so the
// kernel is limited by device-memory bandwidth (3.35 TB/s: ~0.16 ms).
//
// What the design does about it: each output element is written exactly
// once and nothing else goes to device memory. The squared distance is
// formed directly from the coordinates in registers (no N x M distance
// matrix as in the expanded ||x||^2 - 2 x.z + ||z||^2 form) and all L
// epilogues are applied while it is there. A block stages 32 rows of x
// and 64 rows of z in shared memory; threads along m write neighbouring
// addresses, so every store is coalesced. Output offsets are 64-bit.
// The direct distance differs from the plain expanded form only by
// rounding near d = 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TN = 32;     // rows n per block
constexpr int TMC = 64;    // columns m per block (blockDim.x)
constexpr int TY = 4;      // blockDim.y; each thread covers TN / TY rows
constexpr int MAXD = 8;

__global__ void __launch_bounds__(TMC * TY)
rbf_gram_kernel(const float* __restrict__ x, const float* __restrict__ z,
                const float* __restrict__ sigma2, const float* __restrict__ scale,
                float* __restrict__ out, int N, int M, int D, int L) {
  __shared__ float x_s[TN][MAXD];
  __shared__ float z_s[MAXD][TMC];
  const int n0 = blockIdx.y * TN, m0 = blockIdx.x * TMC;
  const int t = threadIdx.y * TMC + threadIdx.x;
  for (int idx = t; idx < TMC * D; idx += TMC * TY) {
    const int mm = idx / D, d = idx % D, m = m0 + mm;
    z_s[d][mm] = m < M ? z[(int64_t)m * D + d] : 0.f;
  }
  for (int idx = t; idx < TN * D; idx += TMC * TY) {
    const int nn = idx / D, d = idx % D, n = n0 + nn;
    x_s[nn][d] = n < N ? x[(int64_t)n * D + d] : 0.f;
  }
  __syncthreads();
  const int m = m0 + threadIdx.x;
  if (m >= M) return;
  for (int nn = threadIdx.y; nn < TN; nn += TY) {
    const int n = n0 + nn;
    if (n >= N) break;
    float d2 = 0.f;
    for (int d = 0; d < D; ++d) {
      const float diff = x_s[nn][d] - z_s[d][threadIdx.x];
      d2 = fmaf(diff, diff, d2);
    }
    for (int l = 0; l < L; ++l)
      out[((int64_t)l * N + n) * M + m] = sigma2[l] * expf(scale[l] * d2);
  }
}

}  // namespace

extern "C" int rbf_gram_f32(const float* x, const float* z, const float* sigma2,
                            const float* scale, float* out, int N, int M, int D,
                            int L, void* stream) {
  if (D < 1 || D > MAXD) return (int)cudaErrorInvalidValue;
  dim3 block(TMC, TY);
  dim3 grid((M + TMC - 1) / TMC, (N + TN - 1) / TN);
  rbf_gram_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(x, z, sigma2, scale,
                                                             out, N, M, D, L);
  return (int)cudaGetLastError();
}
