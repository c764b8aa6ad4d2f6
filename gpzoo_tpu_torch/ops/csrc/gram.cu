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
