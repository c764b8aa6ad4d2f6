// Triangular contraction c = Lu^T a for the NSF posterior variance, f32.
//
// Replaces gpzoo_tpu/ops/tri_pallas.py:
//   tri_sq_colsum_fused (_fused_impl)  -> tri_sq_colsum_f32
//       out[l, b] = sum_m (sum_{k>=m} Lu[l, k, m] a[k, b])^2
//   tri_t_matmul (_fwd_impl)           -> tri_t_matmul_f32
//       c[l, m, b] = sum_{k>=m} Lu[l, k, m] a[k, b]
// Lu (L, M, M) row-major, read as structurally lower-triangular (entries
// with k < m are never read); a row-major, factor l's (M, B) slab at
// a + l * a_stride: a_stride 0 shares one (M, B) a across all L (the
// north-star projection), a_stride M*B reads a per-factor (L, M, B) a (the
// MGGP W-form step's a = W Kzx).
//
// What bounds it on an H100: arithmetic. At the main-path shape (L=20,
// M=3000, B=7000) the triangle is 1.26e12 FLOP against 0.8 GB of operands
// (and 1.68 GB of c written by tri_t_matmul), far above the card's
// FLOP-per-byte balance, so both kernels are limited by the f32 FMA rate
// (67 TFLOP/s without tensor cores) and by how many shared-memory loads
// feed each FMA.
//
// What the design does about it:
//  * Both kernels share one tile product: a 64x64 (m, b) output tile per
//    block of 256 threads, each thread holding a 4x4 register sub-tile
//    (rows and columns strided by 16, so shared-memory reads are
//    broadcast or conflict-free), k in steps of 16 staged in shared memory.
//  * The k loop of a tile starts at its first row m0: tiles above the
//    diagonal are never visited, half the dense FLOPs. Inside the diagonal
//    tile the Lu load masks k < m, so Lu's strict upper triangle is never
//    read. The same masks zero the ragged M and B edges.
//  * Lu is read as Lu^T: a tile row k is Lu[l, k, m0:m0+64], contiguous
//    along m, so the loads coalesce without a transpose.
//  * tri_sq_colsum: the TPU kernel carries the column sum across its
//    sequential grid; Hopper blocks run in no order, so each block owns one
//    (l, 64-column) strip and loops over every m tile itself, squaring and
//    summing each finished c tile in registers. c never reaches device
//    memory, no atomics are used, and the result is the same on every run.
//    About 20 * ceil(7000/64) = 2,200 blocks keep the 132 SMs busy.
//  * Offsets into Lu, a and c are 64-bit: L*M*B is 4.2e8 elements.
// Not yet done: bf16 operands on wgmma, TMA loads and a ring of stages.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;       // rows m per output tile
constexpr int TB = 64;       // columns b per output tile
constexpr int TK = 16;       // k depth staged per step
constexpr int THREADS = 256; // 16 x 16 threads
constexpr int R = 4;         // register sub-tile per thread is R x R
static_assert(TM == TB, "the staging loop loads both tiles with one index");
static_assert(TM == 16 * R && TB == 16 * R, "16 threads per tile side");

// acc[i][j] += sum_{k >= m, k < M} lu[k, m] * a[k, b] for the thread's
// rows m = m0 + ty + 16 i and columns b = b0 + tx + 16 j.
__device__ __forceinline__ void tile_product(
    const float* __restrict__ lu, const float* __restrict__ a, int M, int B,
    int m0, int b0, float (*lu_s)[TM], float (*a_s)[TB], float acc[R][R]) {
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  for (int k0 = m0; k0 < M; k0 += TK) {
#pragma unroll
    for (int r = 0; r < (TK * TM) / THREADS; ++r) {
      const int idx = t + r * THREADS;
      const int kk = idx / TM, col = idx % TM;
      const int k = k0 + kk;
      const int m = m0 + col, b = b0 + col;
      // k >= m also keeps m < M, since k < M
      lu_s[kk][col] = (k < M && k >= m) ? lu[(int64_t)k * M + m] : 0.f;
      a_s[kk][col] = (k < M && b < B) ? a[(int64_t)k * B + b] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float lv[R], av[R];
#pragma unroll
      for (int i = 0; i < R; ++i) lv[i] = lu_s[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < R; ++j) av[j] = a_s[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) acc[i][j] = fmaf(lv[i], av[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
tri_t_matmul_kernel(const float* __restrict__ lu, const float* __restrict__ a,
                    float* __restrict__ c, int M, int B, int64_t a_stride) {
  __shared__ float lu_s[TK][TM];
  __shared__ float a_s[TK][TB];
  const int l = blockIdx.z, m0 = blockIdx.y * TM, b0 = blockIdx.x * TB;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[R][R] = {};
  tile_product(lu + (int64_t)l * M * M, a + l * a_stride, M, B, m0, b0, lu_s,
               a_s, acc);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int b = b0 + tx + 16 * j;
      if (b < B) c[((int64_t)l * M + m) * B + b] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
tri_sq_colsum_kernel(const float* __restrict__ lu, const float* __restrict__ a,
                     float* __restrict__ out, int M, int B, int64_t a_stride) {
  __shared__ float lu_s[TK][TM];
  __shared__ float a_s[TK][TB];
  __shared__ float red[16][TB];
  const int l = blockIdx.y, b0 = blockIdx.x * TB;
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const float* lu_l = lu + (int64_t)l * M * M;
  const float* a_l = a + l * a_stride;
  float col[R] = {};
  for (int m0 = 0; m0 < M; m0 += TM) {
    float acc[R][R] = {};
    tile_product(lu_l, a_l, M, B, m0, b0, lu_s, a_s, acc);
    // rows m >= M hold exact zeros (their Lu loads were masked)
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) col[j] = fmaf(acc[i][j], acc[i][j], col[j]);
  }
#pragma unroll
  for (int j = 0; j < R; ++j) red[ty][tx + 16 * j] = col[j];
  __syncthreads();
  if (t < TB) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < 16; ++r) s += red[r][t];
    const int b = b0 + t;
    if (b < B) out[(int64_t)l * B + b] = s;
  }
}

}  // namespace

extern "C" int tri_t_matmul_f32(const float* lu, const float* a, float* c,
                                int L, int M, int B, long long a_stride,
                                void* stream) {
  dim3 grid((B + TB - 1) / TB, (M + TM - 1) / TM, L);
  tri_t_matmul_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(lu, a, c, M, B,
                                                                   a_stride);
  return (int)cudaGetLastError();
}

extern "C" int tri_sq_colsum_f32(const float* lu, const float* a, float* out,
                                 int L, int M, int B, long long a_stride,
                                 void* stream) {
  dim3 grid((B + TB - 1) / TB, L);
  tri_sq_colsum_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(lu, a, out, M, B,
                                                                    a_stride);
  return (int)cudaGetLastError();
}
