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
// to be written.
// What the design does about it:
//  * Each of 256 threads owns BWD_ROWS = 4 rows by VEC neighbouring columns
//    (VEC 4, 2 or 1 as M allows 16-, 8- or 4-byte loads) of a strip of
//    BWD_TX * VEC columns; BWD_TY = 4 thread-rows make a row group of 16
//    rows, and a block walks `chunks` row groups of one strip. g and k are
//    read once, with streaming vector loads, all the rows of a factor
//    issued before they are used. d2 is formed once a pair from the
//    coordinates in registers (D <= 8), as in the forward.
//  * w stays in registers across the factors; no plane is written. The
//    per-factor sums of gk and gk d2 are reduced over each warp by
//    shuffles and over the block in shared memory, one partial a row group
//    and factor. dx's partial sums over the strip (shuffles, then the two
//    warps of a thread-row) go out once a row group; dz's sums stay in
//    registers across the block's row groups and are reduced over its four
//    thread-rows once, at the end: one partial a block.
//  * A second small kernel sums every partial in double in a fixed order
//    (eight interleaved slices of the partials, then the slices in order),
//    so that the result does not depend on the order blocks run in: no
//    atomics, and two runs give the same bits.
//  * The entry owns the plan: `chunks` is as large as keeps ~4 blocks a
//    SM, which keeps dz's partials (one (M, D) slab a block row) small
//    beside g and k.
// Registers (nvcc -Xptxas -v, sm_90a): 124 for the paths' main instance
// (D = 2, VEC = 4), 78 at D = 2, VEC = 1 (M = 529), 225 at D = 8, VEC = 4;
// a few D >= 3 instances with VEC = 1 or 2 spill 16-24 bytes.

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
constexpr int BWD_BLOCKS_PER_SM = 4;
constexpr int SLICES = 8;                     // interleaved slices of the final sums

template <int VEC>
__device__ __forceinline__ void load_cs(float (&dst)[VEC], const float* src) {
  if constexpr (VEC == 4) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(src));
    dst[0] = v.x, dst[1] = v.y, dst[2] = v.z, dst[3] = v.w;
  } else if constexpr (VEC == 2) {
    const float2 v = __ldcs(reinterpret_cast<const float2*>(src));
    dst[0] = v.x, dst[1] = v.y;
  } else {
    dst[0] = __ldcs(src);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Partials: pdx (strips, N, D) where dx is wanted, pdz (blocks / strips, M,
// D) where dz is, phyper (2, L, n_parts) where dsigma or dell is, n_parts =
// gridDim.x * chunks, row group r of strip s at r * strips + s.
template <int D, int VEC>
__global__ void __launch_bounds__(THREADS)
rbf_gram_bwd_kernel(const float* __restrict__ g, const float* __restrict__ k,
                    const float* __restrict__ x, const float* __restrict__ z,
                    const float* __restrict__ lengthscale, float* __restrict__ pdx,
                    float* __restrict__ pdz, float* __restrict__ phyper, int N, int M,
                    int L, int strips, int chunks) {
  __shared__ float part[LC][2][WARPS];
  __shared__ float sdx[WARPS][BWD_ROWS][D];
  __shared__ float sdz[BWD_TY][VEC][D][BWD_TX];
  const int strip = blockIdx.x % strips, tile = blockIdx.x / strips;
  const int tx = threadIdx.x % BWD_TX, ty = threadIdx.x / BWD_TX;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = (strip * BWD_TX + tx) * VEC;
  const bool col_live = m0 < M;  // VEC divides M: all VEC columns exist
  const int64_t plane = (int64_t)N * M;
  const int64_t n_parts = (int64_t)gridDim.x * chunks;
  float zr[VEC][D], dz_acc[VEC][D];
#pragma unroll
  for (int v = 0; v < VEC; ++v)
#pragma unroll
    for (int d = 0; d < D; ++d) {
      zr[v][d] = col_live ? __ldg(z + (int64_t)(m0 + v) * D + d) : 0.f;
      dz_acc[v][d] = 0.f;
    }
  for (int c = 0; c < chunks; ++c) {
    const int group = tile * chunks + c;
    const int n0 = group * GROUP_ROWS + ty * BWD_ROWS;
    float xr[BWD_ROWS][D], d2[BWD_ROWS][VEC], w[BWD_ROWS][VEC];
    bool live[BWD_ROWS];
#pragma unroll
    for (int r = 0; r < BWD_ROWS; ++r) {
      live[r] = col_live && n0 + r < N;
#pragma unroll
      for (int d = 0; d < D; ++d) xr[r][d] = n0 + r < N ? __ldg(x + (int64_t)(n0 + r) * D + d) : 0.f;
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
    for (int l = 0; l < L; ++l) {
      float gv[BWD_ROWS][VEC], kv[BWD_ROWS][VEC];
#pragma unroll
      for (int r = 0; r < BWD_ROWS; ++r) {
        const int64_t at = l * plane + (int64_t)(n0 + r) * M + m0;
        if (live[r]) {
          load_cs<VEC>(gv[r], g + at);
          load_cs<VEC>(kv[r], k + at);
        } else {
#pragma unroll
          for (int v = 0; v < VEC; ++v) gv[r][v] = kv[r][v] = 0.f;
        }
      }
      const float ell = __ldg(lengthscale + l);
      const float inv_ell2 = 1.f / (ell * ell);
      float s_gk = 0.f, s_gkd2 = 0.f;
#pragma unroll
      for (int r = 0; r < BWD_ROWS; ++r)
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const float gk = gv[r][v] * kv[r][v];
          s_gk += gk;
          s_gkd2 = fmaf(gk, d2[r][v], s_gkd2);
          w[r][v] = fmaf(gk, inv_ell2, w[r][v]);
        }
      if (phyper != nullptr) {
        s_gk = warp_sum(s_gk);
        s_gkd2 = warp_sum(s_gkd2);
        const int slot = l % LC;
        if (lane == 0) {
          part[slot][0][warp] = s_gk;
          part[slot][1][warp] = s_gkd2;
        }
        if (slot == LC - 1 || l == L - 1) {
          __syncthreads();
          const int l0 = l - slot;
          for (int i = threadIdx.x; i < 2 * (slot + 1); i += THREADS) {
            const int kk = i / 2, q = i % 2;
            float sum = 0.f;
#pragma unroll
            for (int wp = 0; wp < WARPS; ++wp) sum += part[kk][q][wp];
            phyper[((int64_t)q * L + l0 + kk) * n_parts + part_at] = sum;
          }
          __syncthreads();
        }
      }
    }
    if (pdx != nullptr) {
      // dx[n] over this strip: the thread's columns, the warp, the thread-row's warps
#pragma unroll
      for (int r = 0; r < BWD_ROWS; ++r)
#pragma unroll
        for (int d = 0; d < D; ++d) {
          float acc = 0.f;
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc = fmaf(w[r][v], zr[v][d] - xr[r][d], acc);
          acc = warp_sum(live[r] ? acc : 0.f);
          if (lane == 0) sdx[warp][r][d] = acc;
        }
      __syncthreads();
      for (int i = threadIdx.x; i < GROUP_ROWS * D; i += THREADS) {
        const int row = i / D, d = i % D, n = group * GROUP_ROWS + row;
        if (n < N) {
          float sum = 0.f;
#pragma unroll
          for (int h = 0; h < ROW_WARPS; ++h)
            sum += sdx[(row / BWD_ROWS) * ROW_WARPS + h][row % BWD_ROWS][d];
          pdx[((int64_t)strip * N + n) * D + d] = sum;
        }
      }
      __syncthreads();
    }
    if (pdz != nullptr) {
#pragma unroll
      for (int r = 0; r < BWD_ROWS; ++r) {
        if (!live[r]) continue;
#pragma unroll
        for (int v = 0; v < VEC; ++v)
#pragma unroll
          for (int d = 0; d < D; ++d) dz_acc[v][d] = fmaf(w[r][v], xr[r][d] - zr[v][d], dz_acc[v][d]);
      }
    }
  }
  if (pdz != nullptr) {
    // dz[m] over the block's rows: the four thread-rows, in order
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
  }
}

// Blocks [0, hyper_blocks): block q * L + l sums phyper[q, l, :] in double
// (dsigma = 2 sum / sigma for q = 0, dell = sum / ell^3 for q = 1). The
// others: SLICES x 32 threads a block, 32 consecutive outputs of dx (N D,
// summed over `strips` slabs of pdx) then dz (M D, over `tiles` slabs of
// pdz), each slice summing every SLICES-th slab, then the slices in order.
__global__ void __launch_bounds__(THREADS)
rbf_gram_bwd_reduce_kernel(const float* __restrict__ pdx, int strips,
                           const float* __restrict__ pdz, int tiles,
                           const float* __restrict__ phyper, int64_t n_parts,
                           const float* __restrict__ sigma,
                           const float* __restrict__ lengthscale, float* __restrict__ dx,
                           float* __restrict__ dz, float* __restrict__ hyper, int64_t nx,
                           int64_t nz, int L, int hyper_blocks) {
  __shared__ double red[THREADS];
  if ((int)blockIdx.x < hyper_blocks) {
    const int q = blockIdx.x / L, l = blockIdx.x % L;
    const float* p = phyper + (int64_t)blockIdx.x * n_parts;
    double sum = 0.0;
    for (int64_t i = threadIdx.x; i < n_parts; i += THREADS) sum += (double)p[i];
    red[threadIdx.x] = sum;
    __syncthreads();
    for (int h = THREADS / 2; h > 0; h >>= 1) {
      if ((int)threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      const double v = red[0];
      const double ell = (double)lengthscale[l];
      hyper[(int64_t)q * L + l] =
          (float)(q == 0 ? 2.0 * v / (double)sigma[l] : v / (ell * ell * ell));
    }
    return;
  }
  const int slice = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t i = (int64_t)(blockIdx.x - hyper_blocks) * 32 + lane;
  const bool is_dx = i < nx;
  const int64_t j = is_dx ? i : i - nx;
  const float* src = is_dx ? pdx : pdz;
  const int64_t stride = is_dx ? nx : nz;
  const int count = is_dx ? strips : tiles;
  double sum = 0.0;
  if (j < stride)
    for (int t = slice; t < count; t += SLICES) sum += (double)src[t * stride + j];
  red[threadIdx.x] = sum;
  __syncthreads();
  if (slice == 0 && j < stride) {
    double total = 0.0;
#pragma unroll
    for (int t = 0; t < SLICES; ++t) total += red[t * 32 + lane];
    (is_dx ? dx : dz)[j] = (float)total;
  }
}

struct BwdPlan {
  int vec, strips, chunks, tiles;
  int64_t blocks, n_parts;
  int64_t floats;  // scratch: pdx, pdz, phyper
};

// The backward's plan; false for a shape it does not take.
bool bwd_plan(int N, int M, int D, int L, BwdPlan* p) {
  if (N < 1 || M < 1 || L < 1 || D < 1 || D > MAXD || N > INT_MAX_ - GROUP_ROWS ||
      M > INT_MAX_ - 4 * BWD_TX)
    return false;
  int device, sms;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return false;
  p->vec = M % 4 == 0 ? 4 : (M % 2 == 0 ? 2 : 1);
  p->strips = (int)((M + (int64_t)BWD_TX * p->vec - 1) / ((int64_t)BWD_TX * p->vec));
  const int64_t groups = (N + (int64_t)GROUP_ROWS - 1) / GROUP_ROWS;
  const int64_t chunks = groups * p->strips / ((int64_t)BWD_BLOCKS_PER_SM * sms);
  p->chunks = (int)(chunks < 1 ? 1 : (chunks > groups ? groups : chunks));
  p->tiles = (int)((groups + p->chunks - 1) / p->chunks);
  p->blocks = (int64_t)p->tiles * p->strips;
  p->n_parts = p->blocks * p->chunks;
  p->floats = (int64_t)p->strips * N * D + (int64_t)p->tiles * M * D + 2 * (int64_t)L * p->n_parts;
  return p->blocks <= INT_MAX_;
}

template <int VEC>
int launch_bwd(const float* g, const float* k, const float* x, const float* z,
               const float* sigma, const float* lengthscale, float* dx, float* dz,
               float* hyper, float* scratch, int N, int M, int D, int L, const BwdPlan& p,
               cudaStream_t st) {
  float* pdx = dx != nullptr ? scratch : nullptr;
  float* pdz = dz != nullptr ? scratch + (int64_t)p.strips * N * D : nullptr;
  float* phyper = hyper != nullptr ? scratch + (int64_t)p.strips * N * D +
                                         (int64_t)p.tiles * M * D
                                   : nullptr;
#define GRAM_BWD_CASE(DV)                                                      \
  case DV:                                                                     \
    rbf_gram_bwd_kernel<DV, VEC><<<(int)p.blocks, THREADS, 0, st>>>(            \
        g, k, x, z, lengthscale, pdx, pdz, phyper, N, M, L, p.strips, p.chunks); \
    break;
  switch (D) {
    GRAM_BWD_CASE(1) GRAM_BWD_CASE(2) GRAM_BWD_CASE(3) GRAM_BWD_CASE(4)
    GRAM_BWD_CASE(5) GRAM_BWD_CASE(6) GRAM_BWD_CASE(7) GRAM_BWD_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef GRAM_BWD_CASE
  int status = (int)cudaGetLastError();
  if (status != 0) return status;
  const int64_t nx = dx != nullptr ? (int64_t)N * D : 0;
  const int64_t nz = dz != nullptr ? (int64_t)M * D : 0;
  const int hyper_blocks = hyper != nullptr ? 2 * L : 0;
  const int64_t grid = hyper_blocks + (nx + nz + 31) / 32;
  if (grid == 0) return 0;
  if (grid > INT_MAX_) return (int)cudaErrorInvalidValue;
  rbf_gram_bwd_reduce_kernel<<<(int)grid, THREADS, 0, st>>>(
      pdx, p.strips, pdz, p.tiles, phyper, p.n_parts, sigma, lengthscale, dx, dz, hyper,
      nx, nz, L, hyper_blocks);
  return (int)cudaGetLastError();
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

// dx (N, D), dz (M, D) and hyper (2, L) = (dsigma, dell) for the cotangent
// g (L, N, M) and the forward's k (L, N, M), each written where it is not
// null; scratch holds rbf_gram_bwd_scratch(N, M, D, L) floats. Two
// launches: the pass over g and k, and the fixed-order sums.
extern "C" int rbf_gram_bwd_f32(const float* g, const float* k, const float* x,
                                const float* z, const float* sigma,
                                const float* lengthscale, float* dx, float* dz,
                                float* hyper, float* scratch, int N, int M, int D, int L,
                                void* stream) {
  BwdPlan p;
  if (!bwd_plan(N, M, D, L, &p) || scratch == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (p.vec) {
    case 4: return launch_bwd<4>(g, k, x, z, sigma, lengthscale, dx, dz, hyper, scratch, N,
                                 M, D, L, p, st);
    case 2: return launch_bwd<2>(g, k, x, z, sigma, lengthscale, dx, dz, hyper, scratch, N,
                                 M, D, L, p, st);
    default: return launch_bwd<1>(g, k, x, z, sigma, lengthscale, dx, dz, hyper, scratch, N,
                                  M, D, L, p, st);
  }
}
