// Batched dense GEMM — C[s] = A[s] B[s] for every matrix of a batch, the
// cuBLAS gemmBatched analogue the paper measures against (§V-A).
//
// Replaces the TPU kernel src/repro/kernels/batched_gemm.py (batched_gemm /
// _kernel, the pallas_gemm registry entry and dense_batched_matmul), one
// MXU dot per (matrix x column panel) with the whole K dimension in VMEM.
//
// What bounds it on an H100: bytes at the paper's sizes. A (m x k), B
// (k x n) and C (m x n) per matrix are each touched once: at Tox21 (512
// stacked 56 x 56 adjacencies, n 64) 21 MB, 6.3 us at 3.35 TB/s, against
// 2 m k n = 205 MFLOP, 3.1 us at the 67 TFLOP/s f32 peak. The product runs
// in f32 FMAs (no TF32), because the reference accumulates in f32 and is
// held to the f32 tolerance.
//
// Design: one block per (matrix x column panel), grid (batch, p), the
// paper's batching. The block stages the whole A tile (m x k) and its B
// panel (k x n_block) in shared memory with coalesced loads (27 KB at
// Tox21), then each thread keeps an 8-row x 4-column tile of C in
// registers: a warp spans 32 columns (neighbouring lanes on neighbouring
// B addresses, no bank conflict) and the 8 warps 8 row groups; each A
// element is one broadcast load for the warp. K runs in order, so the sum
// has one fixed order and the result is bitwise repeatable. The ragged
// panel edge and the rows past m are masked.
//
// Large-matrix entry (batched_gemm_large_f32), where the whole A tile and a
// 32-column B panel do not fit a block (core/batching.plan_batched_gemm's
// case 3, from m = k ~ 226): K-tiled. A block owns a 64-row x n_block
// (<= 128) tile of C, kept in registers as above (8 rows x 4 columns a
// thread), over a grid of (batch, row tiles, column panels); K runs in
// slabs of 32: the A slab (64 x 32) and the B slab (32 x n_block) pass
// through shared memory (24 KB). K still runs in order in one fmaf chain
// per output, so the result is the same sum as the batched entry's, and
// bitwise repeatable. The reference's plan has no case 3 and its kernel
// runs at every size (src/repro/core/batching.py plan_batched_gemm). The
// batched entry stays for the shapes it takes: on one H100 (700 W) the
// K-tiled entry took as long at Tox21 serving and 8% longer at Reaction100
// layer 2 (chip_smoke.py's [fork] lines, PERF.md).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 32;                     // threads along the columns
constexpr int kRowGroups = kThreads / kLanes;  // threads along the rows
constexpr int kCols = 4;                       // columns per thread
constexpr int kRows = 8;                       // rows per thread and pass

__global__ void __launch_bounds__(kThreads)
gemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
            float* __restrict__ c, int m, int k, int n, int n_block) {
  extern __shared__ float smem[];
  float* as = smem;          // (m, k) A tile
  float* bs = as + m * k;    // (k, nbw) B panel
  const int s = blockIdx.x;
  const int col0 = blockIdx.y * n_block;
  const int nbw = min(n_block, n - col0);
  const int tid = threadIdx.x;

  const float* asrc = a + static_cast<size_t>(s) * m * k;
  for (int i = tid; i < m * k; i += kThreads) as[i] = asrc[i];
  const float* bsrc = b + static_cast<size_t>(s) * k * n + col0;
  for (int i = tid; i < k * nbw; i += kThreads) {
    const int kk = i / nbw, cc = i - kk * nbw;
    bs[i] = bsrc[static_cast<size_t>(kk) * n + cc];
  }
  __syncthreads();

  const int tx = tid % kLanes, ty = tid / kLanes;
  float* cdst = c + static_cast<size_t>(s) * m * n + col0;
  for (int r0 = 0; r0 < m; r0 += kRowGroups * kRows) {
    float acc[kRows][kCols];
    const float* ar[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      ar[i] = as + min(r0 + ty + kRowGroups * i, m - 1) * k;
#pragma unroll
      for (int q = 0; q < kCols; ++q) acc[i][q] = 0.f;
    }
    for (int kk = 0; kk < k; ++kk) {
      float bv[kCols];
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const int cc = tx + kLanes * q;
        bv[q] = cc < nbw ? bs[kk * nbw + cc] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float av = ar[i][kk];
#pragma unroll
        for (int q = 0; q < kCols; ++q) acc[i][q] = fmaf(av, bv[q], acc[i][q]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = r0 + ty + kRowGroups * i;
      if (r >= m) continue;
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const int cc = tx + kLanes * q;
        if (cc < nbw) cdst[static_cast<size_t>(r) * n + cc] = acc[i][q];
      }
    }
  }
}

}  // namespace

extern "C" int batched_gemm_f32(const float* a, const float* b, float* c,
                                int batch, int m, int k, int n, int n_block,
                                void* stream) {
  if (n_block < 1 || n_block > kLanes * kCols || m < 1 || k < 1)
    return cudaErrorInvalidValue;
  const size_t smem =
      (static_cast<size_t>(m) * k + static_cast<size_t>(k) * n_block) *
      sizeof(float);
  cudaError_t e = repro::allow_smem(gemm_kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(batch, (n + n_block - 1) / n_block);
  gemm_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a, b, c, m, k, n, n_block);
  return cudaGetLastError();
}

namespace {

constexpr int kTileM = kRowGroups * kRows;   // rows of C per block (64)
constexpr int kSlab = 32;                    // K per shared-memory slab

__global__ void __launch_bounds__(kThreads)
gemm_large_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ c, int m, int k, int n, int n_block) {
  __shared__ float as[kTileM][kSlab];        // A slab, rows x K
  __shared__ float bs[kSlab][kLanes * kCols];   // B slab, K x panel
  const int s = blockIdx.x;
  const int r0 = blockIdx.y * kTileM;
  const int col0 = blockIdx.z * n_block;
  const int nbw = min(n_block, n - col0);
  const int tid = threadIdx.x, tx = tid % kLanes, ty = tid / kLanes;
  const float* asrc = a + (static_cast<size_t>(s) * m + r0) * k;
  const float* bsrc = b + static_cast<size_t>(s) * k * n + col0;

  float acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int q = 0; q < kCols; ++q) acc[i][q] = 0.f;
  for (int k0 = 0; k0 < k; k0 += kSlab) {
    const int kn = min(kSlab, k - k0);
    for (int i = tid; i < kTileM * kSlab; i += kThreads) {
      const int r = i / kSlab, kk = i - r * kSlab;
      as[r][kk] = r0 + r < m && kk < kn
                      ? asrc[static_cast<size_t>(r) * k + k0 + kk]
                      : 0.f;
    }
    for (int i = tid; i < kSlab * nbw; i += kThreads) {
      const int kk = i / nbw, cc = i - kk * nbw;
      bs[kk][cc] =
          kk < kn ? bsrc[static_cast<size_t>(k0 + kk) * n + cc] : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < kn; ++kk) {
      float bv[kCols];
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const int cc = tx + kLanes * q;
        bv[q] = cc < nbw ? bs[kk][cc] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float av = as[ty + kRowGroups * i][kk];
#pragma unroll
        for (int q = 0; q < kCols; ++q) acc[i][q] = fmaf(av, bv[q], acc[i][q]);
      }
    }
    __syncthreads();
  }

  float* cdst = c + static_cast<size_t>(s) * m * n + col0;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = r0 + ty + kRowGroups * i;
    if (r >= m) continue;
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const int cc = tx + kLanes * q;
      if (cc < nbw) cdst[static_cast<size_t>(r) * n + cc] = acc[i][q];
    }
  }
}

}  // namespace

// n_block is capped at 128; m and k are unbounded (grid.y = ceil(m / 64)
// up to 65535 row tiles)
extern "C" int batched_gemm_large_f32(const float* a, const float* b,
                                      float* c, int batch, int m, int k,
                                      int n, int n_block, void* stream) {
  const int panel = min(n_block, kLanes * kCols);
  if (panel < 1 || m < 1 || k < 1 || (m + kTileM - 1) / kTileM > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(batch, (m + kTileM - 1) / kTileM, (n + panel - 1) / panel);
  gemm_large_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, c, m, k, n, panel);
  return cudaGetLastError();
}
