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
