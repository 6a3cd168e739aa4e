// Batched dense GEMM — C[s] = A[s] B[s] for every matrix of a batch, the
// cuBLAS gemmBatched analogue the paper measures against (§V-A).
//
// Replaces the TPU kernel src/repro/kernels/batched_gemm.py (batched_gemm /
// _kernel, the pallas_gemm registry entry and dense_batched_matmul), one
// MXU dot per (matrix x column panel) with the whole K dimension in VMEM.
//
// What bounds it on an H100: at the paper's sizes, bytes. A (m x k), B
// (k x n) and C (m x n) per matrix are each touched once: at Tox21 (512
// stacked 56 x 56 adjacencies, n 64) 21 MB, 6.3 us at 3.35 TB/s, against
// 2 m k n = 205 MFLOP, 3.1 us at the 67 TFLOP/s f32 peak. Past a few
// hundred rows, operations: 2 x 9000 x 9000 x 64 is 20.7 GFLOP, 0.31 ms,
// against 0.19 ms for reading A once. The product runs in f32 FMAs (no
// TF32), because the reference accumulates in f32 and is held to the f32
// tolerance. What held the first design back (about 6 of 67 TFLOP/s on one
// H100 80GB HBM3 at 700 W): a 128-column thread tile half masked at n 64,
// scalar staging with an integer division per element, and one
// shared-memory load for every two FMAs.
//
// Design, one kernel at every size: a block owns a row tile of BM = TM x R
// rows of one matrix and a 64-column panel of C, kept in registers as TM
// rows x 4 columns a thread (16 threads along the panel, R <= 16 along the
// rows), with K streamed through the cp.async ring of gemm_tile.cuh (the
// mainloop this kernel shares with the grouped matmul: 16-, 8- or 4-byte
// copies by the rows' alignment, zero-filled past the matrix, A row-major
// with its chunks swizzled by row group, TM x 16 FMAs for TM + 4
// shared-memory loads). The caller picks the tile
// (kernels/batched_gemm.gemm_tile): for m <= 128 one tile of ceil(m / TM)
// row groups, TM 4 up to 64 rows (14 groups at m 56: more warps to hide
// the loads' latency) and 8 past it, so no row past m is computed but the
// last group's spare ones; past 128 rows TM 8 or 9 and R 8 or 16,
// whichever leaves the fewest rows on the busiest of the card's SMs (2 x
// 9000: 126 tiles of 144 rows, not 142 of 128 on 132 SMs). A warp whose
// rows all lie past m skips the FMAs.
//
// Every output is one fmaf chain over k in increasing order from 0.0, the
// same whatever the tile (a zero-filled k adds fmaf(0, 0, acc) == acc, and
// acc is never -0.0): the result is bitwise repeatable, and the batched and
// large-matrix entries (the same kernel since this design, counted apart by
// their wrappers) give the same bits.
#include "common.cuh"
#include "gemm_tile.cuh"

namespace {

using repro::gemm::kLanes;
using repro::gemm::kMaxGroups;
using repro::gemm::Tile;

template <int TM>
__global__ void __launch_bounds__(kLanes * kMaxGroups)
gemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
            float* __restrict__ c, int m, int k, int n, int wa, int wb,
            int wc) {
  extern __shared__ __align__(16) float gemm_smem[];
  const int bm = TM * (blockDim.x / kLanes);
  const int s = blockIdx.x;
  const int r0 = blockIdx.y * bm;
  const int col0 = blockIdx.z * Tile<TM, 1>::kPanel;
  const int ty = threadIdx.x / kLanes;

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  // the warp's first row: its two row groups lie past m together or not
  const bool live = r0 + (ty & ~1) * TM < m;
  repro::gemm::mainloop<TM, 1>(
      acc, gemm_smem, bm, a + static_cast<size_t>(s) * m * k,
      b + static_cast<size_t>(s) * k * n, k, n, r0, col0, wa, wb,
      [&](int row) { return r0 + row < m; }, live);
  repro::gemm::store<TM, 1>(acc, c + static_cast<size_t>(s) * m * n, m, n,
                            r0, col0, wc);
}

template <int TM>
int launch(const float* a, const float* b, float* c, int batch, int m, int k,
           int n, int groups, void* stream) {
  const int bm = TM * groups;
  const int tiles = (m + bm - 1) / bm;
  if (tiles > 65535) return cudaErrorInvalidValue;
  const size_t smem = Tile<TM, 1>::smem_bytes(bm);
  cudaError_t e = repro::allow_smem(gemm_kernel<TM>, smem);
  if (e != cudaSuccess) return e;
  using repro::gemm::copy_width;
  const dim3 grid(batch, tiles, (n + Tile<TM, 1>::kPanel - 1) /
                                    Tile<TM, 1>::kPanel);
  gemm_kernel<TM><<<grid, kLanes * groups, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      a, b, c, m, k, n, copy_width(a, k), copy_width(b, n), copy_width(c, n));
  return cudaGetLastError();
}

}  // namespace

// tm (4, 8 or 9) rows a thread, groups (1-16) row groups of 16 threads: the
// row tile kernels/batched_gemm.gemm_tile chooses. m, k and n are
// unbounded but for ceil(m / (tm * groups)) <= 65535 row tiles.
extern "C" int batched_gemm_f32(const float* a, const float* b, float* c,
                                int batch, int m, int k, int n, int tm,
                                int groups, void* stream) {
  if (m < 1 || k < 1 || n < 1 || groups < 1 || groups > kMaxGroups)
    return cudaErrorInvalidValue;
  if (tm == 4) return launch<4>(a, b, c, batch, m, k, n, groups, stream);
  if (tm == 8) return launch<8>(a, b, c, batch, m, k, n, groups, stream);
  if (tm == 9) return launch<9>(a, b, c, batch, m, k, n, groups, stream);
  return cudaErrorInvalidValue;
}
