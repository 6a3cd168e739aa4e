// Ragged grouped matmul: out[i, :] = x[i, :] @ w[g(i)], rows sorted by
// group, g(i) from the device-side row-group array (rows past the sum of the
// group sizes belong to group E - 1, as the wrapper computes it).
//
// Replaces the TPU kernel src/repro/kernels/grouped_matmul.py (_gmm /
// _kernel, the grouped_matmul of models/gnn.rgcn_layer), which visits at
// most max_groups_per_tile = 4 groups per tm = 128-row tile, the group of
// the tile's first row and the next three, and leaves the rows of any
// further group 0. This kernel keeps that contract whatever its own
// tiling: a row whose group lies max_groups or more past the group of the
// first row of its tm-row tile is staged as no group and comes out 0.
//
// What bounds it on an H100: at R-GCN's widths (K, N = 62..512) a call
// moves x, w and out once and does 2*M*K*N f32 operations: at K = N = 64 it
// is bytes (~0.5 FLOP per byte), at K = N = 512 operations (15 GFLOP at
// M = 28,672, ~0.22 ms at the 67 TFLOP/s f32 peak). It runs on the f32
// FMA pipes, not the tensor cores: TF32 would leave the f32 tolerance at
// K = 512. What held the first design back (0.84-0.86 ms at K = N = 512,
// ~18 TFLOP/s, and 0.018-0.020 ms at N 64 against 0.007-0.010 for
// torch.bmm, on one H100 80GB HBM3 at 700 W): 4 x 4 thread tiles (8
// shared-memory loads for 16 FMAs), k-tiles staged by scalar loads with an
// integer division per element and nothing in flight during the FMAs, one
// thread scanning the tile's rows for its group range, and 64-row tiles
// that left SMs idle at M 11,200.
//
// Design: the mainloop of the batched GEMM (gemm_tile.cuh: K through a
// 4-stage cp.async ring, 8 rows x 4 or 8 columns a thread, float4 reads
// from shared memory) over a row tile of x and a column panel of w[g]. The
// caller picks the tile (kernels/grouped_matmul.gmm_tile): 64-row tiles,
// with 64-column panels (8 x 4 a thread) up to N 64 and 128-column ones
// (8 x 8 a thread) past it: 175 tiles at M 11,200 and 448 at 28,672 for
// 132 SMs. Of 32-, 64- and 128-row tiles with either panel, 64 x 64 was
// the fastest at N 64 in every run; at N 512 the fastest tile moved from
// card to card (64 x 128, 128 x 128, or 64 x 64 at K 62), this one within
// 10% of it; rings of 3 and 6 stages moved no main-path time by more than
// 7% either way, 8 was slower (one H100 80GB HBM3 at 700 W a run,
// scripts/gmm_tiles.py; PERF.md section 6). The column panels of one row
// tile are neighbours in the grid, so x is read from device memory once
// and from the L2 after. Each thread stages the group of one tile row, and
// the tile's group range is two warp reductions and a pass over the warps'
// results. The tile then makes one pass per group it holds (a group with
// no row in the tile is skipped), reading w[g]'s pointer per pass; in the
// pass of group g the x rows of other groups, and the rows the reference
// does not visit, are zero-filled as they are copied (cp.async with
// src_bytes 0), not masked in the FMAs, and a warp with no row in g skips
// its FMAs. Against the first design on one H100 80GB HBM3 at 700 W
// (scripts/fused_compare.py, parent and this design in turns on one card;
// torch.bmm over the groups in parentheses, chip_smoke.py):
// 0.0120 ms against 0.0200 at M 28,672 x K 62 x N 64 (torch.bmm 0.0104),
// 0.0097 against 0.0188 at M 11,200 (0.0068), 0.0811 against 0.1142 at K
// 62 x N 512 (0.0659), 0.473 against 0.856 at K = N = 512 (0.331, ~32
// TFLOP/s; 0.441 on another card of the same kind). At N 64 it stays above
// torch.bmm: the batched GEMM, the same mainloop without group passes,
// takes 0.0114 and 0.0074 ms at those shapes (scripts/gmm_tiles.py).
//
// Exact only because a zero-filled x row adds fmaf(0, w, acc) == acc: a
// NaN or inf in W would break it (0 * inf is NaN), in a tile that
// straddles that group's boundary. Every output is one fmaf chain over k in
// increasing order from 0.0, whatever tile holds it: no atomics, bitwise
// repeatable.
#include "common.cuh"
#include "gemm_tile.cuh"

#include <climits>

namespace {

using repro::gemm::kLanes;
using repro::gemm::kMaxGroups;
using repro::gemm::Tile;

constexpr int kThreadRows = 8;   // rows a thread holds
constexpr int kMaxWarps = kLanes * kMaxGroups / repro::kWarp;

// the lanes of this thread's warp that exist (a block of 16 threads is
// half a warp)
__device__ __forceinline__ unsigned warp_lanes() {
  const int first = threadIdx.x / repro::kWarp * repro::kWarp;
  const int n = min(static_cast<int>(blockDim.x) - first, repro::kWarp);
  return n == repro::kWarp ? 0xffffffffu : (1u << n) - 1u;
}

// Dynamic shared memory: the ring, then each tile row's group and the
// warps' group ranges (all of it dynamic, so that one opt-in covers it).
template <int CW>
size_t smem_bytes(int bm) {
  return Tile<kThreadRows, CW>::smem_bytes(bm) +
         (bm + 2 * kMaxWarps) * sizeof(int);
}

// (no minimum of blocks an SM: held to 2, at most 128 registers a thread,
// the 8 x 8 instance spilled 64 bytes and took 3-16% longer at N 512 on one
// H100 80GB HBM3 at 700 W, scripts/gmm_tiles.py)
template <int CW>
__global__ void __launch_bounds__(kLanes * kMaxGroups)
gmm_kernel(const float* __restrict__ x, const float* __restrict__ w,
           const int* __restrict__ row_group, float* __restrict__ out, int m,
           int k, int n, int e, int tm, int max_groups, int wx, int ww,
           int wo) {
  constexpr int TM = kThreadRows;
  extern __shared__ __align__(16) float gmm_smem[];
  const int bm = TM * (blockDim.x / kLanes);
  int* rg = reinterpret_cast<int*>(gmm_smem) +
            Tile<TM, CW>::smem_bytes(bm) / sizeof(int);   // row groups, -1
  int* warp_lo = rg + bm;
  int* warp_hi = warp_lo + kMaxWarps;
  const int col0 = blockIdx.x * Tile<TM, CW>::kPanel;
  const int r0 = blockIdx.y * bm;
  const int tid = threadIdx.x, ty = tid / kLanes;
  const unsigned lanes = warp_lanes();

  // thread tid stages tile row tid (bm <= blockDim.x); -1: no group, the
  // row comes out 0
  int g = -1;
  if (tid < bm && r0 + tid < m) {
    const int row = r0 + tid;
    g = __ldg(row_group + row);
    if (g - __ldg(row_group + row / tm * tm) >= max_groups || g >= e) g = -1;
  }
  if (tid < bm) rg[tid] = g;
  const int w_lo = __reduce_min_sync(lanes, g < 0 ? INT_MAX : g);
  const int w_hi = __reduce_max_sync(lanes, g);
  if (tid % repro::kWarp == 0) {
    warp_lo[tid / repro::kWarp] = w_lo;
    warp_hi[tid / repro::kWarp] = w_hi;
  }
  __syncthreads();
  int lo = INT_MAX, hi = -1;   // no row with a group: no pass
  for (int i = 0; i < (blockDim.x + repro::kWarp - 1) / repro::kWarp; ++i) {
    lo = min(lo, warp_lo[i]);
    hi = max(hi, warp_hi[i]);
  }

  float acc[TM][4 * CW];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4 * CW; ++j) acc[i][j] = 0.f;

  for (int p = lo; p <= hi; ++p) {
    bool mine = false;
#pragma unroll
    for (int i = 0; i < TM; ++i) mine |= rg[ty * TM + i] == p;
    if (!__syncthreads_or(mine)) continue;   // no row of group p here
    repro::gemm::mainloop<TM, CW>(
        acc, gmm_smem, bm, x, w + static_cast<size_t>(p) * k * n, k, n, r0,
        col0, wx, ww, [&](int row) { return rg[row] == p; },
        __any_sync(lanes, mine));
  }
  repro::gemm::store<TM, CW>(acc, out, m, n, r0, col0, wo);
}

template <int CW>
int launch(const float* x, const float* w, const int* row_group, float* out,
           int m, int k, int n, int e, int tm, int max_groups, int groups,
           void* stream) {
  const int bm = kThreadRows * groups;
  const int tiles = (m + bm - 1) / bm;
  if (tiles > 65535) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<CW>(bm);
  cudaError_t err = repro::allow_smem(gmm_kernel<CW>, smem);
  if (err != cudaSuccess) return err;
  using repro::gemm::copy_width;
  // the panels of a row tile side by side in the grid: x read once
  const dim3 grid((n + Tile<kThreadRows, CW>::kPanel - 1) /
                      Tile<kThreadRows, CW>::kPanel,
                  tiles);
  gmm_kernel<CW><<<grid, kLanes * groups, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      x, w, row_group, out, m, k, n, e, tm, max_groups, copy_width(x, k),
      copy_width(w, n), copy_width(out, n));
  return cudaGetLastError();
}

}  // namespace

// groups (1-16) row groups of 8 rows (16 threads), cols (4 or 8) columns a
// thread: kernels/grouped_matmul.gmm_tile chooses 8 groups (fewer below 64
// rows); scripts/gmm_tiles.py times the others.
extern "C" int grouped_matmul_f32(const float* x, const float* w,
                                  const int* row_group, float* out, int m,
                                  int k, int n, int e, int tm, int max_groups,
                                  int groups, int cols, void* stream) {
  if (tm < 1 || max_groups < 1 || m < 1 || k < 1 || n < 1 || groups < 1 ||
      groups > kMaxGroups)
    return cudaErrorInvalidValue;
  if (cols == 4)
    return launch<1>(x, w, row_group, out, m, k, n, e, tm, max_groups,
                     groups, stream);
  if (cols == 8)
    return launch<2>(x, w, row_group, out, m, k, n, e, tm, max_groups,
                     groups, stream);
  return cudaErrorInvalidValue;
}
