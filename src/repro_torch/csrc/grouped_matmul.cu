// Ragged grouped matmul: out[i, :] = x[i, :] @ w[g(i)], rows sorted by
// group, g(i) from the device-side row-group array (rows past the sum of the
// group sizes belong to group E - 1, as the wrapper computes it).
//
// Replaces the TPU kernel src/repro/kernels/grouped_matmul.py (_gmm /
// _kernel, the grouped_matmul of models/gnn.rgcn_layer), which visits at
// most max_groups_per_tile = 4 groups per tm = 128-row tile, the group of
// the tile's first row and the next three, and leaves the rows of any
// further group 0. This kernel keeps that contract whatever its own
// 64-row tiling: a row whose group lies max_groups or more past the group
// of the first row of its tm-row tile is staged as no group and comes out
// 0.
//
// What bounds it on an H100: at R-GCN's widths (K, N = 62..512) a call
// moves x, w and out once and does 2*M*K*N f32 operations: at K = N = 64 it
// is bytes (~0.5 FLOP per byte), at K = N = 512 operations (15 GFLOP at
// M = 28,672, ~0.22 ms at the 67 TFLOP/s f32 peak). It runs on the f32
// FMA pipes, not the tensor cores: TF32 would leave the f32 tolerance at
// K = 512.
//
// Design: a tiled SGEMM. One block of 256 threads computes a 64 x 64 output
// tile, each thread a 4 x 4 register sub-tile (rows ty + 16 i, columns
// tx + 16 j). K is staged through shared memory in k-tiles of 16: the x
// tile stored transposed, so that a k step reads one row of each operand
// as broadcasts. A tile that straddles a group boundary loops over the
// groups its rows hold (the smallest to the largest row group of the
// tile); in the pass of group g the x rows of other groups are staged as
// 0.0, so every row accumulates under its own group's weight alone, and a
// row's sum is the same sequence of FMAs whichever tile layout holds it. No
// atomics: bitwise repeatable.
#include "common.cuh"

namespace {

constexpr int kTile = 64;     // output tile: kTile x kTile
constexpr int kDepth = 16;    // k-tile
constexpr int kSide = 16;     // threads per tile side; each owns 4 x 4
constexpr int kThreads = kSide * kSide;
constexpr int kSub = kTile / kSide;

__global__ void __launch_bounds__(kThreads)
gmm_kernel(const float* __restrict__ x, const float* __restrict__ w,
           const int* __restrict__ row_group, float* __restrict__ out, int m,
           int k, int n, int e, int tm, int max_groups) {
  __shared__ float xs[kDepth][kTile + 1];   // x tile, transposed (padded
                                            // against bank conflicts)
  __shared__ float ws[kDepth][kTile];   // w[g] tile
  __shared__ int rg[kTile];
  __shared__ int g_range[2];
  const int row0 = blockIdx.x * kTile, col0 = blockIdx.y * kTile;
  const int tid = threadIdx.x, tx = tid % kSide, ty = tid / kSide;
  const int rows = min(kTile, m - row0);
  if (tid < kTile) {
    int g = -1;   // -1: no group, the row comes out 0
    if (tid < rows) {
      const int row = row0 + tid;
      g = __ldg(row_group + row);
      if (g - __ldg(row_group + row / tm * tm) >= max_groups) g = -1;
    }
    rg[tid] = g;
  }
  __syncthreads();
  if (tid == 0) {
    int lo = e, hi = -1;   // no row with a group: the loop below is empty
    for (int r = 0; r < rows; ++r) {
      if (rg[r] < 0) continue;
      lo = min(lo, rg[r]);
      hi = max(hi, rg[r]);
    }
    g_range[0] = lo;
    g_range[1] = min(hi, e - 1);
  }
  __syncthreads();

  float acc[kSub][kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j) acc[i][j] = 0.f;

  for (int g = g_range[0]; g <= g_range[1]; ++g) {
    const float* wg = w + static_cast<size_t>(g) * k * n;
    for (int k0 = 0; k0 < k; k0 += kDepth) {
      // x tile: kTile rows x kDepth, coalesced along K; rows of another
      // group, and the ragged edges, are staged as 0.0
      for (int l = tid; l < kTile * kDepth; l += kThreads) {
        const int r = l / kDepth, kk = l - r * kDepth;
        float v = 0.f;
        if (rg[r] == g && k0 + kk < k)
          v = __ldg(x + static_cast<size_t>(row0 + r) * k + k0 + kk);
        xs[kk][r] = v;
      }
      // w[g] tile: kDepth x kTile, coalesced along N
      for (int l = tid; l < kDepth * kTile; l += kThreads) {
        const int kk = l / kTile, cc = l - kk * kTile;
        float v = 0.f;
        if (k0 + kk < k && col0 + cc < n)
          v = __ldg(wg + static_cast<size_t>(k0 + kk) * n + col0 + cc);
        ws[kk][cc] = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk) {
        float a[kSub], bv[kSub];
#pragma unroll
        for (int i = 0; i < kSub; ++i) a[i] = xs[kk][ty + kSide * i];
#pragma unroll
        for (int j = 0; j < kSub; ++j) bv[j] = ws[kk][tx + kSide * j];
#pragma unroll
        for (int i = 0; i < kSub; ++i)
#pragma unroll
          for (int j = 0; j < kSub; ++j)
            acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int r = ty + kSide * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const int cc = col0 + tx + kSide * j;
      if (cc < n) out[static_cast<size_t>(row0 + r) * n + cc] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int grouped_matmul_f32(const float* x, const float* w,
                                  const int* row_group, float* out, int m,
                                  int k, int n, int e, int tm, int max_groups,
                                  void* stream) {
  if (tm < 1 || max_groups < 1) return cudaErrorInvalidValue;
  const dim3 grid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  gmm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, row_group, out, m, k, n, e, tm, max_groups);
  return cudaGetLastError();
}
