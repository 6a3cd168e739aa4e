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
// rows). K streams through a ring of kStages slabs of 16 in shared memory,
// filled by cp.async (16-byte copies where A's or B's rows are 16-byte
// aligned, 4-byte ones otherwise, zero-filled past the matrix), so three
// slabs are in flight while one is computed. A stays row-major in the ring
// (cp.async copies 16 bytes as they lie), its 16-byte chunks XOR-swizzled by
// row group so that the two row groups of a warp hit other banks; a thread
// reads 4 k of each of its rows as one float4 and B's 4 columns of each k as
// one float4: TM x 16 FMAs for TM + 4 shared-memory loads (TM 8: 32 FMAs
// for every 3). The caller picks the tile (kernels/batched_gemm.gemm_tile):
// for m <= 128 one tile of ceil(m / TM) row groups, TM 4 up to 64 rows (14
// groups at m 56: more warps to hide the loads' latency) and 8 past it, so
// no row past m is computed but the last group's spare ones; past 128 rows
// TM 8 or 9 and R 8 or 16, whichever leaves the fewest rows on the busiest
// of the card's SMs (2 x 9000: 126 tiles of 144 rows, not 142 of 128 on
// 132 SMs). A warp whose rows all lie past m skips the FMAs.
//
// Every output is one fmaf chain over k in increasing order from 0.0, the
// same whatever the tile (a zero-filled k adds fmaf(0, 0, acc) == acc, and
// acc is never -0.0): the result is bitwise repeatable, and the batched and
// large-matrix entries (the same kernel since this design, counted apart by
// their wrappers) give the same bits.
#include "common.cuh"

#include <cstdint>

namespace {

constexpr int kLanes = 16;               // threads along a panel's columns
constexpr int kCols = 4;                 // columns a thread holds (a float4)
constexpr int kPanel = kLanes * kCols;   // columns of C a block owns
constexpr int kMaxGroups = 16;           // row groups: at most 256 threads
constexpr int kSlab = 16;                // K per ring stage
constexpr int kStages = 4;               // ring depth

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from global to shared memory; src_bytes 0 zero-fills.
__device__ __forceinline__ void cp16(void* dst, const void* src,
                                     int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp4(void* dst, const void* src,
                                    int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The 16-byte chunk (of a row's four) where k-chunk ch of tile row `row`
// lies: swizzled by the row's row group, so that rows TM apart (the two
// row groups of a warp) read other banks.
template <int TM>
__device__ __forceinline__ int chunk(int row, int ch) {
  return ch ^ ((row / TM) & 3);
}

template <int TM>
__global__ void __launch_bounds__(kLanes * kMaxGroups)
gemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
            float* __restrict__ c, int m, int k, int n, int vec_a, int vec_b,
            int vec_c) {
  extern __shared__ __align__(16) float gemm_smem[];
  const int groups = blockDim.x / kLanes;
  const int bm = TM * groups;
  float* as = gemm_smem;                       // kStages x (bm, kSlab)
  float* bs = as + kStages * bm * kSlab;       // kStages x (kSlab, kPanel)
  const int s = blockIdx.x;
  const int r0 = blockIdx.y * bm;
  const int col0 = blockIdx.z * kPanel;
  const int tid = threadIdx.x, tx = tid % kLanes, ty = tid / kLanes;
  const float* asrc = a + static_cast<size_t>(s) * m * k;
  const float* bsrc = b + static_cast<size_t>(s) * k * n;

  // slab t into ring stage t % kStages: every element written, past the
  // matrix as zeros
  auto load = [&](int t) {
    const int k0 = t * kSlab;
    float* ad = as + (t % kStages) * bm * kSlab;
    float* bd = bs + (t % kStages) * kSlab * kPanel;
    for (int i = tid; i < bm * (kSlab / 4); i += blockDim.x) {
      const int row = i / (kSlab / 4), ch = i % (kSlab / 4);
      const int gr = r0 + row, gk = k0 + ch * 4;
      float* d = ad + row * kSlab + chunk<TM>(row, ch) * 4;
      const float* src = asrc + static_cast<size_t>(gr) * k + gk;
      if (vec_a) {
        const bool ok = gr < m && gk < k;
        cp16(d, ok ? src : asrc, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = gr < m && gk + e < k;
          cp4(d + e, ok ? src + e : asrc, ok ? 4 : 0);
        }
      }
    }
    for (int i = tid; i < kSlab * (kPanel / 4); i += blockDim.x) {
      const int kr = i / (kPanel / 4), ch = i % (kPanel / 4);
      const int gk = k0 + kr, gc = col0 + ch * 4;
      float* d = bd + kr * kPanel + ch * 4;
      const float* src = bsrc + static_cast<size_t>(gk) * n + gc;
      if (vec_b) {
        const bool ok = gk < k && gc < n;
        cp16(d, ok ? src : bsrc, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = gk < k && gc + e < n;
          cp4(d + e, ok ? src + e : bsrc, ok ? 4 : 0);
        }
      }
    }
  };

  float acc[TM][kCols];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  // the warp's first row: its two row groups lie past m together or not
  const bool live = r0 + (ty & ~1) * TM < m;

  const int nslab = (k + kSlab - 1) / kSlab;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nslab) load(t);
    cp_commit();
  }
  for (int t = 0; t < nslab; ++t) {
    cp_wait<kStages - 2>();   // this thread's copies of slab t have landed
    __syncthreads();          // everyone's, and slab t - 1 is computed
    if (t + kStages - 1 < nslab) load(t + kStages - 1);
    cp_commit();
    if (!live) continue;
    const float* ad = as + (t % kStages) * bm * kSlab;
    const float* bd = bs + (t % kStages) * kSlab * kPanel;
#pragma unroll
    for (int ch = 0; ch < kSlab / 4; ++ch) {
      float4 av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int row = ty * TM + i;
        av[i] = *reinterpret_cast<const float4*>(
            ad + row * kSlab + chunk<TM>(row, ch) * 4);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 bv = *reinterpret_cast<const float4*>(
            bd + (ch * 4 + kk) * kPanel + tx * kCols);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av_k = reinterpret_cast<const float*>(&av[i])[kk];
          acc[i][0] = fmaf(av_k, bv.x, acc[i][0]);
          acc[i][1] = fmaf(av_k, bv.y, acc[i][1]);
          acc[i][2] = fmaf(av_k, bv.z, acc[i][2]);
          acc[i][3] = fmaf(av_k, bv.w, acc[i][3]);
        }
      }
    }
  }
  cp_wait<0>();

  const int col = col0 + tx * kCols;
  float* cdst = c + static_cast<size_t>(s) * m * n;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + ty * TM + i;
    if (r >= m) break;
    float* dst = cdst + static_cast<size_t>(r) * n + col;
    if (vec_c && col + kCols <= n) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (col + j < n) dst[j] = acc[i][j];
    }
  }
}

template <int TM>
int launch(const float* a, const float* b, float* c, int batch, int m, int k,
           int n, int groups, void* stream) {
  const int bm = TM * groups;
  const int tiles = (m + bm - 1) / bm;
  if (tiles > 65535) return cudaErrorInvalidValue;
  const size_t smem =
      static_cast<size_t>(kStages) * (bm + kPanel) * kSlab * sizeof(float);
  cudaError_t e = repro::allow_smem(gemm_kernel<TM>, smem);
  if (e != cudaSuccess) return e;
  auto aligned = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
  };
  const dim3 grid(batch, tiles, (n + kPanel - 1) / kPanel);
  gemm_kernel<TM><<<grid, kLanes * groups, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      a, b, c, m, k, n, k % 4 == 0 && aligned(a), n % 4 == 0 && aligned(b),
      n % 4 == 0 && aligned(c));
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
