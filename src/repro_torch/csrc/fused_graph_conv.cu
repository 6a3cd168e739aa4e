// Fused graph-conv layer — Y = epi(sum_ch A_ch (X W_ch + b_ch) [+ res]) in
// ONE kernel, the whole ChemGCN layer of paper Fig. 7 per launch.
//
// Replaces the TPU kernel src/repro/kernels/fused_graph_conv.py
// (fused_forward / _kernel, the fused registry entry, and its rank/slab
// hybrid branch reached from fused_hybrid_forward, the fused_hybrid entry).
//
// What bounds it on an H100: operations at wide layers, latency at narrow
// ones. The feature transform is 2 * m_pad * n_in * n_out FLOP per sample
// and channel (15 GFLOP per Reaction100 layer at 128 samples: 0.23 ms at
// the 67 TFLOP/s f32 peak, 0.016 ms at the 989 TFLOP/s bf16 tensor-core
// peak) against a few MB of X, W and Y; at Tox21 widths (62 -> 64) it is
// 0.23 GFLOP, and each block's chain of dependent loads and barriers
// bounds it.
//
// Design: one block of 128 threads per (sample x output-column panel),
// grid (batch, p). The planner (core/batching.plan_fused_graph_conv) takes
// panels of 16-128 columns, kept at a tile width TN of 16, 32, 64 or 128
// (a template parameter), and narrows them until the grid has a block per
// SM: at small batch (the powerlaw batch of 40 samples) this is the split
// that fills the card, since panels share nothing and need no merge across
// blocks, where a split of rows would repeat the transform and a split of
// channels would merge accumulators through global atomics and a
// finishing step. Per block:
//
// - shared memory holds a ring of k-tiles (32 deep; three stages for bf16
//   or at most 32 columns, else two), one channel's U_ch panel (m_u =
//   m_pad rounded up to 32 rows, TN columns, f32) and the accumulator
//   (m_pad x TN, f32): 110 KB at Reaction100 (m_pad 56, n_in 512, TN 128),
//   so two blocks share an SM;
// - for each channel, U_ch = X W_ch[:, panel] + b_ch runs over row tiles
//   of 64 rows (56 in the f32 entries at 128 columns where that pads m_pad
//   less, as at the m_pad 56 of the Tox21 and Reaction100 waves; rows past
//   m_pad are zero-filled): the X tile (rows x 32) and the W tile (32 x
//   TN) of later k-tiles are copied with cp.async (16-byte chunks where the
//   strides allow, 8 or 4 otherwise, zero-filled past the edges) while
//   k-tile k is multiplied.
//   f32 entries: each thread keeps a register tile of TN / 16 rows x 8
//   columns (7 rows at 56-row tiles; columns 4t..4t+3 and TN/2+4t..) and
//   reads X and W from shared memory with 16-byte loads; plain f32 FMAs,
//   no TF32. bf16 entry: the warps split the tile 2 x 2 (a 16-row strip
//   each at 16 columns) and run mma.sync.m16n8k16 (bf16 x bf16 products,
//   exact in f32, summed in f32; X by ldmatrix, W's row-major tile by
//   ldmatrix.trans), the reference's dot(x.astype(f32), w.astype(f32)) up
//   to summation order;
// - after a barrier, the channel's index stream (its real chunks[s, ch] *
//   chunk slots, the reference's skew-aware bound) is copied into the idle
//   ring and bucketed by row (integer atomics: shared memory's float
//   atomicAdd is a compare-and-swap loop); each group of sub lanes then
//   owns whole rows, sums val * U_ch[cid] over a row's slots in registers
//   and adds the sum to the accumulator without an atomic. A slot whose
//   value is 0.0 — padding, which the reference lets sit anywhere inside
//   the visited chunks — adds nothing. A channel with no chunk (and no hub
//   row) skips its transform;
// - the epilogue adds the residual, applies ReLU and stores the panel
//   once. The order of a row's sum follows the integer atomics, so its last
//   bits vary from run to run; the result is held to the f32 tolerance.
//
// Hybrid branch (entry fused_graph_conv_hybrid_f32; template kHybrid): the
// accumulator holds the rows in degree-sorted order. The sparse slots' row
// ids are already sorted positions (hub slots carry the m_pad sentinel and
// are skipped). For each channel, once U_ch is complete, the head
// slab_ch[:hubs[s]] . U_ch runs as the same tiled product (slab k-tiles
// through the ring, U_ch read in place) and is added to accumulator rows
// [0, hubs[s]) before the scatter. hubs[s] is the sample's hub count: slab
// rows at or past it are zero by construction, so bounding the head by it
// is exact; a sample with no hub skips the head, and then also the
// transform of a channel with no chunk. The epilogue reads acc[rank[r]]
// for output row r, then adds the residual and applies ReLU, the
// reference's order.
//
// Large matrices (plan.large: the plan's U_ch and accumulator panels do
// not fit a block, m_pad past ~750 at 32 columns): two kernels a group of
// channels, in one entry call, so that the card fills and nothing adds
// through float atomics. Kernel 1 (large_transform) computes U[s, ch] =
// X[s] W_ch + b_ch of every (sample, channel) the layer reads into a
// global f32 scratch (batch, channels, m_pad, ldu), one 128-row (f32) or
// 64-row (bf16) tile x 32-, 64- or 128-column panel a block through the
// transform above (f32 FMA register tiles, or bf16 mma.sync summed in
// f32): 256 blocks at 8 x 1024 rows, 4 channels, f32, where the former
// design (U_ch and the accumulator in a block-private scratch, one block a
// sample x 16-column panel, the scatter by global atomics) ran 32. Kernel
// 2 (large_aggregate) owns output rows: one block a (sample x row block x
// panel of at most 128 columns), the accumulator of its rows in shared
// memory; it buckets the slots of its rows in each channel's stream by row
// in shared memory as the COO kernel does and walks them in slot order,
// channel after channel, so each output is one fmaf chain in a fixed order
// (a row longer than a sub-warp's share of a run, a hub row, in pieces
// added in a fixed order) and the branch is bitwise repeatable; it adds
// the hybrid head onto the hub rows, then stores Y through the rank map
// with the residual and ReLU. Where the scratch cannot hold every
// channel's U (more than twice the former block-private panels: past 4
// channels), channels go in groups, the accumulator kept in the scratch
// between them; the sums are the same. Against the former design, in
// turns on one H100 80GB HBM3 at 700.00 W (scripts/fused_compare.py), at
// 8 x 1024 rows, 512 -> 64: f32 1.931 -> 0.133 ms (the library's einsum +
// matmul 0.175), bf16 2.374 -> 0.091 (its one bf16 bmm 0.065); at 2 x
// 3072, n_in 62: f32 2.999 -> 0.090 (0.267).
//
// bf16 entry (fused_graph_conv_bf16, the fused_bf16 registry entry), the
// reference kernel's other operand branch (_kernel :54 with int16 ids
// widened on load (:90) and bf16 values, X, W and bias): U_ch is kept in
// the f32 panel, never rounded; the scatter adds f32 products into the f32
// accumulator, and only Y is rounded to bf16, once, in the epilogue
// (__float2bfloat16_rn), as the reference stores its f32 accumulator in
// X's dtype.
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kTK = 32;        // depth of a k-tile
constexpr int kMaxSmem = 232448;


// The f32 register tile of a TN-column panel and a TM-row tile (64 rows,
// or 56 at 128 columns where that pads m_pad less): kCT threads along the
// columns (8 columns each), kRT along the rows, kRM rows each (TN / 16 at
// 64 rows).
template <int TN, int TM = 64>
struct Tile {
  static constexpr int kCT = TN / 8;
  static constexpr int kRT = kThreads / kCT;
  static constexpr int kRM = TM / kRT;
  static_assert(TN == 16 || TN == 32 || TN == 64 || TN == 128,
                "TN is 16, 32, 64 or 128");
  static_assert(kRM * kRT == TM, "TM is a whole number of thread rows");
};

// The ring: kStages stages (three where a stage is small: bf16, or at most
// 32 columns) of an A tile (TM x kTK, rows padded by 4 f32 or 8 bf16
// elements against bank conflicts) and a B tile (kTK x TN; bf16 rows padded
// by 8 for ldmatrix.trans).
template <typename D, int TN, int TM = 64>
struct Ring {
  static constexpr bool kBf16 = sizeof(D) == 2;
  static constexpr int kStages = kBf16 || TN <= 32 ? 3 : 2;
  static constexpr int kLdA = kTK + (kBf16 ? 8 : 4);
  static constexpr int kLdB = TN + (kBf16 ? 8 : 0);
  static constexpr int kA = TM * kLdA * static_cast<int>(sizeof(D));
  static constexpr int kStage = kA + kTK * kLdB * static_cast<int>(sizeof(D));
  static constexpr int kBytes = kStages * kStage;
};

struct Params {
  const void* rid;
  const void* cid;
  const void* val;
  const int* chunks;
  const void* x;
  const void* w;
  const void* bias;
  const void* res;
  const int* rank;
  const float* slab;
  const int* hubs;
  float* scratch;
  void* y;
  int channels, nnz_pad, chunk, m_pad, n_in, n_out, n_block, d_pad, relu;
  int sub;                           // lanes per scatter slot
  int vec_x, vec_w, vec_s, vec_i, vec_v;  // copy widths in bytes
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy kBytes from global to shared memory, of which the first src_bytes
// are read and the rest zero-filled.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(dst)), "l"(src), "n"(kBytes), "r"(src_bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A kRows x kCols tile of T at src (row stride ld) into dst (row stride
// ldd): rows past vr and columns past vc are zero-filled. kVB-byte copies;
// the tile's origin is always inside the array.
template <typename T, int kRows, int kCols, int kVB>
__device__ __forceinline__ void tile_chunks(T* dst, int ldd, const T* src,
                                            long long ld, int vr, int vc) {
  constexpr int kE = kVB / static_cast<int>(sizeof(T));
  constexpr int kPer = kCols / kE;
  for (int i = threadIdx.x; i < kRows * kPer; i += kThreads) {
    const int r = i / kPer, c = (i - r * kPer) * kE;
    const int e = r < vr ? min(kE, max(vc - c, 0)) : 0;
    cp_async<kVB>(dst + r * ldd + c, e ? src + r * ld + c : src,
                  e * static_cast<int>(sizeof(T)));
  }
}

template <typename T, int kRows, int kCols>
__device__ __forceinline__ void load_tile(T* dst, int ldd, const T* src,
                                          long long ld, int vr, int vc,
                                          int vec) {
  if (vec == 16) {
    tile_chunks<T, kRows, kCols, 16>(dst, ldd, src, ld, vr, vc);
  } else if (vec == 8) {
    tile_chunks<T, kRows, kCols, 8>(dst, ldd, src, ld, vr, vc);
  } else if (vec == 4) {
    tile_chunks<T, kRows, kCols, 4>(dst, ldd, src, ld, vr, vc);
  } else {  // 2-byte elements at odd strides: plain loads and stores
    for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
      const int r = i / kCols, c = i - r * kCols;
      dst[r * ldd + c] = r < vr && c < vc ? src[r * ld + c] : T();
    }
  }
}

// n elements of T at src into dst (n rounded up to a whole copy) by kN
// threads.
template <typename T, int kVB, int kN>
__device__ __forceinline__ void run_chunks(T* dst, const T* src, int n) {
  constexpr int kE = kVB / static_cast<int>(sizeof(T));
  for (int i = threadIdx.x; i * kE < n; i += kN) {
    const int c = i * kE;
    cp_async<kVB>(dst + c, src + c,
                  min(kE, n - c) * static_cast<int>(sizeof(T)));
  }
}

template <typename T, int kN = kThreads>
__device__ __forceinline__ void load_run(T* dst, const T* src, int n,
                                         int vec) {
  if (vec == 16) {
    run_chunks<T, 16, kN>(dst, src, n);
  } else if (vec == 8) {
    run_chunks<T, 8, kN>(dst, src, n);
  } else if (vec == 4) {
    run_chunks<T, 4, kN>(dst, src, n);
  } else {
    for (int i = threadIdx.x; i < n; i += kN) dst[i] = src[i];
  }
}

// c += A . B over one k-tile: A (row tile x kTK, row stride kLdA) and B
// (kTK x TN, row stride TN), both f32 in shared memory.
template <int TN, int TM>
__device__ __forceinline__ void fma_tile(float (&c)[Tile<TN, TM>::kRM][8],
                                         const float* as, const float* bs,
                                         int rg, int ct) {
  using G = Tile<TN, TM>;
  constexpr int kLdA = Ring<float, TN, TM>::kLdA;
#pragma unroll
  for (int kk = 0; kk < kTK; kk += 4) {
    float4 a[G::kRM];
#pragma unroll
    for (int i = 0; i < G::kRM; ++i)
      a[i] = *reinterpret_cast<const float4*>(as + (rg + G::kRT * i) * kLdA +
                                              kk);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* br = bs + (kk + q) * TN + ct * 4;
      const float4 b0 = *reinterpret_cast<const float4*>(br);
      const float4 b1 = *reinterpret_cast<const float4*>(br + TN / 2);
#pragma unroll
      for (int i = 0; i < G::kRM; ++i) {
        const float v = q == 0 ? a[i].x : q == 1 ? a[i].y
                        : q == 2 ? a[i].z : a[i].w;
        c[i][0] = fmaf(v, b0.x, c[i][0]);
        c[i][1] = fmaf(v, b0.y, c[i][1]);
        c[i][2] = fmaf(v, b0.z, c[i][2]);
        c[i][3] = fmaf(v, b0.w, c[i][3]);
        c[i][4] = fmaf(v, b1.x, c[i][4]);
        c[i][5] = fmaf(v, b1.y, c[i][5]);
        c[i][6] = fmaf(v, b1.z, c[i][6]);
        c[i][7] = fmaf(v, b1.w, c[i][7]);
      }
    }
  }
}

// c = A[0:TM, 0:K] . B[0:K, 0:TN] in f32, A (row stride lda, vr valid
// rows) staged through the ring; B staged from global
// memory (row stride ldb, vc valid columns) when kStageB, else read in
// place from shared memory at bs (row stride TN, at least K rounded up to
// kTK rows). Ends with a barrier, so the ring may be reused at once.
template <int TN, int TM, bool kStageB>
__device__ __forceinline__ void gemm_f32(float (&c)[Tile<TN, TM>::kRM][8],
                                         unsigned char* ring, const float* a,
                                         long long lda, int vr, int K,
                                         int vec_a, const float* b,
                                         long long ldb, int vc, int vec_b,
                                         const float* bs) {
  using G = Tile<TN, TM>;
  using R = Ring<float, TN, TM>;
#pragma unroll
  for (int i = 0; i < G::kRM; ++i)
#pragma unroll
    for (int q = 0; q < 8; ++q) c[i][q] = 0.f;
  const int kt_n = (K + kTK - 1) / kTK;
  const int ct = threadIdx.x % G::kCT, rg = threadIdx.x / G::kCT;
  // k-tile kt into stage kt % kStages; every call commits one group (empty
  // past the last k-tile), so the wait below counts alike at every step
  auto stage = [&](int kt) {
    if (kt < kt_n) {
      float* sa = reinterpret_cast<float*>(ring +
                                           (kt % R::kStages) * R::kStage);
      const int k0 = kt * kTK;
      load_tile<float, TM, kTK>(sa, R::kLdA, a + k0, lda, vr, K - k0,
                                vec_a);
      if constexpr (kStageB)
        load_tile<float, kTK, TN>(sa + TM * R::kLdA, TN, b + k0 * ldb, ldb,
                                  K - k0, vc, vec_b);
    }
    cp_commit();
  };
#pragma unroll
  for (int kt = 0; kt < R::kStages - 1; ++kt) stage(kt);
  for (int kt = 0; kt < kt_n; ++kt) {
    stage(kt + R::kStages - 1);
    cp_wait<R::kStages - 1>();
    __syncthreads();
    const float* sa = reinterpret_cast<const float*>(
        ring + (kt % R::kStages) * R::kStage);
    fma_tile<TN, TM>(c, sa,
                     kStageB ? sa + TM * R::kLdA : bs + kt * kTK * TN, rg,
                     ct);
    __syncthreads();
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)) : "memory");
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c = X[0:64, 0:K] . W[0:K, 0:TN] on the tensor cores, c[i] an mma
// accumulator fragment (16 rows x 8 columns). At 32 columns or more the
// warps split the tile 2 x 2: warp w owns rows [32 (w & 1), +32) and
// columns [(w >> 1) TN / 2, +TN / 2), c[mi * TN / 16 + j] its 16-row half
// mi and n-tile j (two A fragments per B fragment, where a 16-row strip
// per warp loads every B fragment into all four warps); at 16 columns
// warp w owns rows [16w, +16) and c[j] columns [8j, 8j + 8). Both tiles
// are staged through the ring. Ends with a barrier.
template <int TN>
__device__ __forceinline__ void gemm_bf16(float (&c)[TN / 8][4],
                                          unsigned char* ring,
                                          const __nv_bfloat16* a,
                                          long long lda, int vr, int K,
                                          int vec_a, const __nv_bfloat16* b,
                                          long long ldb, int vc, int vec_b) {
  using R = Ring<__nv_bfloat16, TN>;
  constexpr int kNT = TN / 8;
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) c[j][q] = 0.f;
  const int kt_n = (K + kTK - 1) / kTK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto stage = [&](int kt) {
    if (kt < kt_n) {
      __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(
          ring + (kt % R::kStages) * R::kStage);
      const int k0 = kt * kTK;
      load_tile<__nv_bfloat16, 64, kTK>(sa, R::kLdA, a + k0, lda, vr,
                                        K - k0, vec_a);
      load_tile<__nv_bfloat16, kTK, TN>(sa + 64 * R::kLdA, R::kLdB,
                                        b + k0 * ldb, ldb, K - k0, vc, vec_b);
    }
    cp_commit();
  };
#pragma unroll
  for (int kt = 0; kt < R::kStages - 1; ++kt) stage(kt);
  for (int kt = 0; kt < kt_n; ++kt) {
    stage(kt + R::kStages - 1);
    cp_wait<R::kStages - 1>();
    __syncthreads();
    const __nv_bfloat16* sa = reinterpret_cast<const __nv_bfloat16*>(
        ring + (kt % R::kStages) * R::kStage);
    const __nv_bfloat16* sb = sa + 64 * R::kLdA;
    if constexpr (TN >= 32) {
      constexpr int kW = TN / 16;  // n-tiles of a warp's column half
      const int wr = warp & 1, wc = warp >> 1;
#pragma unroll
      for (int kk = 0; kk < kTK; kk += 16) {
        uint32_t af[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldsm_x4(af[mi], sa + (32 * wr + 16 * mi + (lane & 15)) * R::kLdA +
                              kk + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < kW; j += 2) {
          uint32_t bf[4];
          ldsm_x4_t(bf, sb + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 R::kLdB + wc * (TN / 2) + j * 8 +
                                 (lane >> 4) * 8);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_bf16(c[mi * kW + j], af[mi], bf[0], bf[1]);
            mma_bf16(c[mi * kW + j + 1], af[mi], bf[2], bf[3]);
          }
        }
      }
      __syncthreads();
      continue;
    }
#pragma unroll
    for (int kk = 0; kk < kTK; kk += 16) {
      uint32_t af[4];
      ldsm_x4(af, sa + (warp * 16 + (lane & 15)) * R::kLdA + kk +
                      (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        uint32_t bf[4];
        ldsm_x4_t(bf, sb + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               R::kLdB + j * 8 + (lane >> 4) * 8);
        mma_bf16(c[j], af, bf[0], bf[1]);
        mma_bf16(c[j + 1], af, bf[2], bf[3]);
      }
    }
    __syncthreads();
  }
}

// U rows [r0, r0 + row tile) of one channel: X W + b into out (row stride
// ld), rows below m_u and the first ncols columns of the tile only (in
// groups of four; ncols TN for the shared panel of the fused kernel, the
// columns of U up to n_out rounded to four for the large branch's U).
template <int TN, int TM>
__device__ __forceinline__ void transform(float* out, int ld, int m_u,
                                          int ncols, unsigned char* ring,
                                          const float* x, const float* w,
                                          const float* bias, int r0, int nbw,
                                          const Params& p) {
  using G = Tile<TN, TM>;
  const int ct = threadIdx.x % G::kCT, rg = threadIdx.x / G::kCT;
  // the bias is read before the product, which hides the loads, but at 128
  // columns after it: there its 8 live registers, held through the
  // product, cost its schedule more than the loads do
  float bv[8];
  auto load_bias = [&]() {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int cc = ct * 4 + (q & 3) + (q >> 2) * (TN / 2);
      bv[q] = cc < nbw ? repro::ldf(bias + cc) : 0.f;
    }
  };
  if constexpr (TN < 128) load_bias();
  float c[G::kRM][8];
  gemm_f32<TN, TM, true>(c, ring, x + static_cast<long long>(r0) * p.n_in,
                         p.n_in, p.m_pad - r0, p.n_in, p.vec_x, w, p.n_out,
                         nbw, p.vec_w, nullptr);
  if constexpr (TN == 128) load_bias();
#pragma unroll
  for (int i = 0; i < G::kRM; ++i) {
    const int r = r0 + rg + G::kRT * i;
    if (r >= m_u) continue;
    float* ur = out + r * ld + ct * 4;
    if (ct * 4 < ncols)
      *reinterpret_cast<float4*>(ur) =
          make_float4(c[i][0] + bv[0], c[i][1] + bv[1], c[i][2] + bv[2],
                      c[i][3] + bv[3]);
    if (TN / 2 + ct * 4 < ncols)
      *reinterpret_cast<float4*>(ur + TN / 2) =
          make_float4(c[i][4] + bv[4], c[i][5] + bv[5], c[i][6] + bv[6],
                      c[i][7] + bv[7]);
  }
}

template <int TN, int TM>
__device__ __forceinline__ void transform(float* out, int ld, int m_u,
                                          int ncols, unsigned char* ring,
                                          const __nv_bfloat16* x,
                                          const __nv_bfloat16* w,
                                          const __nv_bfloat16* bias, int r0,
                                          int nbw, const Params& p) {
  static_assert(TM == 64, "the bf16 row tile is 4 warps of 16 rows");
  constexpr int kNT = TN / 8;
  const int lane = threadIdx.x & 31;
  if constexpr (TN >= 32) {
    constexpr int kW = TN / 16;
    const int warp = threadIdx.x >> 5, wr = warp & 1, wc = warp >> 1;
    float bw[kW][2];
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      const int cc = wc * (TN / 2) + j * 8 + (lane & 3) * 2;
      bw[j][0] = cc < nbw ? repro::ldf(bias + cc) : 0.f;
      bw[j][1] = cc + 1 < nbw ? repro::ldf(bias + cc + 1) : 0.f;
    }
    float c[kNT][4];
    gemm_bf16<TN>(c, ring, x + static_cast<long long>(r0) * p.n_in, p.n_in,
                  p.m_pad - r0, p.n_in, p.vec_x, w, p.n_out, nbw, p.vec_w);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int rr = r0 + 32 * wr + 16 * mi + (lane >> 2);
#pragma unroll
      for (int j = 0; j < kW; ++j) {
        const int cc = wc * (TN / 2) + j * 8 + (lane & 3) * 2;
        const float* cj = c[mi * kW + j];
        if (cc >= ncols) continue;
        if (rr < m_u)
          *reinterpret_cast<float2*>(out + rr * ld + cc) =
              make_float2(cj[0] + bw[j][0], cj[1] + bw[j][1]);
        if (rr + 8 < m_u)
          *reinterpret_cast<float2*>(out + (rr + 8) * ld + cc) =
              make_float2(cj[2] + bw[j][0], cj[3] + bw[j][1]);
      }
    }
    return;
  }
  const int r = r0 + (threadIdx.x >> 5) * 16 + (lane >> 2);
  float bv[kNT][2];  // read before the product, which hides the loads
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int cc = j * 8 + (lane & 3) * 2;
    bv[j][0] = cc < nbw ? repro::ldf(bias + cc) : 0.f;
    bv[j][1] = cc + 1 < nbw ? repro::ldf(bias + cc + 1) : 0.f;
  }
  float c[kNT][4];
  gemm_bf16<TN>(c, ring, x + static_cast<long long>(r0) * p.n_in, p.n_in,
                p.m_pad - r0, p.n_in, p.vec_x, w, p.n_out, nbw, p.vec_w);
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int cc = j * 8 + (lane & 3) * 2;
    if (cc >= ncols) continue;
    if (r < m_u)
      *reinterpret_cast<float2*>(out + r * ld + cc) =
          make_float2(c[j][0] + bv[j][0], c[j][1] + bv[j][1]);
    if (r + 8 < m_u)
      *reinterpret_cast<float2*>(out + (r + 8) * ld + cc) =
          make_float2(c[j][2] + bv[j][0], c[j][3] + bv[j][1]);
  }
}

// Whether slot i of a staged run adds anything: a non-zero value (padding
// carries 0.0 anywhere in the visited chunks) at a row and column inside
// the matrix (hub slots carry the row sentinel m_pad).
template <typename V, typename I>
__device__ __forceinline__ bool live(const I* rs, const I* cs, const V* vs,
                                     int i, int m_pad) {
  return repro::to_f32(vs[i]) != 0.f &&
         static_cast<unsigned>(rs[i]) < static_cast<unsigned>(m_pad) &&
         static_cast<unsigned>(cs[i]) < static_cast<unsigned>(m_pad);
}

// Copy n elements of the index stream, from element b0, into the run
// buffers; the caller waits.
template <typename V, typename I>
__device__ __forceinline__ void stage_run(I* rs, I* cs, V* vs, const I* rid,
                                          const I* cid, const V* val, int b0,
                                          int n, const Params& p) {
  load_run(rs, rid + b0, n, p.vec_i);
  load_run(cs, cid + b0, n, p.vec_i);
  load_run(vs, val + b0, n, p.vec_v);
  cp_commit();
}

// acc[r] += sum_j v U[j] over the n slots of one (sample x channel), the
// accumulator in shared memory. The index stream is copied through the
// ring in runs of what it holds, and each run is bucketed by row: a count
// per row (integer atomics, which shared memory has; its float atomicAdd
// is a compare-and-swap loop), a prefix sum, and the live slots' positions
// in row order. Then each group of p.sub lanes owns whole rows (r = group,
// group + groups, ...), sums a row's products in registers, one column per
// lane, and adds the sum to the accumulator without an atomic.
template <typename V, typename I, int kRingBytes, int TN>
__device__ __forceinline__ void scatter_rows(float* acc, const float* us,
                                             unsigned char* ring,
                                             const I* rid, const I* cid,
                                             const V* val, int n, int m_pad,
                                             int nbw, const Params& p) {
  constexpr int kCols = TN > 32 ? TN / 32 : 1;  // columns per lane
  constexpr int kSlot = 2 * sizeof(I) + sizeof(V) + sizeof(int);
  int* ends = reinterpret_cast<int*>(ring);     // (m_pad) row starts / ends
  const int head = (m_pad + kThreads / 32 + 3) / 4 * 4;
  int* ws = ends + m_pad;
  const int cap = (kRingBytes - 4 * head) / kSlot / 8 * 8;
  I* rs = reinterpret_cast<I*>(ends + head);
  I* cs = rs + cap;
  V* vs = reinterpret_cast<V*>(cs + cap);
  int* perm = reinterpret_cast<int*>(vs + cap);
  const int lane = threadIdx.x % p.sub, group = threadIdx.x / p.sub;
  const int groups = kThreads / p.sub;
  for (int b0 = 0; b0 < n; b0 += cap) {
    const int cnt = min(cap, n - b0);
    if (b0 > 0) __syncthreads();  // the previous run is consumed
    stage_run(rs, cs, vs, rid, cid, val, b0, cnt, p);
    for (int r = threadIdx.x; r < m_pad; r += kThreads) ends[r] = 0;
    cp_wait<0>();
    __syncthreads();
    for (int i = threadIdx.x; i < cnt; i += kThreads)
      if (live(rs, cs, vs, i, m_pad)) atomicAdd(ends + rs[i], 1);
    __syncthreads();
    repro::exclusive_scan<kThreads>(ends, m_pad, ws);  // row starts
    __syncthreads();
    for (int i = threadIdx.x; i < cnt; i += kThreads)
      if (live(rs, cs, vs, i, m_pad)) perm[atomicAdd(ends + rs[i], 1)] = i;
    __syncthreads();  // ends[r]: where row r ends
    for (int r = group; r < m_pad; r += groups) {
      const int b = r ? ends[r - 1] : 0, e = ends[r];
      if (b == e) continue;
      float a[kCols];
#pragma unroll
      for (int q = 0; q < kCols; ++q) a[q] = 0.f;
      // four slots at a time: their loads are independent
      constexpr int kU = 4;
      for (int k = b; k < e; k += kU) {
        float v[kU];
        const float* urow[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int i = perm[min(k + u, e - 1)];
          v[u] = k + u < e ? repro::to_f32(vs[i]) : 0.f;
          urow[u] = us + static_cast<int>(cs[i]) * TN;
        }
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          const int cc = lane + p.sub * q;
          if (cc < nbw) {
#pragma unroll
            for (int u = 0; u < kU; ++u) a[q] = fmaf(v[u], urow[u][cc], a[q]);
          }
        }
      }
      float* arow = acc + r * TN;
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const int cc = lane + p.sub * q;
        if (cc < nbw) arow[cc] += a[q];
      }
    }
  }
}

// The hub count of sample s (the hybrid head's rows), 0 outside the hybrid
// entry.
__device__ __forceinline__ int hub_rows(const Params& p, int s) {
  if (p.slab == nullptr) return 0;
  return p.hubs ? min(max(p.hubs[s], 0), p.d_pad) : p.d_pad;
}

// The slots of channel ch of sample s that the reference visits.
__device__ __forceinline__ int stream_len(const Params& p, int s, int ch) {
  return min(max(p.chunks[s * p.channels + ch], 0) * p.chunk, p.nnz_pad);
}

template <typename V, typename D, typename I, int TN, int TM, bool kHybrid>
__global__ void __launch_bounds__(kThreads) fused_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char fused_smem[];
  constexpr int kRing = Ring<D, TN, TM>::kBytes;
  using G = Tile<TN, TM>;
  const int s = blockIdx.x;
  const int col0 = blockIdx.y * p.n_block;
  const int nbw = min(p.n_block, p.n_out - col0);
  const int m_pad = p.m_pad, m_u = (m_pad + kTK - 1) / kTK * kTK;
  unsigned char* ring = fused_smem;
  float* us = reinterpret_cast<float*>(fused_smem + kRing);
  float* acc = us + m_u * TN;  // (m_pad, TN) accumulator
  for (int i = threadIdx.x; i < m_pad * TN; i += kThreads) acc[i] = 0.f;
  // U's rows past the last row tile (56-row tiles stop short of m_u): the
  // head's last k-tile reads them against zero-filled slab columns
  for (int i = m_pad * TN + threadIdx.x; i < m_u * TN; i += kThreads)
    us[i] = 0.f;
  __syncthreads();

  const D* xs = static_cast<const D*>(p.x) +
                static_cast<size_t>(s) * m_pad * p.n_in;
  const int n_hub = kHybrid ? hub_rows(p, s) : 0;
  for (int ch = 0; ch < p.channels; ++ch) {
    const int sc = s * p.channels + ch;
    const int n = stream_len(p, s, ch);
    // the same for every thread of the block
    if (n == 0 && n_hub == 0) continue;
    const D* wch = static_cast<const D*>(p.w) +
                   static_cast<size_t>(ch) * p.n_in * p.n_out + col0;
    const D* bch = static_cast<const D*>(p.bias) +
                   static_cast<size_t>(ch) * p.n_out + col0;
    for (int r0 = 0; r0 < m_pad; r0 += TM)
      transform<TN, TM>(us, TN, m_u, TN, ring, xs, wch, bch, r0, nbw, p);
    __syncthreads();

    if constexpr (kHybrid) {
      if (n_hub > 0) {
        const float* sl = p.slab + static_cast<size_t>(sc) * p.d_pad * m_pad;
        const int ct = threadIdx.x % G::kCT, rg = threadIdx.x / G::kCT;
        for (int r0 = 0; r0 < n_hub; r0 += TM) {
          float c[G::kRM][8];
          gemm_f32<TN, TM, false>(c, ring,
                               sl + static_cast<long long>(r0) * m_pad, m_pad,
                               n_hub - r0, m_pad, p.vec_s, us, TN, TN, 16,
                               us);
#pragma unroll
          for (int i = 0; i < G::kRM; ++i) {
            const int r = r0 + rg + G::kRT * i;
            if (r >= n_hub) continue;
            float* ar = acc + r * TN + ct * 4;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              ar[q] += c[i][q];
              ar[TN / 2 + q] += c[i][4 + q];
            }
          }
        }
        __syncthreads();
      }
    }

    if (n > 0) {
      const size_t off = static_cast<size_t>(sc) * p.nnz_pad;
      const I* rid = static_cast<const I*>(p.rid) + off;
      const I* cid = static_cast<const I*>(p.cid) + off;
      const V* val = static_cast<const V*>(p.val) + off;
      scatter_rows<V, I, kRing, TN>(acc, us, ring, rid, cid, val, n, m_pad,
                                    nbw, p);
    }
    __syncthreads();  // U_ch and the ring are overwritten next
  }

  const int* rk = kHybrid ? p.rank + static_cast<size_t>(s) * m_pad : nullptr;
  const D* res = static_cast<const D*>(p.res);
  D* y = static_cast<D*>(p.y);
#pragma unroll 4
  for (int i = threadIdx.x; i < m_pad * nbw; i += kThreads) {
    const int r = i / nbw, cc = i - r * nbw;
    const size_t g = (static_cast<size_t>(s) * m_pad + r) * p.n_out + col0 +
                     cc;
    float o;
    if constexpr (kHybrid) {
      const int q = __ldg(rk + r);
      o = static_cast<unsigned>(q) < static_cast<unsigned>(m_pad)
              ? acc[q * TN + cc] : 0.f;
    } else {
      o = acc[r * TN + cc];
    }
    if (res) o += repro::ldf(res + g);
    if (p.relu) o = fmaxf(o, 0.f);
    y[g] = repro::from_f32<D>(o);
  }
}

// ---------------------------------------------------------------------------
// The large-matrix branch: two kernels a group of channels.

// What the two kernels of a channel group share besides Params.
struct Large {
  float* u;      // U of the group: (batch, g, m_pad, ldu) f32
  float* acc;    // the sums of earlier groups (batch, m_pad, ldu), or null
  int ldu;       // n_out rounded up to 4
  int c0, g;     // the group's channels [c0, c0 + g)
  int first, last;
  int rows;      // output rows a block of the second kernel owns
  int panel;     // its columns (a multiple of 4, at most 128)
  int sub;       // its lanes a row
  int vec;       // whether Y (and the residual) take 4-column accesses
  int run;       // slots it stages at a time (a multiple of 8)
  int vec_r;     // copy width of the rank map's rows (hybrid)
};

using repro::ld4;
using repro::st4;

// Kernel 1: U[s, ch] = X[s] W_ch + b_ch for the group's channels that are
// read (a channel with a slot or a hub row), one TM-row tile x TN-column
// panel a block: the fused kernel's own transform (the k-tile ring; f32
// FMA register tiles of 8 rows x 8 columns a thread at TM 128, or bf16
// mma.sync summed in f32 at TM 64), stored in f32.
template <typename D, int TN, int TM>
__global__ void __launch_bounds__(kThreads)
large_transform(const Params p, const Large l) {
  extern __shared__ __align__(16) unsigned char fused_smem[];
  const int s = blockIdx.x / l.g, ch = l.c0 + blockIdx.x % l.g;
  if (stream_len(p, s, ch) == 0 && hub_rows(p, s) == 0) return;
  const int col0 = blockIdx.z * TN;
  const int nbw = min(TN, p.n_out - col0);
  const D* xs = static_cast<const D*>(p.x) +
                static_cast<size_t>(s) * p.m_pad * p.n_in;
  const D* wch = static_cast<const D*>(p.w) +
                 static_cast<size_t>(ch) * p.n_in * p.n_out + col0;
  const D* bch = static_cast<const D*>(p.bias) +
                 static_cast<size_t>(ch) * p.n_out + col0;
  float* out = l.u + static_cast<size_t>(blockIdx.x) * p.m_pad * l.ldu + col0;
  transform<TN, TM>(out, l.ldu, p.m_pad, (nbw + 3) / 4 * 4, fused_smem, xs,
                    wch, bch, blockIdx.y * TM, nbw, p);
}

constexpr int kAgg = 256;                  // threads of kernel 2
constexpr int kAggWarps = kAgg / repro::kWarp;
constexpr int kAggSlots = 8;    // gathers a sub-warp issues together
constexpr int kAggRun = 4096;   // slots a run stages: at most 65,536
constexpr int kAggRowsMax = 256;           // rows a block owns

// Kernel 2's shared memory: the accumulator (rows x panel f32), the (row,
// warp) counts of a run, the scan's per-warp totals, the pieces of cut
// rows, then a region that
// holds a staged run (row ids, the warps' lists of the block's slots, the
// bucket's column ids and values), or a hub row's slab row and the
// sub-warps' partial sums, or the sample's rank map.
struct AggSmem {
  size_t counts, parts, region, bytes;
};
template <typename V, typename I>
__host__ __device__ constexpr AggSmem agg_smem(int rows, int panel, int run,
                                               int m_pad, bool hybrid) {
  const size_t acc = static_cast<size_t>(rows) * panel * 4;
  const size_t counts = acc;
  // the pieces of rows cut by the sub-warps' slot ranges: two partial sums
  // (kW columns a lane) and two row ids a sub-warp
  const size_t parts =
      repro::align16(counts + (static_cast<size_t>(rows) + 1) * kAggWarps * 4);
  const size_t region = parts + 2 * (kAgg * repro::kW + kAgg) * 4;
  const size_t staged = static_cast<size_t>(run) * (sizeof(I) + 3 * 4);
  const size_t head =
      hybrid ? (static_cast<size_t>((m_pad + 3) / 4 * 4) + kAgg * repro::kW) *
                   4
             : 0;
  const size_t need = staged > head ? staged : head;
  return {counts, parts, region, region + need};
}

// Kernel 2: one block a (sample x output-row block x column panel). For
// each channel of the group, in order, its stream goes through shared
// memory in runs of kAggRun slots: the row ids staged (cp.async); each
// warp takes a contiguous share of the run and lists, in order, the slots
// of the block's rows, counting them per (row, warp); one scan; each warp
// places its list 32 a step at its (row, warp) cursor plus its rank among
// the step's slots of that row (as the COO kernel buckets), reading those
// slots' column ids and values; then the walk: each sub-warp takes an
// equal share of the run's bucketed slots, continues a row's sum from the
// accumulator, adds val * U_ch[cid] slot by slot (kAggSlots gathers of U
// through the L2 issued before their FMAs, four columns a lane) and
// writes it back. A row the shares cut (a hub row of a run) is summed in
// pieces, added in sub-warp order after a barrier; every other row's sum
// is one fmaf chain over the channels in order and each channel's slots
// in order. Both are the same from run to run. The hybrid head then adds
// slab_ch[q] . U_ch onto each hub row q the block owns: the slab row
// staged, each sub-warp a partial over its share of the row's non-zero
// entries, the partials added in sub-warp order. The last group's blocks
// then store Y (the rank map, the residual, ReLU, the reference's order);
// an earlier group's store the accumulator to acc.
template <typename V, typename D, typename I, bool kHybrid>
__global__ void __launch_bounds__(kAgg)
large_aggregate(const Params p, const Large l) {
  extern __shared__ __align__(16) unsigned char fused_smem[];
  constexpr int kW = repro::kW;
  const AggSmem lay = agg_smem<V, I>(l.rows, l.panel, l.run, p.m_pad,
                                     kHybrid);
  const int s = blockIdx.x;
  const int m_pad = p.m_pad;
  const int row0 = blockIdx.y * l.rows;
  const int rows = min(l.rows, m_pad - row0);
  const int col0 = blockIdx.z * l.panel;
  const int nbw = min(l.panel, p.n_out - col0);
  const int lane = threadIdx.x % l.sub, g = threadIdx.x / l.sub;
  const int groups = kAgg / l.sub;
  const int cc = kW * lane;
  const bool mine = cc < nbw;
  const int warp = threadIdx.x / repro::kWarp;
  const int wl = threadIdx.x % repro::kWarp;
  float* acc_s = reinterpret_cast<float*>(fused_smem);
  int* ends = reinterpret_cast<int*>(fused_smem + lay.counts);
  int* ws = ends + rows * kAggWarps;
  float* part_first = reinterpret_cast<float*>(fused_smem + lay.parts);
  float* part_last = part_first + kAgg * kW;
  int* row_first = reinterpret_cast<int*>(part_last + kAgg * kW);
  int* row_last = row_first + kAgg;
  unsigned char* region = fused_smem + lay.region;
  I* rs = reinterpret_cast<I*>(region);                     // run's row ids
  int* lst = reinterpret_cast<int*>(rs + l.run);            // warps' lists
  int* bcol = lst + l.run;                                  // the bucket
  float* bval = reinterpret_cast<float*>(bcol + l.run);
  const auto acc_row = [&](int lr) { return acc_s + lr * l.panel + cc; };
  const auto row_start = [&](int lr) {
    return lr ? ends[lr * kAggWarps - 1] : 0;
  };

  // the accumulator: 0.0, or the earlier groups' sums
  for (int i = threadIdx.x; i < rows * l.panel; i += kAgg) {
    const int lr = i / l.panel, col = i - lr * l.panel;
    acc_s[i] = l.first || col >= nbw
                   ? 0.f
                   : l.acc[(static_cast<size_t>(s) * m_pad + row0 + lr) *
                               l.ldu + col0 + col];
  }

  const unsigned below = (1u << wl) - 1u;
  for (int ch = l.c0; ch < l.c0 + l.g; ++ch) {
    const int n = stream_len(p, s, ch);
    const float* uch = l.u +
                       static_cast<size_t>(s * l.g + ch - l.c0) * m_pad *
                           l.ldu + col0;
    const size_t off = static_cast<size_t>(s * p.channels + ch) * p.nnz_pad;
    const I* rid = static_cast<const I*>(p.rid) + off;
    const I* cid = static_cast<const I*>(p.cid) + off;
    const V* val = static_cast<const V*>(p.val) + off;
    for (int b0 = 0; b0 < n; b0 += l.run) {
      const int len = min(l.run, n - b0);
      __syncthreads();   // the last run (and the accumulator's init) is done
      load_run<I, kAgg>(rs, rid + b0, len, p.vec_i);
      cp_commit();
      for (int i = threadIdx.x; i < rows * kAggWarps; i += kAgg) ends[i] = 0;
      cp_wait<0>();
      __syncthreads();
      // each warp's contiguous share of the run, whole steps of 32 slots:
      // the slots of the block's rows go to the warp's list, in order, as
      // (row << 16 | slot), and count in (row, warp)
      const int share = ((len + kAggWarps - 1) / kAggWarps + repro::kWarp -
                         1) / repro::kWarp * repro::kWarp;
      const int lo = min(warp * share, len), hi = min(lo + share, len);
      int cnt = 0;
      for (int base = lo; base < hi; base += repro::kWarp) {
        const int i = base + wl;
        const int lr = i < hi ? static_cast<int>(rs[i]) - row0 : -1;
        const bool in = static_cast<unsigned>(lr) <
                        static_cast<unsigned>(rows);
        const unsigned took = __ballot_sync(0xffffffffu, in);
        if (in) {
          lst[lo + cnt + __popc(took & below)] = lr << 16 | i;
          atomicAdd(ends + lr * kAggWarps + warp, 1);
        }
        cnt += __popc(took);
      }
      __syncthreads();
      repro::exclusive_scan<kAgg>(ends, rows * kAggWarps, ws);
      __syncthreads();
      // each warp places its list, 32 a step, at its (row, warp) cursor
      // plus its rank among the step's entries of that row (the entry
      // becomes (place << 16 | slot)), then reads the slots' column ids
      // and values into their places, every load independent of the
      // others; a slot whose value is 0.0 or whose column lies outside the
      // matrix keeps its place and adds nothing (column -1)
      for (int t = 0; t < cnt; t += repro::kWarp) {
        const int e = t + wl < cnt ? lst[lo + t + wl] : -1;
        const int lr = e >= 0 ? e >> 16 : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, lr);
        if (lr >= 0)
          lst[lo + t + wl] = (ends[lr * kAggWarps + warp] +
                              __popc(peers & below)) << 16 | (e & 0xffff);
        __syncwarp();
        if (lr >= 0 && wl == 31 - __clz(peers))
          ends[lr * kAggWarps + warp] += __popc(peers);
        __syncwarp();
      }
      for (int t = wl; t < cnt; t += repro::kWarp) {
        const int e = lst[lo + t], pos = e >> 16, i = b0 + (e & 0xffff);
        const int j = repro::ldi(cid + i);
        const float v = repro::ldv(val + i);
        bcol[pos] = v == 0.f || static_cast<unsigned>(j) >=
                                    static_cast<unsigned>(m_pad)
                        ? -1 : j;
        bval[pos] = v;
      }
      __syncthreads();   // ends[lr * kAggWarps + kAggWarps - 1]: row lr's end
      // sub-warp g walks the bucketed slots [ka, kb), its equal share of
      // the run's. A row inside it continues its chain from the
      // accumulator; a row the share boundaries cut (a hub row) is summed
      // in pieces: the piece its first sub-warp walks continues the chain
      // (kept in part_last), each later piece starts from 0.0 (part_first),
      // and the first sub-warp adds the later pieces in sub-warp order
      const int total = row_start(rows);
      const int ka = static_cast<int>(1LL * g * total / groups);
      const int kb = static_cast<int>(1LL * (g + 1) * total / groups);
      if (mine) {
        row_first[g] = ka < kb ? -1 : -2;   // -2: an empty share
        row_last[g] = -1;
      }
      if (mine && ka < kb) {
        int r = 0, z = rows;   // the row holding slot ka: its end is past ka
        while (r < z) {
          const int mid = (r + z) / 2;
          if (row_start(mid + 1) > ka)
            z = mid;
          else
            r = mid + 1;
        }
        bool cut = row_start(r) < ka;   // the piece at ka is not its first
        float a[kW] = {};
        if (!cut) ld4(a, acc_row(r));
        // the piece of row r that ends here: to the accumulator, or kept
        const auto close = [&](bool last) {
          if (cut) {
            st4(part_first + g * l.panel + cc, a);
            row_first[g] = r;
          } else if (last && row_start(r + 1) > kb) {
            st4(part_last + g * l.panel + cc, a);
            row_last[g] = r;
          } else {
            st4(acc_row(r), a);
          }
        };
        for (int k0 = ka; k0 < kb; k0 += kAggSlots) {
          int j[kAggSlots];
          float v[kAggSlots];
#pragma unroll
          for (int q = 0; q < kAggSlots; ++q) {
            j[q] = k0 + q < kb ? bcol[k0 + q] : -1;
            v[q] = k0 + q < kb ? bval[k0 + q] : 0.f;
          }
          float x[kAggSlots][kW];
#pragma unroll
          for (int q = 0; q < kAggSlots; ++q)
            if (j[q] >= 0)
              repro::load_cols(uch + static_cast<size_t>(j[q]) * l.ldu + cc,
                               true, kW, x[q]);
#pragma unroll
          for (int q = 0; q < kAggSlots; ++q) {
            if (k0 + q >= kb) break;
            while (k0 + q >= row_start(r + 1)) {
              close(false);
              cut = false;
              ld4(a, acc_row(++r));
            }
            if (j[q] < 0) continue;
#pragma unroll
            for (int i = 0; i < kW; ++i) a[i] = fmaf(v[q], x[q][i], a[i]);
          }
        }
        close(true);
      }
      __syncthreads();
      if (mine && row_last[g] >= 0) {
        float a[kW], p[kW];
        ld4(a, part_last + g * l.panel + cc);
        for (int h = g + 1; h < groups && (row_first[h] == row_last[g] ||
                                           row_first[h] == -2);
             ++h) {
          if (row_first[h] < 0) continue;
          ld4(p, part_first + h * l.panel + cc);
#pragma unroll
          for (int i = 0; i < kW; ++i) a[i] += p[i];
        }
        st4(acc_row(row_last[g]), a);
      }
    }
  }

  if constexpr (kHybrid) {
    float* slab_row = reinterpret_cast<float*>(region);
    float* part = slab_row + (m_pad + 3) / 4 * 4;   // groups x panel
    const int hub_end = min(row0 + rows, hub_rows(p, s));
    for (int q = row0; q < hub_end; ++q) {
      float h[kW] = {};
      for (int ch = l.c0; ch < l.c0 + l.g; ++ch) {
        __syncthreads();   // the region is free
        load_run<float, kAgg>(
            slab_row,
            p.slab + (static_cast<size_t>(s * p.channels + ch) * p.d_pad +
                      q) * m_pad,
            m_pad, p.vec_s);
        cp_commit();
        cp_wait<0>();
        __syncthreads();
        if (!mine) continue;
        const float* uch = l.u +
                           static_cast<size_t>(s * l.g + ch - l.c0) * m_pad *
                               l.ldu + col0;
        // this sub-warp's share of the row, non-zero entries only (a zero
        // adds fmaf(0, u, h) == h)
        const int m1 = static_cast<int>(
            static_cast<long long>(g + 1) * m_pad / groups);
        for (int mb = static_cast<int>(static_cast<long long>(g) * m_pad /
                                       groups);
             mb < m1; mb += kAggSlots) {
          float sv[kAggSlots], x[kAggSlots][kW];
#pragma unroll
          for (int q2 = 0; q2 < kAggSlots; ++q2) {
            sv[q2] = mb + q2 < m1 ? slab_row[mb + q2] : 0.f;
            if (sv[q2] != 0.f)
              repro::load_cols(
                  uch + static_cast<size_t>(mb + q2) * l.ldu + cc, true, kW,
                  x[q2]);
          }
#pragma unroll
          for (int q2 = 0; q2 < kAggSlots; ++q2)
            if (sv[q2] != 0.f)
#pragma unroll
              for (int i = 0; i < kW; ++i) h[i] = fmaf(sv[q2], x[q2][i], h[i]);
        }
      }
      __syncthreads();   // the slab row is read; part overlaps nothing live
      if (mine) st4(part + g * l.panel + cc, h);
      __syncthreads();
      if (g == 0 && mine) {
        float* ar = acc_row(q - row0);
#pragma unroll
        for (int gg = 0; gg < groups; ++gg)
#pragma unroll
          for (int i = 0; i < kW; ++i) ar[i] += part[gg * l.panel + cc + i];
      }
    }
  }
  __syncthreads();

  if (!l.last) {   // an earlier group: keep the sums for the next
    for (int i = threadIdx.x; i < rows * l.panel; i += kAgg) {
      const int lr = i / l.panel, col = i - lr * l.panel;
      if (col < nbw)
        l.acc[(static_cast<size_t>(s) * m_pad + row0 + lr) * l.ldu + col0 +
              col] = acc_s[i];
    }
    return;
  }
  // Y row r from accumulator row lr (-1: none, 0.0), plus the residual,
  // ReLU, rounded once to D
  const D* res = static_cast<const D*>(p.res);
  D* y = static_cast<D*>(p.y);
  const auto store_y = [&](int r, int lr) {
    float o[kW] = {};
    if (lr >= 0) ld4(o, acc_row(lr));
    const size_t gi = (static_cast<size_t>(s) * m_pad + r) * p.n_out + col0 +
                      cc;
    if (res) {
      float rv[kW];
      repro::load_cols(res + gi, l.vec, nbw - cc, rv);
#pragma unroll
      for (int i = 0; i < kW; ++i) o[i] += rv[i];
    }
    if (p.relu)
#pragma unroll
      for (int i = 0; i < kW; ++i) o[i] = fmaxf(o[i], 0.f);
    repro::store_cols(y + gi, o, l.vec, nbw - cc);
  };
  if constexpr (kHybrid) {
    // output row r reads accumulator row rank[r]: every block scans the
    // sample's rank map for the rows it owns (the first row block also
    // takes rows whose rank lies outside the matrix, which read 0.0)
    int* rk = reinterpret_cast<int*>(region);
    load_run<int, kAgg>(rk, p.rank + static_cast<size_t>(s) * m_pad, m_pad,
                        l.vec_r);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    if (!mine) return;
    for (int r = g; r < m_pad; r += groups) {
      const int q = rk[r];
      const int lr = q - row0;
      if (static_cast<unsigned>(lr) < static_cast<unsigned>(rows))
        store_y(r, lr);
      else if (blockIdx.y == 0 &&
               static_cast<unsigned>(q) >= static_cast<unsigned>(m_pad))
        store_y(r, -1);
    }
  } else {
    if (!mine) return;
    for (int lr = g; lr < rows; lr += groups) store_y(row0 + lr, lr);
  }
}

// The widest copy (16, 8 or 4 bytes, else the element) that every row of an
// array at ptr with these byte strides starts on.
int vec_of(const void* ptr, long long a, long long b, int elem) {
  for (int v = 16; v > elem; v >>= 1)
    if (reinterpret_cast<uintptr_t>(ptr) % v == 0 && a % v == 0 && b % v == 0)
      return v;
  return elem;
}

int tile_cols(int n_block) {
  return n_block <= 16 ? 16 : n_block <= 32 ? 32 : n_block <= 64 ? 64 : 128;
}

// Whether row tiles of 56 rows pad m_pad less than tiles of 64 (m_pad 56,
// the Tox21 and Reaction100 waves: 12.5% less work); the f32 entries at
// 128 columns take them (Tile<128, 56>: 7 rows a thread).
bool rows56(int m_pad) {
  return (m_pad + 55) / 56 * 56 < (m_pad + 63) / 64 * 64;
}

// A kernel's opt-in to more than 48 KB of shared memory, and, once, its
// carve-out: as much of the SM's memory as shared memory as it takes (two
// blocks of 110 KB, Reaction100's, share an SM only then).
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem, bool* carved) {
  cudaError_t e = repro::allow_smem(kernel, smem);
  if (e != cudaSuccess || *carved) return e;
  *carved = true;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename V, typename D, typename I, int TN, int TM, bool kHybrid>
int run(const Params& p, int batch, void* stream) {
  using R = Ring<D, TN, TM>;
  const int m_u = (p.m_pad + kTK - 1) / kTK * kTK;
  const int panels = (p.n_out + p.n_block - 1) / p.n_block;
  const long long panel = static_cast<long long>(m_u + p.m_pad) * TN;
  const size_t smem = R::kBytes + panel * 4;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // scatter_rows' row buckets and at least a short run fit the ring
  if (4 * (p.m_pad + 8) + 8 * (2 * sizeof(I) + sizeof(V) + 4) >
      static_cast<size_t>(R::kBytes))
    return cudaErrorInvalidValue;
  auto kernel = fused_kernel<V, D, I, TN, TM, kHybrid>;
  static bool carved = false;
  const cudaError_t e = prepare(kernel, smem, &carved);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(batch, panels), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

// The large-matrix branch: U of as many channels at a time as the scratch
// holds (all of them where it holds their U; else g a group and an
// accumulator (batch, m_pad, ldu) between the groups), two kernels a group.
template <typename V, typename D, typename I, bool kHybrid, int TN>
int run_large(Params p, int batch, long long scratch_floats, void* stream) {
  constexpr int TM = sizeof(D) == 4 ? 128 : 64;   // the transform's rows
  const int ldu = (p.n_out + 3) / 4 * 4;
  const long long per_ch = static_cast<long long>(batch) * p.m_pad * ldu;
  int g = p.channels;
  if (scratch_floats < per_ch * p.channels)
    g = static_cast<int>(scratch_floats / per_ch - 1);
  if (p.scratch == nullptr || g < 1) return cudaErrorInvalidValue;
  const int es = sizeof(D);
  const int t_panels = (p.n_out + TN - 1) / TN;
  p.vec_w = vec_of(p.w, 1LL * p.n_out * es, t_panels > 1 ? 1LL * TN * es : 0,
                   es);
  const int panel = std::min(ldu, repro::kPanelMax);
  const int a_panels = (p.n_out + panel - 1) / panel;
  const int run = std::max(8, std::min((p.nnz_pad + 7) / 8 * 8, kAggRun));
  const size_t vy = 4 * sizeof(D);
  Large l{p.scratch, g < p.channels ? p.scratch + per_ch * g : nullptr, ldu,
          0, g, 1, 0, 0, panel, repro::sub_warp(panel / 4),
          p.n_out % 4 == 0 && reinterpret_cast<uintptr_t>(p.y) % vy == 0 &&
              reinterpret_cast<uintptr_t>(p.res) % vy == 0,
          run, p.rank ? vec_of(p.rank, 4LL * p.m_pad, 0, 4) : 4};
  auto transform_k = large_transform<D, TN, TM>;
  auto aggregate_k = large_aggregate<V, D, I, kHybrid>;
  // kernel 2: as many row blocks a sample as its registers let the card
  // hold at once (one wave), at least ceil(m_pad / kAggRowsMax), each with
  // its accumulator in shared memory
  const size_t most = agg_smem<V, I>(kAggRowsMax, panel, run, p.m_pad,
                                     kHybrid).bytes;
  static bool t_carved = false, a_carved = false;
  static int resident = 0;
  const size_t t_smem = Ring<D, TN, TM>::kBytes;
  if (t_smem > kMaxSmem || most > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = prepare(transform_k, t_smem, &t_carved);
  if (e == cudaSuccess) e = prepare(aggregate_k, most, &a_carved);
  if (e == cudaSuccess && resident == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, aggregate_k,
                                                      kAgg, 0);
    resident = std::max(resident, 1);
  }
  if (e != cudaSuccess) return e;
  const long long fit = static_cast<long long>(sm_count()) * resident /
                        (1LL * batch * a_panels);
  const int blocks = static_cast<int>(std::min<long long>(
      p.m_pad, std::max<long long>(fit, (p.m_pad + kAggRowsMax - 1) /
                                            kAggRowsMax)));
  l.rows = (p.m_pad + blocks - 1) / blocks;
  const size_t a_smem = agg_smem<V, I>(l.rows, panel, run, p.m_pad,
                                       kHybrid).bytes;
  const auto st = static_cast<cudaStream_t>(stream);
  for (int c0 = 0; c0 < p.channels; c0 += g) {
    l.c0 = c0;
    l.g = std::min(g, p.channels - c0);
    l.first = c0 == 0;
    l.last = c0 + l.g == p.channels;
    transform_k<<<dim3(batch * l.g, (p.m_pad + TM - 1) / TM, t_panels),
                  kThreads, t_smem, st>>>(p, l);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    aggregate_k<<<dim3(batch, (p.m_pad + l.rows - 1) / l.rows, a_panels),
                  kAgg, a_smem, st>>>(p, l);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

template <typename V, typename D, typename I, bool kHybrid>
int launch(Params p, int batch, int large, long long scratch_floats,
           void* stream) {
  if (p.n_block < 1 || p.n_block > 128 || p.m_pad < 1)
    return cudaErrorInvalidValue;
  const int es = sizeof(D), is = sizeof(I), vs = sizeof(V);
  const int panels = (p.n_out + p.n_block - 1) / p.n_block;
  p.sub = repro::sub_warp(p.n_block);
  p.vec_x = vec_of(p.x, 1LL * p.n_in * es, 0, es);
  p.vec_w = vec_of(p.w, 1LL * p.n_out * es,
                   panels > 1 ? 1LL * p.n_block * es : 0, es);
  p.vec_s = p.slab ? vec_of(p.slab, 4LL * p.m_pad, 0, 4) : 4;
  p.vec_i = std::min(vec_of(p.rid, 1LL * p.nnz_pad * is, 0, is),
                     vec_of(p.cid, 1LL * p.nnz_pad * is, 0, is));
  p.vec_v = vec_of(p.val, 1LL * p.nnz_pad * vs, 0, vs);
  if (large) {
    if (p.n_out <= 32)
      return run_large<V, D, I, kHybrid, 32>(p, batch, scratch_floats,
                                             stream);
    if (p.n_out <= 64)
      return run_large<V, D, I, kHybrid, 64>(p, batch, scratch_floats,
                                             stream);
    return run_large<V, D, I, kHybrid, 128>(p, batch, scratch_floats,
                                            stream);
  }
  switch (tile_cols(p.n_block)) {
    case 16: return run<V, D, I, 16, 64, kHybrid>(p, batch, stream);
    case 32: return run<V, D, I, 32, 64, kHybrid>(p, batch, stream);
    case 64: return run<V, D, I, 64, 64, kHybrid>(p, batch, stream);
    default:
      if constexpr (sizeof(D) == 4) {
        if (rows56(p.m_pad))
          return run<V, D, I, 128, 56, kHybrid>(p, batch, stream);
      }
      return run<V, D, I, 128, 64, kHybrid>(p, batch, stream);
  }
}

Params params(const void* rid, const void* cid, const void* val,
              const int* chunks, const void* x, const void* w,
              const void* bias, const void* res, void* y, float* scratch,
              int channels, int nnz_pad, int chunk, int m_pad, int n_in,
              int n_out, int n_block, int relu) {
  Params p{};
  p.rid = rid;
  p.cid = cid;
  p.val = val;
  p.chunks = chunks;
  p.x = x;
  p.w = w;
  p.bias = bias;
  p.res = res;
  p.y = y;
  p.scratch = scratch;
  p.channels = channels;
  p.nnz_pad = nnz_pad;
  p.chunk = chunk;
  p.m_pad = m_pad;
  p.n_in = n_in;
  p.n_out = n_out;
  p.n_block = n_block;
  p.relu = relu;
  return p;
}

}  // namespace

// ids (batch, channels, nnz_pad) int32; val, x, w, bias, res and y f32.
// large != 0: the large-matrix branch, U in scratch (scratch_floats f32:
// batch * m_pad * ldu for each channel whose U it holds at once, plus one
// more for the accumulator where that is fewer than all; ldu = n_out
// rounded up to 4; kernels/fused_graph_conv.py, fused_large_scratch).
extern "C" int fused_graph_conv_f32(
    const int* rid, const int* cid, const float* val, const int* chunks,
    const float* x, const float* w, const float* bias, const float* res,
    float* y, float* scratch, long long scratch_floats, int batch,
    int channels, int nnz_pad, int chunk, int m_pad, int n_in, int n_out,
    int n_block, int relu, int large, void* stream) {
  return launch<float, float, int, false>(
      params(rid, cid, val, chunks, x, w, bias, res, y, scratch, channels,
             nnz_pad, chunk, m_pad, n_in, n_out, n_block, relu),
      batch, large, scratch_floats, stream);
}

// rank (batch, m_pad), slab (batch, channels, d_pad, m_pad), d_pad >= 1;
// hubs (batch,) the hub count of each sample, or null for d_pad each.
extern "C" int fused_graph_conv_hybrid_f32(
    const int* rid, const int* cid, const float* val, const int* chunks,
    const float* x, const float* w, const float* bias, const float* res,
    const int* rank, const float* slab, const int* hubs, float* y,
    float* scratch, long long scratch_floats, int batch, int channels,
    int nnz_pad, int chunk, int m_pad, int n_in, int n_out, int n_block,
    int d_pad, int relu, int large, void* stream) {
  if (d_pad < 1 || d_pad > m_pad || rank == nullptr || slab == nullptr)
    return cudaErrorInvalidValue;
  Params p = params(rid, cid, val, chunks, x, w, bias, res, y, scratch,
                    channels, nnz_pad, chunk, m_pad, n_in, n_out, n_block,
                    relu);
  p.rank = rank;
  p.slab = slab;
  p.hubs = hubs;
  p.d_pad = d_pad;
  return launch<float, float, int, true>(p, batch, large, scratch_floats,
                                         stream);
}

// ids (batch, channels, nnz_pad) int16; val, x, w, bias, res and y bf16
extern "C" int fused_graph_conv_bf16(
    const void* rid, const void* cid, const void* val, const int* chunks,
    const void* x, const void* w, const void* bias, const void* res, void* y,
    float* scratch, long long scratch_floats, int batch, int channels,
    int nnz_pad, int chunk, int m_pad, int n_in, int n_out, int n_block,
    int relu, int large, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16, short, false>(
      params(rid, cid, val, chunks, x, w, bias, res, y, scratch, channels,
             nnz_pad, chunk, m_pad, n_in, n_out, n_block, relu),
      batch, large, scratch_floats, stream);
}
