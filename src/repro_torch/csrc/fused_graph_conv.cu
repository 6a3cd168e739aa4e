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
// Large matrices (template kLarge: the plan's U_ch and accumulator panels
// do not fit a block, m_pad past ~750 at 32 columns): the same steps with
// U_ch and the accumulator in a block-private region of a global f32
// scratch the wrapper allocates; the block writes its U_ch panel, passes a
// barrier, and the scatter adds each slot with global atomics on its own
// region (native for floats; the row buckets would not fit the ring); the
// head stages U_ch k-tiles through the ring. Still one launch per call.
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

// n elements of T at src into dst (n rounded up to a whole copy).
template <typename T, int kVB>
__device__ __forceinline__ void run_chunks(T* dst, const T* src, int n) {
  constexpr int kE = kVB / static_cast<int>(sizeof(T));
  for (int i = threadIdx.x; i * kE < n; i += kThreads) {
    const int c = i * kE;
    cp_async<kVB>(dst + c, src + c,
                  min(kE, n - c) * static_cast<int>(sizeof(T)));
  }
}

template <typename T>
__device__ __forceinline__ void load_run(T* dst, const T* src, int n,
                                         int vec) {
  if (vec == 16) {
    run_chunks<T, 16>(dst, src, n);
  } else if (vec == 8) {
    run_chunks<T, 8>(dst, src, n);
  } else if (vec == 4) {
    run_chunks<T, 4>(dst, src, n);
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
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

// U rows [r0, r0 + row tile) of one channel: X W + b into us (row stride
// TN), rows below m_u only.
template <int TN, int TM>
__device__ __forceinline__ void transform(float* us, unsigned char* ring,
                                          const float* x, const float* w,
                                          const float* bias, int r0, int m_u,
                                          int nbw, const Params& p) {
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
    float* ur = us + r * TN + ct * 4;
    *reinterpret_cast<float4*>(ur) =
        make_float4(c[i][0] + bv[0], c[i][1] + bv[1], c[i][2] + bv[2],
                    c[i][3] + bv[3]);
    *reinterpret_cast<float4*>(ur + TN / 2) =
        make_float4(c[i][4] + bv[4], c[i][5] + bv[5], c[i][6] + bv[6],
                    c[i][7] + bv[7]);
  }
}

template <int TN, int TM>
__device__ __forceinline__ void transform(float* us, unsigned char* ring,
                                          const __nv_bfloat16* x,
                                          const __nv_bfloat16* w,
                                          const __nv_bfloat16* bias, int r0,
                                          int m_u, int nbw, const Params& p) {
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
        if (rr < m_u)
          *reinterpret_cast<float2*>(us + rr * TN + cc) =
              make_float2(cj[0] + bw[j][0], cj[1] + bw[j][1]);
        if (rr + 8 < m_u)
          *reinterpret_cast<float2*>(us + (rr + 8) * TN + cc) =
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
    if (r < m_u)
      *reinterpret_cast<float2*>(us + r * TN + cc) =
          make_float2(c[j][0] + bv[j][0], c[j][1] + bv[j][1]);
    if (r + 8 < m_u)
      *reinterpret_cast<float2*>(us + (r + 8) * TN + cc) =
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

// The same with the accumulator in global memory (kLarge), where the
// row buckets would not fit the ring: each group of p.sub lanes takes a
// contiguous share of a run and adds each live slot's products with
// global atomics (native for floats), one column per lane.
template <typename V, typename I, int kRingBytes, int TN>
__device__ __forceinline__ void scatter_atomic(float* acc, const float* us,
                                               unsigned char* ring,
                                               const I* rid, const I* cid,
                                               const V* val, int n,
                                               int m_pad, int nbw,
                                               const Params& p) {
  constexpr int kCap = kRingBytes / (2 * sizeof(I) + sizeof(V)) / 8 * 8;
  I* rs = reinterpret_cast<I*>(ring);
  I* cs = rs + kCap;
  V* vs = reinterpret_cast<V*>(cs + kCap);
  const int lane = threadIdx.x % p.sub, group = threadIdx.x / p.sub;
  const int groups = kThreads / p.sub;
  for (int b0 = 0; b0 < n; b0 += kCap) {
    const int cnt = min(kCap, n - b0);
    if (b0 > 0) __syncthreads();  // the previous run is consumed
    stage_run(rs, cs, vs, rid, cid, val, b0, cnt, p);
    cp_wait<0>();
    __syncthreads();
    for (int i = group; i < cnt; i += groups) {
      if (!live(rs, cs, vs, i, m_pad)) continue;
      const float v = repro::to_f32(vs[i]);
      const float* urow = us + static_cast<int>(cs[i]) * TN;
      float* arow = acc + static_cast<int>(rs[i]) * TN;
      for (int cc = lane; cc < nbw; cc += p.sub)
        atomicAdd(arow + cc, v * urow[cc]);
    }
  }
}

template <typename V, typename D, typename I, int TN, int TM, bool kHybrid,
          bool kLarge>
__global__ void __launch_bounds__(kThreads) fused_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char fused_smem[];
  constexpr int kRing = Ring<D, TN, TM>::kBytes;
  using G = Tile<TN, TM>;
  const int s = blockIdx.x;
  const int col0 = blockIdx.y * p.n_block;
  const int nbw = min(p.n_block, p.n_out - col0);
  const int m_pad = p.m_pad, m_u = (m_pad + kTK - 1) / kTK * kTK;
  unsigned char* ring = fused_smem;
  float* us;
  if constexpr (kLarge)
    us = p.scratch + static_cast<size_t>(blockIdx.x * gridDim.y + blockIdx.y) *
                         (m_u + m_pad) * TN;
  else
    us = reinterpret_cast<float*>(fused_smem + kRing);
  float* acc = us + m_u * TN;  // (m_pad, TN) accumulator
  for (int i = threadIdx.x; i < m_pad * TN; i += kThreads) acc[i] = 0.f;
  // U's rows past the last row tile (56-row tiles stop short of m_u): the
  // head's last k-tile reads them against zero-filled slab columns
  for (int i = m_pad * TN + threadIdx.x; i < m_u * TN; i += kThreads)
    us[i] = 0.f;
  __syncthreads();

  const D* xs = static_cast<const D*>(p.x) +
                static_cast<size_t>(s) * m_pad * p.n_in;
  int n_hub = 0;
  if constexpr (kHybrid)
    n_hub = p.hubs ? min(max(p.hubs[s], 0), p.d_pad) : p.d_pad;
  for (int ch = 0; ch < p.channels; ++ch) {
    const int sc = s * p.channels + ch;
    const int n = min(max(p.chunks[sc], 0) * p.chunk, p.nnz_pad);
    // the same for every thread of the block
    if (n == 0 && n_hub == 0) continue;
    const D* wch = static_cast<const D*>(p.w) +
                   static_cast<size_t>(ch) * p.n_in * p.n_out + col0;
    const D* bch = static_cast<const D*>(p.bias) +
                   static_cast<size_t>(ch) * p.n_out + col0;
    for (int r0 = 0; r0 < m_pad; r0 += TM)
      transform<TN, TM>(us, ring, xs, wch, bch, r0, m_u, nbw, p);
    __syncthreads();

    if constexpr (kHybrid) {
      if (n_hub > 0) {
        const float* sl = p.slab + static_cast<size_t>(sc) * p.d_pad * m_pad;
        const int ct = threadIdx.x % G::kCT, rg = threadIdx.x / G::kCT;
        for (int r0 = 0; r0 < n_hub; r0 += TM) {
          float c[G::kRM][8];
          gemm_f32<TN, TM, kLarge>(c, ring,
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
      if constexpr (kLarge)
        scatter_atomic<V, I, kRing, TN>(acc, us, ring, rid, cid, val, n,
                                        m_pad, nbw, p);
      else
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

template <typename V, typename D, typename I, int TN, int TM, bool kHybrid,
          bool kLarge>
int run(const Params& p, int batch, long long scratch_floats, void* stream) {
  using R = Ring<D, TN, TM>;
  const int m_u = (p.m_pad + kTK - 1) / kTK * kTK;
  const int panels = (p.n_out + p.n_block - 1) / p.n_block;
  const long long panel = static_cast<long long>(m_u + p.m_pad) * TN;
  const size_t smem = R::kBytes + (kLarge ? 0 : panel * 4);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // scatter_rows' row buckets and at least a short run fit the ring
  if (!kLarge && 4 * (p.m_pad + 8) + 8 * (2 * sizeof(I) + sizeof(V) + 4) >
                     static_cast<size_t>(R::kBytes))
    return cudaErrorInvalidValue;
  if (kLarge && (p.scratch == nullptr ||
                 scratch_floats < static_cast<long long>(batch) * panels *
                                      panel))
    return cudaErrorInvalidValue;
  auto kernel = fused_kernel<V, D, I, TN, TM, kHybrid, kLarge>;
  cudaError_t e = repro::allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  // as much of the SM's memory as shared memory as it takes: two blocks of
  // 110 KB (Reaction100) share an SM only then
  static bool carved = false;
  if (!carved) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    carved = true;
  }
  kernel<<<dim3(batch, panels), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
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
#define REPRO_FUSED_RUN(TN, TM)                                            \
  return large ? run<V, D, I, TN, TM, kHybrid, true>(p, batch,             \
                                                     scratch_floats, stream) \
               : run<V, D, I, TN, TM, kHybrid, false>(p, batch,            \
                                                      scratch_floats, stream)
  switch (tile_cols(p.n_block)) {
    case 16: REPRO_FUSED_RUN(16, 64);
    case 32: REPRO_FUSED_RUN(32, 64);
    case 64: REPRO_FUSED_RUN(64, 64);
    default:
      if constexpr (sizeof(D) == 4) {
        if (rows56(p.m_pad)) REPRO_FUSED_RUN(128, 56);
      }
      REPRO_FUSED_RUN(128, 64);
  }
#undef REPRO_FUSED_RUN
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
// large != 0: U_ch and the accumulator in scratch (scratch_floats f32, at
// least batch * panels * (m_u + m_pad) * tile columns).
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
