// The K-streaming f32 mainloop of the port's dense products, shared by the
// batched GEMM (batched_gemm.cu) and the grouped matmul (grouped_matmul.cu),
// so that the port keeps one mainloop.
//
// A block owns a row tile of bm = TM x (blockDim.x / kLanes) rows of A and
// a panel of kPanel = kLanes x 4 x CW columns of C, held in registers as TM
// rows x 4 CW columns a thread (kLanes threads along the panel, a row
// group of TM rows for every kLanes threads; thread tx holds the columns
// 64 c + 4 tx .. + 3 of the panel for c < CW, so that a warp's B reads are
// contiguous). K streams through a ring of kStages slabs of kSlab in shared
// memory, filled by cp.async (16-, 8- or 4-byte copies, whichever the
// rows' alignment allows, zero-filled past the matrix and wherever the
// caller's row predicate says no), so three slabs are in flight while one
// is computed. A stays row-major in the ring (cp.async copies bytes as they
// lie), its 16-byte chunks XOR-swizzled by row group so that the two row
// groups of a warp hit other banks; a thread reads 4 k of each of its rows
// as one float4 and B's 4 columns of each k as one float4: TM x 4 x 4 CW
// FMAs for TM + 4 CW shared-memory loads (TM 8: 128 for 12 at CW 1, 256
// for 16 at CW 2).
//
// Every output is one fmaf chain over k in increasing order from 0.0: a
// zero-filled k or row adds fmaf(0, b, acc) == acc (b finite; acc is never
// -0.0), so the result is the same bits whatever the tile.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace repro::gemm {

constexpr int kLanes = 16;       // threads along a panel's columns
constexpr int kMaxGroups = 16;   // row groups: at most 256 threads a block
constexpr int kSlab = 16;        // K per ring stage
constexpr int kStages = 4;       // ring depth

template <int TM, int CW>
struct Tile {
  static constexpr int kCols = 4 * CW;             // columns a thread holds
  static constexpr int kPanel = kLanes * kCols;    // columns a block owns
  // the ring: kStages x ((bm, kSlab) of A + (kSlab, kPanel) of B)
  __host__ __device__ static constexpr size_t smem_bytes(int bm) {
    return static_cast<size_t>(kStages) * (bm + kPanel) * kSlab *
           sizeof(float);
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16, 8 or 4 bytes from global to shared memory; src_bytes 0 zero-fills.
__device__ __forceinline__ void cp16(void* dst, const void* src,
                                     int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp8(void* dst, const void* src,
                                    int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
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

// The widest copy (in floats: 4, 2 or 1) that every row of a row-major
// matrix of `len` floats a row allows, from its base pointer.
inline int copy_width(const void* p, int len) {
  const auto a = reinterpret_cast<std::uintptr_t>(p);
  if (len % 4 == 0 && a % 16 == 0) return 4;
  if (len % 2 == 0 && a % 8 == 0) return 2;
  return 1;
}

// Four floats at src into dst, the first `valid` (0-4) of them from src and
// the rest zero-filled, in copies of W floats (with W 4, valid is 0 or 4;
// with W 2, even). `safe` is any readable address.
template <int W>
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      const float* safe, int valid) {
  if constexpr (W == 4) {
    cp16(dst, valid > 0 ? src : safe, valid > 0 ? 16 : 0);
  } else {
#pragma unroll
    for (int e = 0; e < 4; e += W) {
      const bool ok = e < valid;
      if constexpr (W == 2)
        cp8(dst + e, ok ? src + e : safe, ok ? 8 : 0);
      else
        cp4(dst + e, ok ? src + e : safe, ok ? 4 : 0);
    }
  }
}

// f(Width<W>{}) for the copy width w (4, 2 or 1), so that a copy loop is
// compiled once per width and branches outside it (with the branch inside
// the loops, the batched GEMM at 2 x 9000 rows took 7% longer on one H100
// 80GB HBM3 at 700 W, scripts/fused_compare.py)
template <int W>
struct Width {
  static constexpr int value = W;
};
template <typename F>
__device__ __forceinline__ void with_width(int w, F f) {
  if (w == 4)
    f(Width<4>{});
  else if (w == 2)
    f(Width<2>{});
  else
    f(Width<1>{});
}

// The 16-byte chunk (of a row's four) where k-chunk ch of tile row `row`
// lies: swizzled by the row's row group, so that rows TM apart (the two
// row groups of a warp) read other banks.
template <int TM>
__device__ __forceinline__ int chunk(int row, int ch) {
  return ch ^ ((row / TM) & 3);
}

// acc += A[r0 + row, :] . B[:, col0 + this thread's columns] for the
// thread's TM rows, A (rows x k) and B (k x n) row-major, copied `wa` and
// `wb` floats at a time (copy_width). A tile row is read where
// row_ok(row) and zero-filled elsewhere (rows past the matrix, or another
// group's); a warp that is not `live` copies its share but skips the FMAs,
// which would add only zeros. Ends with the ring free (a barrier), so it
// may be called again.
template <int TM, int CW, typename RowOk>
__device__ __forceinline__ void mainloop(float (&acc)[TM][4 * CW],
                                         float* smem, int bm,
                                         const float* a, const float* b,
                                         int k, int n, int r0, int col0,
                                         int wa, int wb, RowOk row_ok,
                                         bool live) {
  constexpr int kPanel = Tile<TM, CW>::kPanel;
  float* as = smem;                          // kStages x (bm, kSlab)
  float* bs = as + kStages * bm * kSlab;     // kStages x (kSlab, kPanel)
  const int tid = threadIdx.x, tx = tid % kLanes, ty = tid / kLanes;

  // slab t into ring stage t % kStages: every element written, past the
  // matrix as zeros
  auto load = [&](int t) {
    const int k0 = t * kSlab;
    float* ad = as + (t % kStages) * bm * kSlab;
    float* bd = bs + (t % kStages) * kSlab * kPanel;
    with_width(wa, [&](auto width) {
      constexpr int W = decltype(width)::value;
      for (int i = tid; i < bm * (kSlab / 4); i += blockDim.x) {
        const int row = i / (kSlab / 4), ch = i % (kSlab / 4);
        const int gk = k0 + ch * 4;
        const int valid = row_ok(row) ? min(max(k - gk, 0), 4) : 0;
        copy4<W>(ad + row * kSlab + chunk<TM>(row, ch) * 4,
                 a + static_cast<size_t>(r0 + row) * k + gk, a, valid);
      }
    });
    with_width(wb, [&](auto width) {
      constexpr int W = decltype(width)::value;
      for (int i = tid; i < kSlab * (kPanel / 4); i += blockDim.x) {
        const int kr = i / (kPanel / 4), ch = i % (kPanel / 4);
        const int gk = k0 + kr, gc = col0 + ch * 4;
        const int valid = gk < k ? min(max(n - gc, 0), 4) : 0;
        copy4<W>(bd + kr * kPanel + ch * 4,
                 b + static_cast<size_t>(gk) * n + gc, b, valid);
      }
    });
  };

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
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          const float4 bv = *reinterpret_cast<const float4*>(
              bd + (ch * 4 + kk) * kPanel + c * kLanes * 4 + tx * 4);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float av_k = reinterpret_cast<const float*>(&av[i])[kk];
            float* o = acc[i] + 4 * c;
            o[0] = fmaf(av_k, bv.x, o[0]);
            o[1] = fmaf(av_k, bv.y, o[1]);
            o[2] = fmaf(av_k, bv.z, o[2]);
            o[3] = fmaf(av_k, bv.w, o[3]);
          }
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();
}

// The thread's TM x 4 CW sums into C (m x n, row-major) at the tile's rows
// below m and the panel's columns below n, `wc` floats at a time
// (copy_width of C).
template <int TM, int CW>
__device__ __forceinline__ void store(const float (&acc)[TM][4 * CW],
                                      float* c, int m, int n, int r0,
                                      int col0, int wc) {
  const int tx = threadIdx.x % kLanes, ty = threadIdx.x / kLanes;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + ty * TM + i;
    if (r >= m) break;
    float* row = c + static_cast<size_t>(r) * n;
#pragma unroll
    for (int cw = 0; cw < CW; ++cw) {
      const int col = col0 + cw * kLanes * 4 + tx * 4;
      const float* v = acc[i] + 4 * cw;
      if (col >= n) continue;
      if (wc == 4) {
        *reinterpret_cast<float4*>(row + col) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else if (wc == 2) {
        *reinterpret_cast<float2*>(row + col) = make_float2(v[0], v[1]);
        if (col + 2 < n)
          *reinterpret_cast<float2*>(row + col + 2) = make_float2(v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < n) row[col + j] = v[j];
      }
    }
  }
}

}  // namespace repro::gemm
