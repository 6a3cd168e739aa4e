// Batched ELL SpMM — the paper's batched SWA-SpMM for CSR (row split, no
// atomics), C[s, r, :] = sum_k val[s, r, k] * B[s, cid[s, r, k], :].
//
// Replaces the TPU kernel src/repro/kernels/batched_spmm_ell.py
// (batched_spmm_ell / _kernel, the pallas_ell registry entry).
//
// What bounds it on an H100: bytes. Each (row, slot) is two 4-byte loads and
// one FMA per column, so the product does ~n_b/8 FLOP per byte of ids and
// values: far below the ridge. At the main-path shape (512 matrices of 56
// rows, k_pad 8, n_b 64) the call moves ~15 MB and is ~4.4 us of HBM time,
// about the cost of one launch, so what bounds it in practice is latency:
// how many independent loads each warp has in flight.
//
// Design: the row split of the CSR and hybrid kernels, with B read where it
// lies (through the read-only cache; B is L2-resident at every size the
// port runs). The grid is (batch, row blocks, column panels of at most 128
// columns), so a matrix is as many blocks as its rows need: 2,048 blocks at
// the main-path shape, not 512. A sub-warp of sub <= 32 lanes owns one row
// at a time, each lane four neighbouring columns (one 16-byte f32 or 8-byte
// bf16 load where n_b is a multiple of 4: two rows a warp at n_b 64). A
// row's slots go in chunks of kSlots = 8, the GCNs' k_pad: the chunk's ids
// and values are read once, as 16-byte vectors where k_pad is a multiple of
// 8 (else one at a time), and all its gathers are issued before its FMAs,
// so a lane has eight 16-byte loads in flight, not one 4-byte load waiting
// on its id. The sum stays in f32 registers, in slot order, and is stored
// once. Ids outside [0, m_pad) are skipped, and so are slots whose value is
// 0.0, padding above all (value 0.0, id 0: 6 of the 8 slots of a Tox21 row
// on average), as in the COO and fused kernels: such a slot would add
// fmaf(0, b, acc) == acc for a finite b (acc is never -0.0), so the sums
// keep their bits, and a NaN or inf in B's row 0 does not reach the rows
// that pad with it, where the plain version's 0 * inf would.
//
// The paper's design, one block per (matrix x panel) with the B panel
// staged in shared memory and one column a lane, was this file's batched
// branch. On one H100 80GB HBM3 at 700 W (scripts/fused_compare.py, both in
// turns on one card) this one took 0.0071 ms against 0.0165 at the
// main-path shape (bf16 0.0077 against 0.0175, i8 0.0078 against 0.0166;
// torch.bmm on the dense adjacency 0.0095), 0.052 against 0.106 at
// Reaction100 layer 2 (n_b 512), 0.0213 against 0.0660 at 2 x 9,000 rows
// (against the former large-matrix branch: B through the L2, one column a
// lane) and, in the g-SpMM entry, 0.0105 against 0.0128 (R-GCN) and 0.0055
// against 0.0077 (GAT); so it is the only design.
//
// Reduced-precision entries, the reference kernel's other operand branches
// (_kernel :45: int16 col_ids widened on load, bf16 values and B, int8
// codes with a per-matrix f32 scale applied once to the accumulator,
// :83-87): one template over the value type V, the dense type D, the id
// type I and kScale. batched_spmm_ell_bf16 takes bf16 values and a bf16 B,
// sums the widened products in f32 registers and rounds each output to
// bf16 once (round to nearest even); batched_spmm_ell_i8 takes int8 codes
// and an f32 B and multiplies each row's f32 sum by scale[s] before the
// store. Both take int16 ids, or int32 ones (ids32) for m_pad past int16's
// range.
//
// g-SpMM entry (batched_gspmm_ell_f32), the reference kernel's (op, reduce)
// branches with its per-row live bound: C[s, r] = reduce_{k < rlen[r]}
// op(B[s, cid[r, k]], e_rk), op in {mul, add, copy_lhs}, reduce in {sum,
// max, mean}, scalar edges (batch, m_pad, k_pad) or vector edges (batch,
// m_pad, k_pad, n_b). The ELL layout cannot tell a real 0.0 edge from
// padding, so rlen = the row degrees (batch, m_pad) travels beside it and
// bounds each row's loop. The same design otherwise; max starts at the
// finite -3e38 and writes 0.0 into empty rows, mean divides by
// max(rlen, 1).
//
// The same entries run paper case 3, where the reference takes its plain
// per-sample path (src/repro/kernels/ops.py _forward_base): the wrappers
// batched_spmm_ell_large* launch them and count the launch apart. No
// atomics: every output is one fixed-order sum, bitwise repeatable.
#include "common.cuh"

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 8;   // a row's slots whose loads issue together

using repro::kW;
using repro::ldv;
using repro::load_cols;
using repro::store_cols;

// kSlots ids at p (16-byte aligned), widened to int
__device__ __forceinline__ void load_ids(const int* p, int* j) {
  const int4 a = __ldg(reinterpret_cast<const int4*>(p));
  const int4 b = __ldg(reinterpret_cast<const int4*>(p) + 1);
  j[0] = a.x, j[1] = a.y, j[2] = a.z, j[3] = a.w;
  j[4] = b.x, j[5] = b.y, j[6] = b.z, j[7] = b.w;
}
__device__ __forceinline__ void load_ids(const short* p, int* j) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned u[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    j[2 * q] = static_cast<short>(u[q] & 0xffffu);
    j[2 * q + 1] = static_cast<short>(u[q] >> 16);
  }
}

// kSlots values at p (16-byte aligned), widened to f32
__device__ __forceinline__ void load_vals(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load_vals(const __nv_bfloat16* p, float* v) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned u[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[2 * q] = __uint_as_float(u[q] << 16);
    v[2 * q + 1] = __uint_as_float(u[q] & ~0xffffu);
  }
}
__device__ __forceinline__ void load_vals(const signed char* p, float* v) {
  const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    const unsigned word = q < 4 ? a.x : a.y;
    v[q] = static_cast<float>(
        static_cast<signed char>((word >> (8 * (q % 4))) & 0xffu));
  }
}

template <typename V, typename D, typename I, bool kScale>
__global__ void __launch_bounds__(kThreads)
ell_kernel(const I* __restrict__ cid, const V* __restrict__ val,
           const float* __restrict__ scale, const D* __restrict__ b,
           D* __restrict__ c, int m_pad, int k_pad, int n_b, int n_block,
           int sub, int vec, int vec_slots) {
  const int s = blockIdx.x;
  const int col0 = blockIdx.z * n_block;
  const int nbw = min(n_block, n_b - col0);
  const size_t mat = static_cast<size_t>(s) * m_pad;
  const int lane = threadIdx.x % sub, groups = kThreads / sub;
  const int cc = kW * lane;   // this lane's columns of the panel
  const bool mine = cc < nbw;
  const D* bsrc = b + mat * n_b + col0;
  D* dst = c + mat * n_b + col0;
  for (int r = blockIdx.y * groups + threadIdx.x / sub; r < m_pad;
       r += gridDim.y * groups) {
    if (!mine) continue;
    float acc[kW] = {};
    const I* rc = cid + (mat + r) * k_pad;
    const V* rv = val + (mat + r) * k_pad;
    for (int k0 = 0; k0 < k_pad; k0 += kSlots) {
      int j[kSlots];
      float v[kSlots];
      if (vec_slots) {
        load_ids(rc + k0, j);
        load_vals(rv + k0, v);
      } else {
#pragma unroll
        for (int q = 0; q < kSlots; ++q) {
          const bool in = k0 + q < k_pad;
          j[q] = in ? repro::ldi(rc + k0 + q) : -1;
          v[q] = in ? ldv(rv + k0 + q) : 0.f;
        }
      }
      // every gather of the chunk before its FMAs; a slot whose value is
      // 0.0 (padding) gathers nothing: it would add fmaf(0, b, acc) == acc
      bool ok[kSlots];
      float x[kSlots][kW];
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        ok[q] = v[q] != 0.f &&
                static_cast<unsigned>(j[q]) < static_cast<unsigned>(m_pad);
        if (ok[q])
          load_cols(bsrc + static_cast<size_t>(j[q]) * n_b + cc, vec,
                    nbw - cc, x[q]);
      }
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        if (ok[q])
#pragma unroll
          for (int i = 0; i < kW; ++i) acc[i] = fmaf(v[q], x[q][i], acc[i]);
      }
    }
    if constexpr (kScale) {
      const float sc = __ldg(scale + s);
#pragma unroll
      for (int i = 0; i < kW; ++i) acc[i] *= sc;
    }
    store_cols(dst + static_cast<size_t>(r) * n_b + cc, acc, vec, nbw - cc);
  }
}

__global__ void __launch_bounds__(kThreads)
ell_gspmm_kernel(const int* __restrict__ cid, const float* __restrict__ val,
                 const int* __restrict__ rlen, const float* __restrict__ b,
                 float* __restrict__ c, int m_pad, int k_pad, int n_b,
                 int n_block, int sub, int op, int reduce, int vec_edges,
                 int vec) {
  const int s = blockIdx.x;
  const int col0 = blockIdx.z * n_block;
  const int nbw = min(n_block, n_b - col0);
  const size_t mat = static_cast<size_t>(s) * m_pad;
  const int lane = threadIdx.x % sub, groups = kThreads / sub;
  const int cc = kW * lane;
  const bool mine = cc < nbw;
  const float* bsrc = b + mat * n_b + col0;
  float* dst = c + mat * n_b + col0;
  const float init = reduce == repro::kMax ? repro::kNegInf : 0.f;
  for (int r = blockIdx.y * groups + threadIdx.x / sub; r < m_pad;
       r += gridDim.y * groups) {
    if (!mine) continue;
    const int* rc = cid + (mat + r) * k_pad;
    const size_t voff = (mat + r) * k_pad;
    const int deg = __ldg(rlen + mat + r);
    const int live = min(max(deg, 0), k_pad);
    float acc[kW];
#pragma unroll
    for (int i = 0; i < kW; ++i) acc[i] = init;
    for (int k0 = 0; k0 < live; k0 += kSlots) {
      int j[kSlots];
#pragma unroll
      for (int q = 0; q < kSlots; ++q)
        j[q] = k0 + q < live ? __ldg(rc + k0 + q) : -1;
      float x[kSlots][kW];
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        if (static_cast<unsigned>(j[q]) < static_cast<unsigned>(m_pad))
          load_cols(bsrc + static_cast<size_t>(j[q]) * n_b + cc, vec,
                    nbw - cc, x[q]);
      }
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        if (static_cast<unsigned>(j[q]) >= static_cast<unsigned>(m_pad))
          continue;
        float e[kW] = {};
        if (op != repro::kOpCopyLhs) {
          if (vec_edges) {
            load_cols(val + (voff + k0 + q) * n_b + col0 + cc, vec, nbw - cc,
                      e);
          } else {
            const float e0 = __ldg(val + voff + k0 + q);
#pragma unroll
            for (int i = 0; i < kW; ++i) e[i] = e0;
          }
        }
#pragma unroll
        for (int i = 0; i < kW; ++i) {
          const float m = repro::combine(x[q][i], e[i], op);
          acc[i] = reduce == repro::kMax ? fmaxf(acc[i], m) : acc[i] + m;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kW; ++i) acc[i] = repro::finish(acc[i], deg, reduce);
    store_cols(dst + static_cast<size_t>(r) * n_b + cc, acc, vec, nbw - cc);
  }
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

// The launch shape: (batch, row blocks of kThreads / sub rows, column
// panels of at most kPanelMax columns), sub = lanes for the panel's
// columns kW at a time. Returns the panel width.
int launch_shape(int batch, int m_pad, int n_b, int n_block, int* sub,
                 dim3* grid) {
  const int panel = min(n_block, repro::kPanelMax);
  *sub = repro::sub_warp((panel + kW - 1) / kW);
  *grid = dim3(batch, repro::large_blocks(m_pad, kThreads / *sub),
               (n_b + panel - 1) / panel);
  return panel;
}

template <typename V, typename D, typename I, bool kScale>
int launch(const void* cid, const void* val, const float* scale,
           const void* b, void* c, int batch, int m_pad, int k_pad, int n_b,
           int n_block, void* stream) {
  if (n_block < 1 || k_pad < 0) return cudaErrorInvalidValue;
  int sub;
  dim3 grid;
  const int panel = launch_shape(batch, m_pad, n_b, n_block, &sub, &grid);
  const size_t cols = kW * sizeof(D);
  const int vec = n_b % kW == 0 && panel % kW == 0 && aligned(b, cols) &&
                  aligned(c, cols);
  const int vec_slots =
      k_pad % kSlots == 0 && aligned(cid, 16) && aligned(val, 16);
  ell_kernel<V, D, I, kScale>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const I*>(cid), static_cast<const V*>(val), scale,
          static_cast<const D*>(b), static_cast<D*>(c), m_pad, k_pad, n_b,
          panel, sub, vec, vec_slots);
  return cudaGetLastError();
}

}  // namespace

// n_block is capped at 128 columns a block.
extern "C" int batched_gspmm_ell_f32(const int* cid, const float* val,
                                     const int* rlen, const float* b,
                                     float* c, int batch, int m_pad,
                                     int k_pad, int n_b, int n_block, int op,
                                     int reduce, int vec_edges,
                                     void* stream) {
  if (n_block < 1 || k_pad < 0) return cudaErrorInvalidValue;
  int sub;
  dim3 grid;
  const int panel = launch_shape(batch, m_pad, n_b, n_block, &sub, &grid);
  const size_t cols = kW * sizeof(float);
  const int vec = n_b % kW == 0 && panel % kW == 0 && aligned(b, cols) &&
                  aligned(c, cols) && (!vec_edges || aligned(val, cols));
  ell_gspmm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      cid, val, rlen, b, c, m_pad, k_pad, n_b, panel, sub, op, reduce,
      vec_edges, vec);
  return cudaGetLastError();
}

extern "C" int batched_spmm_ell_f32(const int* cid, const float* val,
                                    const float* b, float* c, int batch,
                                    int m_pad, int k_pad, int n_b,
                                    int n_block, void* stream) {
  return launch<float, float, int, false>(cid, val, nullptr, b, c, batch,
                                          m_pad, k_pad, n_b, n_block, stream);
}

// cid (batch, m_pad, k_pad) int16 (int32 with ids32 = 1), val bf16, b and c
// (batch, m_pad, n_b) bf16
extern "C" int batched_spmm_ell_bf16(const void* cid, const void* val,
                                     const void* b, void* c, int batch,
                                     int m_pad, int k_pad, int n_b,
                                     int n_block, int ids32, void* stream) {
  using B = __nv_bfloat16;
  return ids32 ? launch<B, B, int, false>(cid, val, nullptr, b, c, batch,
                                          m_pad, k_pad, n_b, n_block, stream)
               : launch<B, B, short, false>(cid, val, nullptr, b, c, batch,
                                            m_pad, k_pad, n_b, n_block,
                                            stream);
}

// cid int16 (int32 with ids32 = 1), val int8 codes, scale (batch,) f32, b
// and c f32
extern "C" int batched_spmm_ell_i8(const void* cid, const void* val,
                                   const float* scale, const float* b,
                                   float* c, int batch, int m_pad, int k_pad,
                                   int n_b, int n_block, int ids32,
                                   void* stream) {
  using S = signed char;
  return ids32 ? launch<S, float, int, true>(cid, val, scale, b, c, batch,
                                             m_pad, k_pad, n_b, n_block,
                                             stream)
               : launch<S, float, short, true>(cid, val, scale, b, c, batch,
                                               m_pad, k_pad, n_b, n_block,
                                               stream);
}
