// Batched ELL SpMM — the paper's batched SWA-SpMM for CSR (row split, no
// atomics), C[s, r, :] = sum_k val[s, r, k] * B[s, cid[s, r, k], :].
//
// Replaces the TPU kernel src/repro/kernels/batched_spmm_ell.py
// (batched_spmm_ell / _kernel, the pallas_ell registry entry).
//
// What bounds it on an H100: bytes. Each (row, slot) is two 4-byte loads and
// one FMA per column, so the product does ~n_b/8 FLOP per byte of ids and
// values: far below the ridge. At the main-path shape (512 matrices of 56
// rows, k_pad 8, n_b 64) the call moves ~16 MB and is ~5 us of HBM time,
// about the cost of one launch.
//
// Design: one block per (matrix x column panel), grid (batch, p). The block
// first stages its B panel (m_pad x n_block f32, 14 KB at the main-path
// shape) in shared memory with coalesced loads, because each B row is
// gathered once per incoming edge (up to k_pad times). A sub-warp of
// next_pow2(n_block) <= 32 lanes then owns one output row at a time, its
// lanes striding the panel's columns; the row's sum stays in a register and
// is stored once. Padded slots (value 0.0, id 0) add 0; ids outside
// [0, m_pad) are skipped.
//
// Reduced-precision entries, the reference kernel's other operand branches
// (_kernel :45: int16 col_ids widened on load, bf16 values and B, int8
// codes with a per-matrix f32 scale applied once to the accumulator,
// :83-87): one template over the value type V, the dense type D, the id
// type I and kScale. batched_spmm_ell_bf16 takes int16 ids, bf16 values
// and a bf16 B, stages the B panel in shared memory as bf16 (half the f32
// panel), sums the widened products in an f32 register and rounds the
// output to bf16 once (__float2bfloat16_rn). batched_spmm_ell_i8 takes
// int16 ids, int8 codes and an f32 B, and multiplies each row's f32 sum by
// scale[s] before the f32 store. What bounds them is still bytes: bf16
// halves B and C, the bulk of the traffic; i8 shrinks only the ids and
// values (~5% of it at the main-path shape).
//
// g-SpMM entry (batched_gspmm_ell_f32), the reference kernel's (op, reduce)
// branches with its per-row live bound: C[s, r] = reduce_{k < rlen[r]}
// op(B[s, cid[r, k]], e_rk), op in {mul, add, copy_lhs}, reduce in {sum,
// max, mean}, scalar edges (batch, m_pad, k_pad) or vector edges (batch,
// m_pad, k_pad, n_b). The ELL layout cannot tell a real 0.0 edge from
// padding, so rlen = the row degrees (batch, m_pad) travels beside it and
// bounds each row's loop. The same design otherwise; max starts at the
// finite -3e38 and writes 0.0 into empty rows, mean divides by
// max(rlen, 1). No atomics, bitwise repeatable.
//
// Large-matrix entries (batched_spmm_ell_large_{f32,bf16,i8},
// batched_gspmm_ell_large_f32), for paper case 3, where the reference takes
// its plain per-sample path (src/repro/kernels/ops.py _forward_base) and a
// B panel of m_pad rows does not fit a block's shared memory: the same
// template with kLarge, which reads each gathered B element from global
// memory through the read-only cache (__ldg; B is L2-resident at these
// sizes) instead of staging the panel. The rest is unchanged: a sub-warp
// per row, the sum in a register, the scale epilogue, the id widening and
// the rlen bound, so each output is the same fixed-order sum as in the
// batched entries, bitwise. The grid is (batch, row blocks of 256 / sub
// rows, column panels of at most 128 columns): at m_pad 9,000 a matrix is
// over a thousand blocks, not one. The bf16 and i8 large entries also take
// int32 ids (ids32), for m_pad past int16's range. The staged branch stays
// for the shapes it takes because it is the faster one there: on one H100
// (700 W) the large entry took 3% longer at the Tox21 serving shape and
// 4.5% (f32) and 12% (bf16) longer at Reaction100 layer 2 (chip_smoke.py's
// [fork] lines, PERF.md).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// The block's B panel: with kLarge it is read where it lies, through the
// read-only cache; otherwise the block's (m_pad x nbw) panel is staged in
// shared memory ``bs`` with coalesced loads. Returns what panel_at reads.
template <bool kLarge, typename D>
__device__ __forceinline__ const D* stage_panel(const D* bsrc, D* bs,
                                                int m_pad, int n_b,
                                                int nbw) {
  if constexpr (!kLarge) {
    for (int i = threadIdx.x; i < m_pad * nbw; i += kThreads) {
      const int r = i / nbw, cc = i - r * nbw;
      bs[i] = bsrc[static_cast<size_t>(r) * n_b + cc];
    }
    __syncthreads();
  }
  return bs;
}

// B[j, cc] of the block's panel, staged or read through the L2.
template <bool kLarge, typename D>
__device__ __forceinline__ float panel_at(const D* bs, const D* bsrc, int j,
                                          int cc, int nbw, int n_b) {
  if constexpr (kLarge)
    return repro::ldf(bsrc + static_cast<size_t>(j) * n_b + cc);
  return repro::to_f32(bs[j * nbw + cc]);
}

// The launch shape (grid, shared bytes, panel width): (batch, p) with the
// staged panel, or repro::gather_grid's without.
template <bool kLarge>
inline int launch_shape(int batch, int m_pad, int n_b, int n_block,
                        size_t elem, dim3* grid, size_t* smem) {
  if constexpr (kLarge) {
    *smem = 0;
    return repro::gather_grid<kThreads>(batch, m_pad, n_b, n_block, grid);
  }
  *grid = dim3(batch, (n_b + n_block - 1) / n_block);
  *smem = static_cast<size_t>(m_pad) * n_block * elem;
  return n_block;
}

template <typename V, typename D, typename I, bool kScale, bool kLarge>
__global__ void __launch_bounds__(kThreads)
ell_kernel(const I* __restrict__ cid, const V* __restrict__ val,
           const float* __restrict__ scale, const D* __restrict__ b,
           D* __restrict__ c, int m_pad, int k_pad, int n_b, int n_block,
           int sub) {
  extern __shared__ float ell_smem[];
  const int s = blockIdx.x;
  const int col0 = (kLarge ? blockIdx.z : blockIdx.y) * n_block;
  const int nbw = min(n_block, n_b - col0);
  const size_t mat = static_cast<size_t>(s) * m_pad;
  const D* bsrc = b + mat * n_b + col0;
  const D* bs = stage_panel<kLarge>(
      bsrc, reinterpret_cast<D*>(ell_smem), m_pad, n_b, nbw);

  const int lane = threadIdx.x % sub, groups = kThreads / sub;
  const int r0 = kLarge ? blockIdx.y * groups : 0;
  const int r_step = kLarge ? gridDim.y * groups : groups;
  D* dst = c + mat * n_b + col0;
  for (int r = r0 + threadIdx.x / sub; r < m_pad; r += r_step) {
    const I* rc = cid + (mat + r) * k_pad;
    const V* rv = val + (mat + r) * k_pad;
    for (int cc = lane; cc < nbw; cc += sub) {
      float acc = 0.f;
      for (int k = 0; k < k_pad; ++k) {
        const int j = repro::ldi(rc + k);
        if (static_cast<unsigned>(j) < static_cast<unsigned>(m_pad))
          acc = fmaf(repro::ldf(rv + k),
                     panel_at<kLarge>(bs, bsrc, j, cc, nbw, n_b),
                     acc);
      }
      if constexpr (kScale) acc *= __ldg(scale + s);
      dst[static_cast<size_t>(r) * n_b + cc] = repro::from_f32<D>(acc);
    }
  }
}

template <bool kLarge>
__global__ void __launch_bounds__(kThreads)
ell_gspmm_kernel(const int* __restrict__ cid, const float* __restrict__ val,
                 const int* __restrict__ rlen, const float* __restrict__ b,
                 float* __restrict__ c, int m_pad, int k_pad, int n_b,
                 int n_block, int sub, int op, int reduce, int vec) {
  extern __shared__ float ell_smem[];
  const int s = blockIdx.x;
  const int col0 = (kLarge ? blockIdx.z : blockIdx.y) * n_block;
  const int nbw = min(n_block, n_b - col0);
  const size_t mat = static_cast<size_t>(s) * m_pad;
  const float* bsrc = b + mat * n_b + col0;
  const float* bs =
      stage_panel<kLarge>(bsrc, ell_smem, m_pad, n_b, nbw);

  const float init = reduce == repro::kMax ? repro::kNegInf : 0.f;
  const int lane = threadIdx.x % sub, groups = kThreads / sub;
  const int r0 = kLarge ? blockIdx.y * groups : 0;
  const int r_step = kLarge ? gridDim.y * groups : groups;
  float* dst = c + mat * n_b + col0;
  for (int r = r0 + threadIdx.x / sub; r < m_pad; r += r_step) {
    const int* rc = cid + (mat + r) * k_pad;
    const size_t voff = (mat + r) * k_pad;
    const int deg = __ldg(rlen + mat + r);
    const int live = min(max(deg, 0), k_pad);
    for (int cc = lane; cc < nbw; cc += sub) {
      float acc = init;
      for (int k = 0; k < live; ++k) {
        const int j = __ldg(rc + k);
        if (static_cast<unsigned>(j) >= static_cast<unsigned>(m_pad))
          continue;
        float e = 0.f;
        if (op != repro::kOpCopyLhs)
          e = vec ? __ldg(val + (voff + k) * n_b + col0 + cc)
                  : __ldg(val + voff + k);
        const float m = repro::combine(
            panel_at<kLarge>(bs, bsrc, j, cc, nbw, n_b), e, op);
        acc = reduce == repro::kMax ? fmaxf(acc, m) : acc + m;
      }
      dst[static_cast<size_t>(r) * n_b + cc] = repro::finish(acc, deg, reduce);
    }
  }
}

template <bool kLarge>
int gspmm_launch(const int* cid, const float* val, const int* rlen,
                 const float* b, float* c, int batch, int m_pad, int k_pad,
                 int n_b, int n_block, int op, int reduce, int vec,
                 void* stream) {
  dim3 grid;
  size_t smem;
  const int panel = launch_shape<kLarge>(batch, m_pad, n_b, n_block,
                                         sizeof(float), &grid, &smem);
  cudaError_t e = repro::allow_smem(ell_gspmm_kernel<kLarge>, smem);
  if (e != cudaSuccess) return e;
  ell_gspmm_kernel<kLarge><<<grid, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      cid, val, rlen, b, c, m_pad, k_pad, n_b, panel,
      repro::sub_warp(panel), op, reduce, vec);
  return cudaGetLastError();
}

template <typename V, typename D, typename I, bool kScale, bool kLarge>
int launch(const void* cid, const void* val, const float* scale,
           const void* b, void* c, int batch, int m_pad, int k_pad, int n_b,
           int n_block, void* stream) {
  dim3 grid;
  size_t smem;
  const int panel = launch_shape<kLarge>(batch, m_pad, n_b, n_block,
                                         sizeof(D), &grid, &smem);
  cudaError_t e =
      repro::allow_smem(ell_kernel<V, D, I, kScale, kLarge>, smem);
  if (e != cudaSuccess) return e;
  ell_kernel<V, D, I, kScale, kLarge>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const I*>(cid), static_cast<const V*>(val), scale,
          static_cast<const D*>(b), static_cast<D*>(c), m_pad, k_pad, n_b,
          panel, repro::sub_warp(panel));
  return cudaGetLastError();
}

}  // namespace

extern "C" int batched_gspmm_ell_f32(const int* cid, const float* val,
                                     const int* rlen, const float* b,
                                     float* c, int batch, int m_pad,
                                     int k_pad, int n_b, int n_block, int op,
                                     int reduce, int vec, void* stream) {
  return gspmm_launch<false>(cid, val, rlen, b, c, batch, m_pad, k_pad, n_b,
                             n_block, op, reduce, vec, stream);
}

extern "C" int batched_spmm_ell_f32(const int* cid, const float* val,
                                    const float* b, float* c, int batch,
                                    int m_pad, int k_pad, int n_b,
                                    int n_block, void* stream) {
  return launch<float, float, int, false, false>(
      cid, val, nullptr, b, c, batch, m_pad, k_pad, n_b, n_block, stream);
}

// cid (batch, m_pad, k_pad) int16, val bf16, b and c (batch, m_pad, n_b) bf16
extern "C" int batched_spmm_ell_bf16(const void* cid, const void* val,
                                     const void* b, void* c, int batch,
                                     int m_pad, int k_pad, int n_b,
                                     int n_block, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16, short, false, false>(
      cid, val, nullptr, b, c, batch, m_pad, k_pad, n_b, n_block, stream);
}

// cid int16, val int8 codes, scale (batch,) f32, b and c f32
extern "C" int batched_spmm_ell_i8(const void* cid, const void* val,
                                   const float* scale, const float* b,
                                   float* c, int batch, int m_pad, int k_pad,
                                   int n_b, int n_block, void* stream) {
  return launch<signed char, float, short, true, false>(
      cid, val, scale, b, c, batch, m_pad, k_pad, n_b, n_block, stream);
}

// The large-matrix entries: the same arguments (n_block is capped at 128),
// the bf16 and i8 ones with ids32 = 1 for int32 ids.
extern "C" int batched_gspmm_ell_large_f32(
    const int* cid, const float* val, const int* rlen, const float* b,
    float* c, int batch, int m_pad, int k_pad, int n_b, int n_block, int op,
    int reduce, int vec, void* stream) {
  return gspmm_launch<true>(cid, val, rlen, b, c, batch, m_pad, k_pad, n_b,
                            n_block, op, reduce, vec, stream);
}

extern "C" int batched_spmm_ell_large_f32(const int* cid, const float* val,
                                          const float* b, float* c,
                                          int batch, int m_pad, int k_pad,
                                          int n_b, int n_block,
                                          void* stream) {
  return launch<float, float, int, false, true>(
      cid, val, nullptr, b, c, batch, m_pad, k_pad, n_b, n_block, stream);
}

extern "C" int batched_spmm_ell_large_bf16(const void* cid, const void* val,
                                           const void* b, void* c, int batch,
                                           int m_pad, int k_pad, int n_b,
                                           int n_block, int ids32,
                                           void* stream) {
  using B = __nv_bfloat16;
  return ids32 ? launch<B, B, int, false, true>(cid, val, nullptr, b, c,
                                                batch, m_pad, k_pad, n_b,
                                                n_block, stream)
               : launch<B, B, short, false, true>(cid, val, nullptr, b, c,
                                                  batch, m_pad, k_pad, n_b,
                                                  n_block, stream);
}

extern "C" int batched_spmm_ell_large_i8(const void* cid, const void* val,
                                         const float* scale, const float* b,
                                         float* c, int batch, int m_pad,
                                         int k_pad, int n_b, int n_block,
                                         int ids32, void* stream) {
  using S = signed char;
  return ids32 ? launch<S, float, int, true, true>(cid, val, scale, b, c,
                                                   batch, m_pad, k_pad, n_b,
                                                   n_block, stream)
               : launch<S, float, short, true, true>(cid, val, scale, b, c,
                                                     batch, m_pad, k_pad,
                                                     n_b, n_block, stream);
}
