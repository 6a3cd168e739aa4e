// Batched CSR SpMM — the paper's batched SWA-SpMM for CSR (row split, no
// atomics) on flat CSR arrays:
//   C[s, r, :] = sum_{k < rlen[r]} val[s, rpt[r] + k] * B[s, cid[s, rpt[r] + k], :].
//
// Replaces the TPU kernel src/repro/kernels/batched_spmm_csr.py
// (batched_spmm_csr / _kernel, the pallas_csr registry entry), which ran a
// masked loop of max(rlen) steps per matrix over every row at once.
//
// What bounds it on an H100: bytes. Each slot is two 4-byte loads and one
// FMA per column, far below the ridge. The call must move
// batch * ((m_pad + 1) * 4 + nnz * 8 + 2 * m_pad * n_b * 4) bytes: the row
// pointers, each real slot's id and value, B read once and C written once
// (nnz_pad in place of nnz for a batch whose slots are all real).
//
// Design: the paper's SWA-CSR row split, with B read where it lies. A
// sub-warp of next_pow2(n_block) <= 32 lanes owns one output row at a time
// and walks that row's own slots rpt[r]..rpt[r+1]: the trip count is per
// row, where the TPU kernel's was the per-matrix maximum. The lanes stride
// the panel's columns and gather each B element through the read-only
// cache (__ldg; B is L2-resident at every size the port runs), the sum
// stays in a register and is stored once. The grid is (batch, row blocks
// of 256 / sub rows, column panels of at most 128 columns), so a matrix is
// as many blocks as its rows need: at m_pad 9,000 over a thousand, not
// one. Slots past rpt[m_pad] are never visited, so the padding at the tail
// costs nothing. Column ids outside [0, m_pad) are skipped, as in the COO
// kernel. The paper's design stages each block's B panel (m_pad x n_block)
// in shared memory first, as the ELL kernel does; on one H100 (700 W) that
// took 23% longer at the Tox21 serving shape and 21% longer at Reaction100
// layer 2 than this one (chip_smoke.py's [fork] lines, PERF.md), and it
// does not fit a block past ~1,800 rows at n_b 32, so the kernel has only
// this design, at every plan, planner case 3 included.
//
// No atomics: every output element is one fixed-order sum, so the result is
// bitwise the same from run to run.
//
// Reduced-precision entries, the reference kernel's other operand branches
// (_kernel :58: int16 col_ids widened on load (:67), bf16 values and B,
// int8 codes with a per-matrix f32 scale applied once to the accumulator,
// :101-105): one template over the value type V, the dense type D, the
// column-id type I and kScale (rpt stays int32, as in the reference).
// batched_spmm_csr_bf16 gathers a bf16 B, sums the widened products in an
// f32 register and rounds each output once
// (__float2bfloat16_rn); batched_spmm_csr_i8 reads int8 codes against an
// f32 B and multiplies the f32 sum by scale[s] before the store. Still no
// atomics: both give identical bits from run to run. Both take int16
// column ids, or int32 ones (ids32) for m_pad past int16's range.
//
// g-SpMM entry (batched_gspmm_csr_f32), the reference kernel's (op, reduce)
// branches: C[s, r] = reduce_{rpt[r] <= k < rpt[r+1]} op(B[s, cid[k]], e_k),
// op in {mul, add, copy_lhs}, reduce in {sum, max, mean}, scalar edges
// (batch, nnz_pad) or vector edges (batch, nnz_pad, n_b) in the CSR sort
// order. The same design: a row's own slot range is its mask (the
// reference's k < rlen), its register accumulator starts at 0.0 or at the
// finite -3e38 for max, and the store writes 0.0 into an empty row for max
// and divides by max(rlen, 1) for mean. Still no atomics, still bitwise
// repeatable.
//
// The same entries run paper case 3, where the reference takes its plain
// per-sample path (src/repro/kernels/ops.py _csr_forward): the wrappers
// batched_spmm_csr_large* launch them and count the launch apart. They
// also run the pallas_hybrid and pallas_hybrid_bf16 impls at case 3 (the
// reference's plain COO sum there) and the CSR-class backward of both.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename V, typename D, typename I, bool kScale>
__global__ void __launch_bounds__(kThreads)
csr_kernel(const int* __restrict__ rpt, const I* __restrict__ cid,
           const V* __restrict__ val, const float* __restrict__ scale,
           const D* __restrict__ b, D* __restrict__ c, int m_pad,
           int nnz_pad, int n_b, int n_block, int sub) {
  const int s = blockIdx.x;
  const int col0 = blockIdx.z * n_block;
  const int nbw = min(n_block, n_b - col0);
  const size_t mat = static_cast<size_t>(s) * m_pad;
  const D* bsrc = b + mat * n_b + col0;
  const int* rp = rpt + static_cast<size_t>(s) * (m_pad + 1);
  const I* sc = cid + static_cast<size_t>(s) * nnz_pad;
  const V* sv = val + static_cast<size_t>(s) * nnz_pad;
  const int lane = threadIdx.x % sub, groups = kThreads / sub;
  D* dst = c + mat * n_b + col0;
  for (int r = blockIdx.y * groups + threadIdx.x / sub; r < m_pad;
       r += gridDim.y * groups) {
    const int lo = max(__ldg(rp + r), 0);
    const int hi = min(__ldg(rp + r + 1), nnz_pad);
    for (int cc = lane; cc < nbw; cc += sub) {
      float acc = 0.f;
      for (int k = lo; k < hi; ++k) {
        const int j = repro::ldi(sc + k);
        if (static_cast<unsigned>(j) < static_cast<unsigned>(m_pad))
          acc = fmaf(repro::ldf(sv + k),
                     repro::ldf(bsrc + static_cast<size_t>(j) * n_b + cc),
                     acc);
      }
      if constexpr (kScale) acc *= __ldg(scale + s);
      dst[static_cast<size_t>(r) * n_b + cc] = repro::from_f32<D>(acc);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
csr_gspmm_kernel(const int* __restrict__ rpt, const int* __restrict__ cid,
                 const float* __restrict__ val, const float* __restrict__ b,
                 float* __restrict__ c, int m_pad, int nnz_pad, int n_b,
                 int n_block, int sub, int op, int reduce, int vec) {
  const int s = blockIdx.x;
  const int col0 = blockIdx.z * n_block;
  const int nbw = min(n_block, n_b - col0);
  const size_t mat = static_cast<size_t>(s) * m_pad;
  const float* bsrc = b + mat * n_b + col0;
  const int* rp = rpt + static_cast<size_t>(s) * (m_pad + 1);
  const int* sc = cid + static_cast<size_t>(s) * nnz_pad;
  const size_t voff = static_cast<size_t>(s) * nnz_pad;
  const float init = reduce == repro::kMax ? repro::kNegInf : 0.f;
  const int lane = threadIdx.x % sub, groups = kThreads / sub;
  float* dst = c + mat * n_b + col0;
  for (int r = blockIdx.y * groups + threadIdx.x / sub; r < m_pad;
       r += gridDim.y * groups) {
    const int rb = __ldg(rp + r), re = __ldg(rp + r + 1);
    const int lo = max(rb, 0), hi = min(re, nnz_pad);
    for (int cc = lane; cc < nbw; cc += sub) {
      float acc = init;
      for (int k = lo; k < hi; ++k) {
        const int j = __ldg(sc + k);
        if (static_cast<unsigned>(j) >= static_cast<unsigned>(m_pad))
          continue;
        float e = 0.f;
        if (op != repro::kOpCopyLhs)
          e = vec ? __ldg(val + (voff + k) * n_b + col0 + cc)
                  : __ldg(val + voff + k);
        const float m = repro::combine(
            __ldg(bsrc + static_cast<size_t>(j) * n_b + cc), e, op);
        acc = reduce == repro::kMax ? fmaxf(acc, m) : acc + m;
      }
      dst[static_cast<size_t>(r) * n_b + cc] =
          repro::finish(acc, re - rb, reduce);
    }
  }
}

template <typename V, typename D, typename I, bool kScale>
int launch(const int* rpt, const void* cid, const void* val,
           const float* scale, const void* b, void* c, int batch, int m_pad,
           int nnz_pad, int n_b, int n_block, void* stream) {
  dim3 grid;
  const int panel =
      repro::gather_grid<kThreads>(batch, m_pad, n_b, n_block, &grid);
  csr_kernel<V, D, I, kScale>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          rpt, static_cast<const I*>(cid), static_cast<const V*>(val), scale,
          static_cast<const D*>(b), static_cast<D*>(c), m_pad, nnz_pad, n_b,
          panel, repro::sub_warp(panel));
  return cudaGetLastError();
}

}  // namespace

// n_block is capped at 128 columns a block.
extern "C" int batched_gspmm_csr_f32(const int* rpt, const int* cid,
                                     const float* val, const float* b,
                                     float* c, int batch, int m_pad,
                                     int nnz_pad, int n_b, int n_block,
                                     int op, int reduce, int vec,
                                     void* stream) {
  dim3 grid;
  const int panel =
      repro::gather_grid<kThreads>(batch, m_pad, n_b, n_block, &grid);
  csr_gspmm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rpt, cid, val, b, c, m_pad, nnz_pad, n_b, panel,
      repro::sub_warp(panel), op, reduce, vec);
  return cudaGetLastError();
}

extern "C" int batched_spmm_csr_f32(const int* rpt, const int* cid,
                                    const float* val, const float* b,
                                    float* c, int batch, int m_pad,
                                    int nnz_pad, int n_b, int n_block,
                                    void* stream) {
  return launch<float, float, int, false>(rpt, cid, val, nullptr, b, c,
                                          batch, m_pad, nnz_pad, n_b,
                                          n_block, stream);
}

// cid (batch, nnz_pad) int16 (int32 with ids32 = 1), val bf16, b and c
// (batch, m_pad, n_b) bf16
extern "C" int batched_spmm_csr_bf16(const int* rpt, const void* cid,
                                     const void* val, const void* b, void* c,
                                     int batch, int m_pad, int nnz_pad,
                                     int n_b, int n_block, int ids32,
                                     void* stream) {
  using B = __nv_bfloat16;
  return ids32 ? launch<B, B, int, false>(rpt, cid, val, nullptr, b, c,
                                          batch, m_pad, nnz_pad, n_b,
                                          n_block, stream)
               : launch<B, B, short, false>(rpt, cid, val, nullptr, b, c,
                                            batch, m_pad, nnz_pad, n_b,
                                            n_block, stream);
}

// cid int16 (int32 with ids32 = 1), val int8 codes, scale (batch,) f32, b
// and c f32
extern "C" int batched_spmm_csr_i8(const int* rpt, const void* cid,
                                   const void* val, const float* scale,
                                   const float* b, float* c, int batch,
                                   int m_pad, int nnz_pad, int n_b,
                                   int n_block, int ids32, void* stream) {
  using S = signed char;
  return ids32 ? launch<S, float, int, true>(rpt, cid, val, scale, b, c,
                                             batch, m_pad, nnz_pad, n_b,
                                             n_block, stream)
               : launch<S, float, short, true>(rpt, cid, val, scale, b, c,
                                               batch, m_pad, nnz_pad, n_b,
                                               n_block, stream);
}
