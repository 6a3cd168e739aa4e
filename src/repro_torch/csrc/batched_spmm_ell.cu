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
// g-SpMM entry (batched_gspmm_ell_f32), the reference kernel's (op, reduce)
// branches with its per-row live bound: C[s, r] = reduce_{k < rlen[r]}
// op(B[s, cid[r, k]], e_rk), op in {mul, add, copy_lhs}, reduce in {sum,
// max, mean}, scalar edges (batch, m_pad, k_pad) or vector edges (batch,
// m_pad, k_pad, n_b). The ELL layout cannot tell a real 0.0 edge from
// padding, so rlen = the row degrees (batch, m_pad) travels beside it and
// bounds each row's loop. The same design otherwise; max starts at the
// finite -3e38 and writes 0.0 into empty rows, mean divides by
// max(rlen, 1). No atomics, bitwise repeatable.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ell_kernel(const int* __restrict__ cid, const float* __restrict__ val,
           const float* __restrict__ b, float* __restrict__ c, int m_pad,
           int k_pad, int n_b, int n_block, int sub) {
  extern __shared__ float bs[];  // (m_pad, nbw) panel of B
  const int s = blockIdx.x;
  const int col0 = blockIdx.y * n_block;
  const int nbw = min(n_block, n_b - col0);
  const size_t mat = static_cast<size_t>(s) * m_pad;

  const float* bsrc = b + mat * n_b + col0;
  for (int i = threadIdx.x; i < m_pad * nbw; i += kThreads) {
    const int r = i / nbw, cc = i - r * nbw;
    bs[i] = bsrc[static_cast<size_t>(r) * n_b + cc];
  }
  __syncthreads();

  const int lane = threadIdx.x % sub, groups = kThreads / sub;
  float* dst = c + mat * n_b + col0;
  for (int r = threadIdx.x / sub; r < m_pad; r += groups) {
    const int* rc = cid + (mat + r) * k_pad;
    const float* rv = val + (mat + r) * k_pad;
    for (int cc = lane; cc < nbw; cc += sub) {
      float acc = 0.f;
      for (int k = 0; k < k_pad; ++k) {
        const int j = __ldg(rc + k);
        if (static_cast<unsigned>(j) < static_cast<unsigned>(m_pad))
          acc = fmaf(__ldg(rv + k), bs[j * nbw + cc], acc);
      }
      dst[static_cast<size_t>(r) * n_b + cc] = acc;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
ell_gspmm_kernel(const int* __restrict__ cid, const float* __restrict__ val,
                 const int* __restrict__ rlen, const float* __restrict__ b,
                 float* __restrict__ c, int m_pad, int k_pad, int n_b,
                 int n_block, int sub, int op, int reduce, int vec) {
  extern __shared__ float bs[];  // (m_pad, nbw) panel of B
  const int s = blockIdx.x;
  const int col0 = blockIdx.y * n_block;
  const int nbw = min(n_block, n_b - col0);
  const size_t mat = static_cast<size_t>(s) * m_pad;

  const float* bsrc = b + mat * n_b + col0;
  for (int i = threadIdx.x; i < m_pad * nbw; i += kThreads) {
    const int r = i / nbw, cc = i - r * nbw;
    bs[i] = bsrc[static_cast<size_t>(r) * n_b + cc];
  }
  __syncthreads();

  const float init = reduce == repro::kMax ? repro::kNegInf : 0.f;
  const int lane = threadIdx.x % sub, groups = kThreads / sub;
  float* dst = c + mat * n_b + col0;
  for (int r = threadIdx.x / sub; r < m_pad; r += groups) {
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
        const float m = repro::combine(bs[j * nbw + cc], e, op);
        acc = reduce == repro::kMax ? fmaxf(acc, m) : acc + m;
      }
      dst[static_cast<size_t>(r) * n_b + cc] = repro::finish(acc, deg, reduce);
    }
  }
}

}  // namespace

extern "C" int batched_gspmm_ell_f32(const int* cid, const float* val,
                                     const int* rlen, const float* b,
                                     float* c, int batch, int m_pad,
                                     int k_pad, int n_b, int n_block, int op,
                                     int reduce, int vec, void* stream) {
  const size_t smem = static_cast<size_t>(m_pad) * n_block * sizeof(float);
  cudaError_t e = repro::allow_smem(ell_gspmm_kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(batch, (n_b + n_block - 1) / n_block);
  ell_gspmm_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      cid, val, rlen, b, c, m_pad, k_pad, n_b, n_block,
      repro::sub_warp(n_block), op, reduce, vec);
  return cudaGetLastError();
}

extern "C" int batched_spmm_ell_f32(const int* cid, const float* val,
                                    const float* b, float* c, int batch,
                                    int m_pad, int k_pad, int n_b,
                                    int n_block, void* stream) {
  const size_t smem = static_cast<size_t>(m_pad) * n_block * sizeof(float);
  cudaError_t e = repro::allow_smem(ell_kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(batch, (n_b + n_block - 1) / n_block);
  ell_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      cid, val, b, c, m_pad, k_pad, n_b, n_block, repro::sub_warp(n_block));
  return cudaGetLastError();
}
