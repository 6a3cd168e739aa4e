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
// Design: the paper's SWA-CSR. One block per (matrix x column panel), grid
// (batch, p). The block first stages its B panel (m_pad x n_block f32) in
// shared memory with coalesced loads, as the ELL kernel does, because each
// B row is gathered once per incoming edge. A sub-warp of next_pow2(n_block)
// <= 32 lanes then owns one output row at a time and walks that row's own
// slots rpt[r]..rpt[r+1]: the trip count is per row, where the TPU kernel's
// was the per-matrix maximum. The lanes stride the panel's columns, the sum
// stays in a register and is stored once. Slots past rpt[m_pad] are never
// visited, so the padding at the tail costs nothing. Column ids outside
// [0, m_pad) are skipped, as in the COO kernel.
//
// No atomics: every output element is one fixed-order sum, so the result is
// bitwise the same from run to run.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
csr_kernel(const int* __restrict__ rpt, const int* __restrict__ cid,
           const float* __restrict__ val, const float* __restrict__ b,
           float* __restrict__ c, int m_pad, int nnz_pad, int n_b,
           int n_block, int sub) {
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

  const int* rp = rpt + static_cast<size_t>(s) * (m_pad + 1);
  const int* sc = cid + static_cast<size_t>(s) * nnz_pad;
  const float* sv = val + static_cast<size_t>(s) * nnz_pad;
  const int lane = threadIdx.x % sub, groups = kThreads / sub;
  float* dst = c + mat * n_b + col0;
  for (int r = threadIdx.x / sub; r < m_pad; r += groups) {
    const int lo = max(__ldg(rp + r), 0);
    const int hi = min(__ldg(rp + r + 1), nnz_pad);
    for (int cc = lane; cc < nbw; cc += sub) {
      float acc = 0.f;
      for (int k = lo; k < hi; ++k) {
        const int j = __ldg(sc + k);
        if (static_cast<unsigned>(j) < static_cast<unsigned>(m_pad))
          acc = fmaf(__ldg(sv + k), bs[j * nbw + cc], acc);
      }
      dst[static_cast<size_t>(r) * n_b + cc] = acc;
    }
  }
}

}  // namespace

extern "C" int batched_spmm_csr_f32(const int* rpt, const int* cid,
                                    const float* val, const float* b,
                                    float* c, int batch, int m_pad,
                                    int nnz_pad, int n_b, int n_block,
                                    void* stream) {
  const size_t smem = static_cast<size_t>(m_pad) * n_block * sizeof(float);
  cudaError_t e = repro::allow_smem(csr_kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(batch, (n_b + n_block - 1) / n_block);
  csr_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      rpt, cid, val, b, c, m_pad, nnz_pad, n_b, n_block,
      repro::sub_warp(n_block));
  return cudaGetLastError();
}
