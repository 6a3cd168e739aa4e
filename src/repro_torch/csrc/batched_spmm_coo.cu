// Batched COO SpMM — the paper's batched SWA-SpMM for SparseTensor (split
// by non-zero, shared-memory atomics), C[s, rid] += val * B[s, cid, :].
//
// Replaces the TPU kernel src/repro/kernels/batched_spmm_coo.py
// (batched_spmm_coo / _kernel, the pallas_coo registry entry), whose
// one-hot MXU contraction stood in for the atomics a TPU lacks.
//
// What bounds it on an H100: bytes, as for the ELL kernel (~1 FMA per 8
// bytes of ids and values), plus the shared-memory atomics of the scatter.
// At the main-path shape (512 matrices of 56 rows, nnz_pad 256, n_b 64) the
// call moves ~16 MB, ~5 us of HBM time: the size of one launch.
//
// Design: one block per (matrix x column panel), grid (batch, p). The
// block's output panel (m_pad x n_block f32, 14 KB at the main-path shape)
// lives in shared memory. A sub-warp of next_pow2(n_block) <= 32 lanes takes
// one non-zero at a time, reads its B row from global memory (L2) and adds
// val * B into the panel with shared-memory atomicAdd, its lanes striding
// the columns. A slot whose value is 0.0 (padding) costs a load and no
// atomic; row ids outside [0, m_pad) — the m_pad sentinel the reference's
// scatter drops — and column ids outside it are skipped. The panel is
// written out once.
//
// The atomics make the order of the adds, and so the last bits of a sum,
// vary from run to run; the result is held to the f32 tolerance.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
coo_kernel(const int* __restrict__ rid, const int* __restrict__ cid,
           const float* __restrict__ val, const float* __restrict__ b,
           float* __restrict__ c, int nnz_pad, int m_pad, int n_b,
           int n_block, int sub) {
  extern __shared__ float acc[];  // (m_pad, nbw) output panel
  const int s = blockIdx.x;
  const int col0 = blockIdx.y * n_block;
  const int nbw = min(n_block, n_b - col0);
  for (int i = threadIdx.x; i < m_pad * nbw; i += kThreads) acc[i] = 0.f;
  __syncthreads();

  const size_t off = static_cast<size_t>(s) * nnz_pad;
  const size_t mat = static_cast<size_t>(s) * m_pad;
  const float* bsrc = b + mat * n_b + col0;
  const int lane = threadIdx.x % sub, groups = kThreads / sub;
  for (int i = threadIdx.x / sub; i < nnz_pad; i += groups) {
    const float v = __ldg(val + off + i);
    const int r = __ldg(rid + off + i), j = __ldg(cid + off + i);
    if (v == 0.f || static_cast<unsigned>(r) >= static_cast<unsigned>(m_pad) ||
        static_cast<unsigned>(j) >= static_cast<unsigned>(m_pad))
      continue;
    const float* brow = bsrc + static_cast<size_t>(j) * n_b;
    float* arow = acc + r * nbw;
    for (int cc = lane; cc < nbw; cc += sub)
      atomicAdd(arow + cc, v * __ldg(brow + cc));
  }
  __syncthreads();

  float* dst = c + mat * n_b + col0;
  for (int i = threadIdx.x; i < m_pad * nbw; i += kThreads) {
    const int r = i / nbw, cc = i - r * nbw;
    dst[static_cast<size_t>(r) * n_b + cc] = acc[i];
  }
}

}  // namespace

extern "C" int batched_spmm_coo_f32(const int* rid, const int* cid,
                                    const float* val, const float* b,
                                    float* c, int batch, int nnz_pad,
                                    int m_pad, int n_b, int n_block,
                                    void* stream) {
  const size_t smem = static_cast<size_t>(m_pad) * n_block * sizeof(float);
  cudaError_t e = repro::allow_smem(coo_kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(batch, (n_b + n_block - 1) / n_block);
  coo_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      rid, cid, val, b, c, nnz_pad, m_pad, n_b, n_block,
      repro::sub_warp(n_block));
  return cudaGetLastError();
}
