// Degree-binned hybrid SpMM — hub rows as a dense slab, the other rows as a
// CSR remainder, rows computed in degree-sorted order and stored in their
// original order:
//   acc[q, :] = [q < d_pad] sum_m slab[s, q, m] * B[s, m, :]
//             + sum_{k < rlen[q]} val[s, start[q] + k] * B[s, cid[s, start[q] + k], :]
//   C[s, r, :] = acc[rank[s, r], :].
//
// Replaces the TPU kernel src/repro/kernels/batched_spmm_hybrid.py
// (batched_spmm_hybrid / _kernel, the pallas_hybrid registry entry), which
// ran one MXU dot for the hub slab and a masked loop per bin of sorted rows
// bounded by that bin's longest row, then gathered rows by rank.
//
// What bounds it on an H100: bytes. A slot is two 4-byte loads and one FMA
// per column; a hub row is m_pad slab loads and m_pad FMAs per column, far
// below the ridge either way. The call must move
//   batch * (3 * m_pad * 4 + nnz * 8 + d_pad * m_pad * 4 + 2 * m_pad * n_b * 4)
// bytes: rank, start and rlen, each sparse slot's id and value, the slab, B
// read once and C written once.
//
// Design: one block per (matrix x column panel), grid (batch, p), as the
// ELL kernel. The block stages its B panel (m_pad x n_block f32) in shared
// memory and turns rank into its inverse, perm[rank[r]] = r (m_pad ints).
// A sub-warp of next_pow2(n_block) <= 32 lanes then owns one SORTED row q
// at a time (q = group, group + groups, ...: the hub rows [0, d_pad) are
// spread evenly over the sub-warps) and keeps up to four of its columns in
// registers: for q < d_pad it reads the slab row from device memory (one
// broadcast load per m for the whole sub-warp) against the staged panel,
// then it walks the row's own rlen[q] CSR slots, where the TPU kernel
// looped each bin to its longest row (the port computes no per-bin
// bounds). A sorted row's whole sum is in one sub-warp's registers, so
// the epilogue's permutation is the store address: C[perm[q]] = acc, each
// row written once, no accumulator in shared memory. Column ids outside
// [0, m_pad) are skipped, as in the CSR kernel.
//
// No atomics: every output element is one fixed-order sum, so the result is
// bitwise the same from run to run.
//
// bf16 entry (batched_spmm_hybrid_bf16), the reference kernel's other
// operand branch (_kernel :121 with bf16 values, slab and B and the int16
// cid_f of narrow=, :199-200): one template over the value type V (values
// and slab), the dense type D and the column-id type I. The B panel is
// staged as bf16, slab and CSR products of the widened operands sum in f32
// registers, and each output is rounded to bf16 once
// (__float2bfloat16_rn). There is no i8 hybrid, as in the reference
// (has_scale=False).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;  // columns a lane holds: n_block <= 4 * 32

template <typename V, typename D, typename I>
__global__ void __launch_bounds__(kThreads)
hybrid_kernel(const int* __restrict__ rank, const int* __restrict__ start,
              const int* __restrict__ rlen, const I* __restrict__ cid,
              const V* __restrict__ val, const V* __restrict__ slab,
              const D* __restrict__ b, D* __restrict__ c, int m_pad,
              int nnz_pad, int n_b, int n_block, int d_pad, int sub) {
  extern __shared__ float hybrid_smem[];
  D* bs = reinterpret_cast<D*>(hybrid_smem);            // (m_pad, nbw)
  int* perm = reinterpret_cast<int*>(                   // (m_pad,)
      bs + repro::pad4<D>(m_pad * n_block));
  const int s = blockIdx.x;
  const int col0 = blockIdx.y * n_block;
  const int nbw = min(n_block, n_b - col0);
  const size_t mat = static_cast<size_t>(s) * m_pad;

  const D* bsrc = b + mat * n_b + col0;
  for (int i = threadIdx.x; i < m_pad * nbw; i += kThreads) {
    const int r = i / nbw, cc = i - r * nbw;
    bs[i] = bsrc[static_cast<size_t>(r) * n_b + cc];
  }
  for (int r = threadIdx.x; r < m_pad; r += kThreads) perm[r] = -1;
  __syncthreads();
  for (int r = threadIdx.x; r < m_pad; r += kThreads) {
    const int q = __ldg(rank + mat + r);
    if (static_cast<unsigned>(q) < static_cast<unsigned>(m_pad)) perm[q] = r;
  }
  __syncthreads();

  const int* st = start + mat;
  const int* rl = rlen + mat;
  const I* sc = cid + static_cast<size_t>(s) * nnz_pad;
  const V* sv = val + static_cast<size_t>(s) * nnz_pad;
  const int lane = threadIdx.x % sub, groups = kThreads / sub;
  D* dst = c + mat * n_b + col0;
  for (int q = threadIdx.x / sub; q < m_pad; q += groups) {
    const int r = perm[q];
    if (r < 0) continue;  // rank was not a permutation
    float acc[kCols];
#pragma unroll
    for (int t = 0; t < kCols; ++t) acc[t] = 0.f;
    if (q < d_pad) {
      const V* srow = slab + (static_cast<size_t>(s) * d_pad + q) * m_pad;
      for (int m = 0; m < m_pad; ++m) {
        const float a = repro::ldf(srow + m);
        const D* brow = bs + m * nbw;
#pragma unroll
        for (int t = 0; t < kCols; ++t) {
          const int cc = lane + sub * t;
          if (cc < nbw) acc[t] = fmaf(a, repro::to_f32(brow[cc]), acc[t]);
        }
      }
    }
    const int lo = max(__ldg(st + q), 0);
    const int hi = min(lo + max(__ldg(rl + q), 0), nnz_pad);
    for (int k = lo; k < hi; ++k) {
      const int j = repro::ldi(sc + k);
      if (static_cast<unsigned>(j) >= static_cast<unsigned>(m_pad)) continue;
      const float v = repro::ldf(sv + k);
      const D* brow = bs + j * nbw;
#pragma unroll
      for (int t = 0; t < kCols; ++t) {
        const int cc = lane + sub * t;
        if (cc < nbw) acc[t] = fmaf(v, repro::to_f32(brow[cc]), acc[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < kCols; ++t) {
      const int cc = lane + sub * t;
      if (cc < nbw)
        dst[static_cast<size_t>(r) * n_b + cc] = repro::from_f32<D>(acc[t]);
    }
  }
}

template <typename V, typename D, typename I>
int launch(const int* rank, const int* start, const int* rlen,
           const void* cid, const void* val, const void* slab, const void* b,
           void* c, int batch, int m_pad, int nnz_pad, int n_b, int n_block,
           int d_pad, void* stream) {
  const int sub = repro::sub_warp(n_block);
  if (n_block < 1 || n_block > kCols * sub || d_pad < 0 || d_pad > m_pad ||
      (d_pad > 0 && slab == nullptr))
    return cudaErrorInvalidValue;
  const size_t smem =
      static_cast<size_t>(repro::pad4<D>(m_pad * n_block)) * sizeof(D) +
      static_cast<size_t>(m_pad) * sizeof(int);
  cudaError_t e = repro::allow_smem(hybrid_kernel<V, D, I>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(batch, (n_b + n_block - 1) / n_block);
  hybrid_kernel<V, D, I>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          rank, start, rlen, static_cast<const I*>(cid),
          static_cast<const V*>(val), static_cast<const V*>(slab),
          static_cast<const D*>(b), static_cast<D*>(c), m_pad, nnz_pad, n_b,
          n_block, d_pad, sub);
  return cudaGetLastError();
}

}  // namespace

extern "C" int batched_spmm_hybrid_f32(const int* rank, const int* start,
                                       const int* rlen, const int* cid,
                                       const float* val, const float* slab,
                                       const float* b, float* c, int batch,
                                       int m_pad, int nnz_pad, int n_b,
                                       int n_block, int d_pad, void* stream) {
  return launch<float, float, int>(rank, start, rlen, cid, val, slab, b, c,
                                   batch, m_pad, nnz_pad, n_b, n_block, d_pad,
                                   stream);
}

// cid (batch, nnz_pad) int16; val, slab (batch, d_pad, m_pad), b and c bf16
extern "C" int batched_spmm_hybrid_bf16(const int* rank, const int* start,
                                        const int* rlen, const void* cid,
                                        const void* val, const void* slab,
                                        const void* b, void* c, int batch,
                                        int m_pad, int nnz_pad, int n_b,
                                        int n_block, int d_pad,
                                        void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16, short>(
      rank, start, rlen, cid, val, slab, b, c, batch, m_pad, nnz_pad, n_b,
      n_block, d_pad, stream);
}
