// Degree-binned hybrid SpMM — hub rows as a dense slab, the other rows as a
// CSR remainder, rows computed in degree-sorted order and stored in their
// original order:
//   acc[q, :] = [q < hubs[s]] sum_m slab[s, q, m] * B[s, m, :]
//             + sum_{k < rlen[q]} val[s, start[q] + k] * B[s, cid[s, start[q] + k], :]
//   C[s, r, :] = acc[rank[s, r], :]   (0 where rank[s, r] lies outside [0, m_pad)).
//
// Replaces the TPU kernel src/repro/kernels/batched_spmm_hybrid.py
// (batched_spmm_hybrid / _kernel, the pallas_hybrid registry entry), which
// ran one MXU dot for the hub slab and a masked loop per bin of sorted rows
// bounded by that bin's longest row, then gathered rows by rank.
//
// What bounds it on an H100: bytes, and at the paper's sizes latency. A
// slot is two loads and one FMA per column, a hub row m_pad slab loads and
// m_pad FMAs per column, far below the ridge either way. The call must move
//   batch * 4 + sum_s (3 * m_pad * 4 + nnz_s * 8 + hubs[s] * m_pad * 4
//                      + 2 * m_pad * n_b * 4)
// bytes: the hub counts, rank, start and rlen, each sparse slot's id and
// value, the hub rows of the slab, B read once and C written once. What held
// the first design back: its head walked all d_pad slab rows of every
// sample (Tox21 has no hub, yet read 2.75 MB of zeros a call), one block a
// (matrix x panel) left 92 of 132 SMs idle at 40 matrices, and each hub row
// was one sub-warp's serial walk over m_pad columns while the others idled.
//
// Design: the CSR kernel's row split, with B read where it lies (through
// the read-only cache; B is L2-resident at every size the port runs).
// Staging B's panel in shared memory instead, one block a (matrix x panel)
// as the paper's kernel and this file's first design do, was slower on an
// H100 80GB HBM3 at 700 W: +21-24% at Tox21 serving, 2.8x at the powerlaw
// batch (PERF.md section 6). The grid is (batch, row blocks, column
// panels), so a matrix is as many blocks as its rows need. A sub-warp of
// sub <= 32 lanes, each holding four neighbouring columns (one 16-byte f32
// or 8-byte bf16 load where n_b is a multiple of 4: at n_b 64 two rows a
// warp, and a quarter of the load instructions of one column a lane),
// takes one ORIGINAL row r at a time: q = rank[r]; a row whose sorted
// position is a hub (q < hubs[s]) is left to the head, any other walks its
// own rlen[q] CSR slots and is stored once, so no inverse permutation is
// needed. The head is bounded by each sample's hub count hubs[s] (computed
// by hybrid_operands on the device: exact, since the slab holds nothing
// past it): hub row q goes to row block q mod gridDim.y, whose sub-warps
// split its m_pad slab columns into contiguous chunks; the chunks' partial
// sums meet in shared memory and are added in chunk order, then the row is
// stored at every r with rank[r] == q. Column ids outside [0, m_pad) are
// skipped, as in the CSR kernel.
//
// No atomics: every output element is one fixed-order sum, so the result is
// bitwise the same from run to run.
//
// bf16 entry (batched_spmm_hybrid_bf16), the reference kernel's other
// operand branch (_kernel :121 with bf16 values, slab and B and the int16
// cid_f of narrow=, :199-200): one template over the value type V (values
// and slab), the dense type D and the column-id type I. Products of the
// widened operands sum in f32 registers, and each output is rounded to bf16
// once (__float2bfloat16_rn). There is no i8 hybrid, as in the reference
// (has_scale=False).
#include "common.cuh"

#include <cstdint>

namespace {

constexpr int kThreads = 256;
using repro::kW;
using repro::ldv;
using repro::load_cols;
using repro::store_cols;
// How deep the slot and slab loops unroll, the same in every instance: left
// to itself nvcc unrolls the f32 instance's loops this deep but the bf16
// one's half as deep (31 FFMAs in its SASS against 63), which kept fewer
// loads in flight and cost the bf16 entry 2.6% at the powerlaw batch on an
// H100 80GB HBM3 at 700 W (scripts/hybrid_types.py; the f32 SASS is the
// same either way).
constexpr int kUnroll = 4;

// (at most 64 registers a thread, so that four blocks fit an SM: left
// unbounded, nvcc gives the f32 instance enough more that only two do, and
// two hide less of the loads' latency)
template <typename V, typename D, typename I>
__global__ void __launch_bounds__(kThreads, 4)
hybrid_kernel(const int* __restrict__ rank, const int* __restrict__ start,
              const int* __restrict__ rlen, const I* __restrict__ cid,
              const V* __restrict__ val, const V* __restrict__ slab,
              const int* __restrict__ hubs, const D* __restrict__ b,
              D* __restrict__ c, int m_pad, int nnz_pad, int n_b, int n_block,
              int d_pad, int sub, int vec) {
  extern __shared__ __align__(16) float hybrid_smem[];
  const int groups = kThreads / sub;
  float* part = hybrid_smem;                   // (groups + 1, n_block)
  const int s = blockIdx.x;
  const int col0 = blockIdx.z * n_block;
  const int nbw = min(n_block, n_b - col0);
  const size_t mat = static_cast<size_t>(s) * m_pad;
  const int lane = threadIdx.x % sub, g = threadIdx.x / sub;

  const D* bsrc = b + mat * n_b + col0;
  const int* rk = rank + mat;
  const int* st = start + mat;
  const int* rl = rlen + mat;
  const I* sc = cid + static_cast<size_t>(s) * nnz_pad;
  const V* sv = val + static_cast<size_t>(s) * nnz_pad;
  D* dst = c + mat * n_b + col0;
  const int n_hub =
      slab == nullptr ? 0 : min(max(__ldg(hubs + s), 0), d_pad);

  // this lane's kW columns of the panel (none past it)
  const int cc = kW * lane;
  const bool mine = cc < nbw;
  // acc += a * B[m] in this lane's columns
  auto fma_row = [&](float a, int m, float* acc) {
    float x[kW];
    load_cols(bsrc + static_cast<size_t>(m) * n_b + cc, vec, nbw - cc, x);
#pragma unroll
    for (int i = 0; i < kW; ++i) acc[i] = fmaf(a, x[i], acc[i]);
  };
  // += the CSR slots of sorted row q (ids outside [0, m_pad) skipped)
  auto slots = [&](int q, float* acc) {
    const int lo = max(__ldg(st + q), 0);
    const int hi = min(lo + max(__ldg(rl + q), 0), nnz_pad);
#pragma unroll kUnroll
    for (int k = lo; k < hi; ++k) {
      // both loads before the branch, so that they issue together
      const int j = repro::ldi(sc + k);
      const float v = ldv(sv + k);
      if (static_cast<unsigned>(j) < static_cast<unsigned>(m_pad))
        fma_row(v, j, acc);
    }
  };
  auto store = [&](int r, const float* acc) {
    if (mine)
      store_cols(dst + static_cast<size_t>(r) * n_b + cc, acc, vec, nbw - cc);
  };

  // every row that is not a hub: its CSR slots
  for (int r = blockIdx.y * groups + g; r < m_pad;
       r += gridDim.y * groups) {
    const int q = __ldg(rk + r);
    float acc[kW] = {};
    if (static_cast<unsigned>(q) < static_cast<unsigned>(m_pad)) {
      if (q < n_hub) continue;   // the head stores it
      if (mine) slots(q, acc);
    }
    store(r, acc);
  }

  // the hub rows of this row block: each over all its sub-warps
  const int chunk = (m_pad + groups - 1) / groups;
  float* row_sum = part + groups * n_block;
  for (int q = blockIdx.y; q < n_hub; q += gridDim.y) {
    float acc[kW] = {};
    const V* srow = slab + (static_cast<size_t>(s) * d_pad + q) * m_pad;
    const int m_end = min(m_pad, (g + 1) * chunk);
    if (mine)
#pragma unroll kUnroll
      for (int m = g * chunk; m < m_end; ++m)
        fma_row(ldv(srow + m), m, acc);
#pragma unroll
    for (int i = 0; i < kW; ++i)
      if (cc + i < nbw) part[g * n_block + cc + i] = acc[i];
    __syncthreads();
    // the chunks in order, then the row's CSR slots (none where
    // hybrid_operands built them), one thread a column
    for (int col = threadIdx.x; col < nbw; col += kThreads) {
      float sum = part[col];
      for (int h = 1; h < groups; ++h) sum += part[h * n_block + col];
      const int lo = max(__ldg(st + q), 0);
      const int hi = min(lo + max(__ldg(rl + q), 0), nnz_pad);
      for (int k = lo; k < hi; ++k) {
        const int j = repro::ldi(sc + k);
        if (static_cast<unsigned>(j) < static_cast<unsigned>(m_pad))
          sum = fmaf(ldv(sv + k),
                     repro::to_f32(bsrc[static_cast<size_t>(j) * n_b + col]),
                     sum);
      }
      row_sum[col] = sum;
    }
    __syncthreads();
    for (int r = g; r < m_pad; r += groups) {
      if (__ldg(rk + r) != q) continue;
#pragma unroll
      for (int i = 0; i < kW; ++i)
        acc[i] = cc + i < nbw ? row_sum[cc + i] : 0.f;
      store(r, acc);
    }
    __syncthreads();
  }
}

template <typename V, typename D, typename I>
int launch(const int* rank, const int* start, const int* rlen,
           const void* cid, const void* val, const void* slab,
           const int* hubs, const void* b, void* c, int batch, int m_pad,
           int nnz_pad, int n_b, int n_block, int d_pad, void* stream) {
  const int panel = min(n_block, repro::kPanelMax);
  // lanes of a sub-warp: one for each kW columns of the panel, <= 32
  const int sub = repro::sub_warp((panel + kW - 1) / kW);
  if (n_block < 1 || d_pad < 0 || d_pad > m_pad ||
      (d_pad > 0 && (slab == nullptr || hubs == nullptr)))
    return cudaErrorInvalidValue;
  const int groups = kThreads / sub;
  auto aligned = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p) % (kW * sizeof(D)) == 0;
  };
  const int vec = n_b % kW == 0 && aligned(b) && aligned(c);
  const size_t smem = static_cast<size_t>(groups + 1) * panel * sizeof(float);
  const dim3 grid(batch, repro::large_blocks(m_pad, groups),
                  (n_b + panel - 1) / panel);
  cudaError_t e = repro::allow_smem(hybrid_kernel<V, D, I>, smem);
  if (e != cudaSuccess) return e;
  hybrid_kernel<V, D, I>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          rank, start, rlen, static_cast<const I*>(cid),
          static_cast<const V*>(val),
          static_cast<const V*>(d_pad ? slab : nullptr), hubs,
          static_cast<const D*>(b), static_cast<D*>(c), m_pad, nnz_pad, n_b,
          panel, d_pad, sub, vec);
  return cudaGetLastError();
}

}  // namespace

// hubs (batch,) int32: slab rows q < hubs[s] form sample s's head (clamped
// to d_pad); slab and hubs may be null when d_pad == 0
extern "C" int batched_spmm_hybrid_f32(const int* rank, const int* start,
                                       const int* rlen, const int* cid,
                                       const float* val, const float* slab,
                                       const int* hubs, const float* b,
                                       float* c, int batch, int m_pad,
                                       int nnz_pad, int n_b, int n_block,
                                       int d_pad, void* stream) {
  return launch<float, float, int>(rank, start, rlen, cid, val, slab, hubs,
                                   b, c, batch, m_pad, nnz_pad, n_b, n_block,
                                   d_pad, stream);
}

// cid (batch, nnz_pad) int16; val, slab (batch, d_pad, m_pad), b and c bf16
extern "C" int batched_spmm_hybrid_bf16(const int* rank, const int* start,
                                        const int* rlen, const void* cid,
                                        const void* val, const void* slab,
                                        const int* hubs, const void* b,
                                        void* c, int batch, int m_pad,
                                        int nnz_pad, int n_b, int n_block,
                                        int d_pad, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16, short>(
      rank, start, rlen, cid, val, slab, hubs, b, c, batch, m_pad, nnz_pad,
      n_b, n_block, d_pad, stream);
}
