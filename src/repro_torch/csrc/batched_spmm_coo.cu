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
//
// bf16 entry (batched_spmm_coo_bf16), the reference kernel's other operand
// branches (_kernel :51: int16 row and column ids widened on load (:61),
// bf16 values and B): one template over the value type V, the dense type D
// and the id type I. The output panel in shared memory stays f32 (the
// atomics add f32 products of the widened operands), B rows are read as
// bf16 from global memory, and each output is rounded to bf16 once on the
// way out (__float2bfloat16_rn). It runs the pallas_coo_bf16 forward and
// dB / dU of the pallas_ell_bf16 and fused_bf16 backwards. The m_pad row-id
// sentinel fits int16 because the wrapper's narrowing refuses
// m_pad > 32767.
//
// g-SpMM entry (batched_gspmm_coo_f32), the reference kernel's (op, reduce)
// branches: C[s, r] = reduce_{i < nnz[s], rid[i] = r} op(B[s, cid[i]], e_i)
// with op in {mul, add, copy_lhs}, reduce in {sum, max, mean}, and scalar
// edges e (batch, nnz_pad) or vector edges (batch, nnz_pad, n_b), read
// panel-blocked like B. Padding is not inert by value outside (mul, sum),
// so the slot loop stops at nnz[s] instead of skipping 0.0 values. The
// same block layout as above; sum and mean add with shared-memory
// atomicAdd, max with a compare-and-swap float max (exact in any order, so
// max corners equal the plain version bit for bit). Beside the panel the
// block counts each row's degree in shared memory (one atomic per valid
// slot, the row id clipped into [0, m_pad) as the reference's wrapper
// does); the write-out divides by max(deg, 1) for mean and writes 0.0 into
// rows of degree 0 for max (the accumulator starts at the finite -3e38).
//
// Large-matrix entries (batched_spmm_coo_large_{f32,bf16},
// batched_gspmm_coo_large_f32), for paper case 3, where the reference takes
// its plain per-sample path (src/repro/kernels/ops.py _forward_base) and
// the (m_pad x n_block) f32 panel does not fit a block's shared memory:
// the output accumulates in global memory instead, in an f32 buffer the
// wrapper zeroes (torch.zeros; -3e38 for max), with global atomicAdd (sum,
// mean) or the compare-and-swap float max, over a grid of (batch, slot
// blocks, column panels of at most 128 columns). The degrees of the g-SpMM
// entry count into a zeroed global (batch, m_pad) int32 buffer, once per
// slot (panel 0 only). A second pass then finishes each element as the
// batched kernel's write-out does: the mean / empty-max fix-up, and the
// one rounding to bf16 for the bf16 entry (whose ids may also be int32,
// ids32, past int16's range). Like the batched entries, the sums are not
// bitwise repeatable.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename V, typename D, typename I>
__global__ void __launch_bounds__(kThreads)
coo_kernel(const I* __restrict__ rid, const I* __restrict__ cid,
           const V* __restrict__ val, const D* __restrict__ b,
           D* __restrict__ c, int nnz_pad, int m_pad, int n_b, int n_block,
           int sub) {
  extern __shared__ float acc[];  // (m_pad, nbw) f32 output panel
  const int s = blockIdx.x;
  const int col0 = blockIdx.y * n_block;
  const int nbw = min(n_block, n_b - col0);
  for (int i = threadIdx.x; i < m_pad * nbw; i += kThreads) acc[i] = 0.f;
  __syncthreads();

  const size_t off = static_cast<size_t>(s) * nnz_pad;
  const size_t mat = static_cast<size_t>(s) * m_pad;
  const D* bsrc = b + mat * n_b + col0;
  const int lane = threadIdx.x % sub, groups = kThreads / sub;
  for (int i = threadIdx.x / sub; i < nnz_pad; i += groups) {
    const float v = repro::ldf(val + off + i);
    const int r = repro::ldi(rid + off + i), j = repro::ldi(cid + off + i);
    if (v == 0.f || static_cast<unsigned>(r) >= static_cast<unsigned>(m_pad) ||
        static_cast<unsigned>(j) >= static_cast<unsigned>(m_pad))
      continue;
    const D* brow = bsrc + static_cast<size_t>(j) * n_b;
    float* arow = acc + r * nbw;
    for (int cc = lane; cc < nbw; cc += sub)
      atomicAdd(arow + cc, v * repro::ldf(brow + cc));
  }
  __syncthreads();

  D* dst = c + mat * n_b + col0;
  for (int i = threadIdx.x; i < m_pad * nbw; i += kThreads) {
    const int r = i / nbw, cc = i - r * nbw;
    dst[static_cast<size_t>(r) * n_b + cc] = repro::from_f32<D>(acc[i]);
  }
}

__global__ void __launch_bounds__(kThreads)
coo_gspmm_kernel(const int* __restrict__ rid, const int* __restrict__ cid,
                 const float* __restrict__ val, const int* __restrict__ nnz,
                 const float* __restrict__ b, float* __restrict__ c,
                 int nnz_pad, int m_pad, int n_b, int n_block, int sub,
                 int op, int reduce, int vec) {
  extern __shared__ float acc[];  // (m_pad, nbw) output panel, then degrees
  int* deg = reinterpret_cast<int*>(acc + static_cast<size_t>(m_pad) *
                                    n_block);
  const int s = blockIdx.x;
  const int col0 = blockIdx.y * n_block;
  const int nbw = min(n_block, n_b - col0);
  const float init = reduce == repro::kMax ? repro::kNegInf : 0.f;
  for (int i = threadIdx.x; i < m_pad * nbw; i += kThreads) acc[i] = init;
  for (int i = threadIdx.x; i < m_pad; i += kThreads) deg[i] = 0;
  __syncthreads();

  const int n = min(__ldg(nnz + s), nnz_pad);
  const size_t off = static_cast<size_t>(s) * nnz_pad;
  const size_t mat = static_cast<size_t>(s) * m_pad;
  const float* bsrc = b + mat * n_b + col0;
  const int lane = threadIdx.x % sub, groups = kThreads / sub;
  for (int i = threadIdx.x / sub; i < n; i += groups) {
    const int r = __ldg(rid + off + i), j = __ldg(cid + off + i);
    if (lane == 0) atomicAdd(deg + min(max(r, 0), m_pad - 1), 1);
    if (static_cast<unsigned>(r) >= static_cast<unsigned>(m_pad) ||
        static_cast<unsigned>(j) >= static_cast<unsigned>(m_pad))
      continue;
    const float* brow = bsrc + static_cast<size_t>(j) * n_b;
    const float* erow = val + (off + i) * (vec ? n_b : 1) + (vec ? col0 : 0);
    const float es = (op == repro::kOpCopyLhs || vec) ? 0.f : __ldg(erow);
    float* arow = acc + r * nbw;
    for (int cc = lane; cc < nbw; cc += sub) {
      const float e = (vec && op != repro::kOpCopyLhs) ? __ldg(erow + cc) : es;
      const float m = repro::combine(__ldg(brow + cc), e, op);
      if (reduce == repro::kMax)
        repro::atomic_max_f32(arow + cc, m);
      else
        atomicAdd(arow + cc, m);
    }
  }
  __syncthreads();

  float* dst = c + mat * n_b + col0;
  for (int i = threadIdx.x; i < m_pad * nbw; i += kThreads) {
    const int r = i / nbw, cc = i - r * nbw;
    dst[static_cast<size_t>(r) * n_b + cc] =
        repro::finish(acc[i], deg[r], reduce);
  }
}

}  // namespace

extern "C" int batched_gspmm_coo_f32(const int* rid, const int* cid,
                                     const float* val, const int* nnz,
                                     const float* b, float* c, int batch,
                                     int nnz_pad, int m_pad, int n_b,
                                     int n_block, int op, int reduce,
                                     int vec, void* stream) {
  const size_t smem =
      (static_cast<size_t>(m_pad) * n_block + m_pad) * sizeof(float);
  cudaError_t e = repro::allow_smem(coo_gspmm_kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(batch, (n_b + n_block - 1) / n_block);
  coo_gspmm_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      rid, cid, val, nnz, b, c, nnz_pad, m_pad, n_b, n_block,
      repro::sub_warp(n_block), op, reduce, vec);
  return cudaGetLastError();
}

namespace {

// The large-matrix branch. Slots per sub-warp and block: a block takes
// the slots [y chunk, (y + 1) chunk) of its matrix, chunk = 256 / sub * 8,
// and strides by the grid past 65535 blocks.
constexpr int kSlotsPerGroup = 8;

template <typename V, typename D, typename I>
__global__ void __launch_bounds__(kThreads)
coo_large_kernel(const I* __restrict__ rid, const I* __restrict__ cid,
                 const V* __restrict__ val, const D* __restrict__ b,
                 float* __restrict__ acc, int nnz_pad, int m_pad, int n_b,
                 int n_block, int sub) {
  const int s = blockIdx.x;
  const int col0 = blockIdx.z * n_block;
  const int nbw = min(n_block, n_b - col0);
  const size_t off = static_cast<size_t>(s) * nnz_pad;
  const size_t mat = static_cast<size_t>(s) * m_pad;
  const D* bsrc = b + mat * n_b + col0;
  float* asrc = acc + mat * n_b + col0;
  const int lane = threadIdx.x % sub, groups = kThreads / sub;
  const int chunk = groups * kSlotsPerGroup;
  for (int i0 = blockIdx.y * chunk; i0 < nnz_pad; i0 += gridDim.y * chunk) {
    const int i1 = min(i0 + chunk, nnz_pad);
    for (int i = i0 + threadIdx.x / sub; i < i1; i += groups) {
      const float v = repro::ldf(val + off + i);
      const int r = repro::ldi(rid + off + i), j = repro::ldi(cid + off + i);
      if (v == 0.f ||
          static_cast<unsigned>(r) >= static_cast<unsigned>(m_pad) ||
          static_cast<unsigned>(j) >= static_cast<unsigned>(m_pad))
        continue;
      const D* brow = bsrc + static_cast<size_t>(j) * n_b;
      float* arow = asrc + static_cast<size_t>(r) * n_b;
      for (int cc = lane; cc < nbw; cc += sub)
        atomicAdd(arow + cc, v * repro::ldf(brow + cc));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
coo_gspmm_large_kernel(const int* __restrict__ rid,
                       const int* __restrict__ cid,
                       const float* __restrict__ val,
                       const int* __restrict__ nnz,
                       const float* __restrict__ b, float* __restrict__ acc,
                       int* __restrict__ deg, int nnz_pad, int m_pad, int n_b,
                       int n_block, int sub, int op, int reduce, int vec) {
  const int s = blockIdx.x;
  const int col0 = blockIdx.z * n_block;
  const int nbw = min(n_block, n_b - col0);
  const int n = min(__ldg(nnz + s), nnz_pad);
  const size_t off = static_cast<size_t>(s) * nnz_pad;
  const size_t mat = static_cast<size_t>(s) * m_pad;
  const float* bsrc = b + mat * n_b + col0;
  float* asrc = acc + mat * n_b + col0;
  int* dsrc = deg + mat;
  const int lane = threadIdx.x % sub, groups = kThreads / sub;
  const int chunk = groups * kSlotsPerGroup;
  for (int i0 = blockIdx.y * chunk; i0 < n; i0 += gridDim.y * chunk) {
    const int i1 = min(i0 + chunk, n);
    for (int i = i0 + threadIdx.x / sub; i < i1; i += groups) {
      const int r = __ldg(rid + off + i), j = __ldg(cid + off + i);
      if (lane == 0 && blockIdx.z == 0)
        atomicAdd(dsrc + min(max(r, 0), m_pad - 1), 1);
      if (static_cast<unsigned>(r) >= static_cast<unsigned>(m_pad) ||
          static_cast<unsigned>(j) >= static_cast<unsigned>(m_pad))
        continue;
      const float* brow = bsrc + static_cast<size_t>(j) * n_b;
      const float* erow =
          val + (off + i) * (vec ? n_b : 1) + (vec ? col0 : 0);
      const float es =
          (op == repro::kOpCopyLhs || vec) ? 0.f : __ldg(erow);
      float* arow = asrc + static_cast<size_t>(r) * n_b;
      for (int cc = lane; cc < nbw; cc += sub) {
        const float e =
            (vec && op != repro::kOpCopyLhs) ? __ldg(erow + cc) : es;
        const float m = repro::combine(__ldg(brow + cc), e, op);
        if (reduce == repro::kMax)
          repro::atomic_max_f32(arow + cc, m);
        else
          atomicAdd(arow + cc, m);
      }
    }
  }
}

// The write-out of the large branch, one element per thread: out =
// finish(acc, deg) (deg null: the plain sum), rounded to D once; out may
// be acc itself.
template <typename D>
__global__ void __launch_bounds__(kThreads)
coo_finish_kernel(const float* acc, const int* __restrict__ deg, D* out,
                  size_t rows, int n_b, int reduce) {
  const size_t total = rows * n_b;
  for (size_t i = blockIdx.x * static_cast<size_t>(kThreads) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * kThreads) {
    const float x = acc[i];
    out[i] = repro::from_f32<D>(
        deg == nullptr ? x : repro::finish(x, deg[i / n_b], reduce));
  }
}

template <typename D>
cudaError_t finish_launch(const float* acc, const int* deg, D* out,
                          size_t rows, int n_b, int reduce,
                          cudaStream_t stream) {
  const size_t blocks = (rows * n_b + kThreads - 1) / kThreads;
  coo_finish_kernel<D><<<static_cast<unsigned>(blocks < 65535 ? blocks
                                                              : 65535),
                         kThreads, 0, stream>>>(acc, deg, out, rows, n_b,
                                                reduce);
  return cudaGetLastError();
}

// grid of the large scatter: (batch, slot blocks, panels)
dim3 large_grid(int batch, int slots, int n_b, int panel) {
  return dim3(batch,
              repro::large_blocks(slots, kThreads / repro::sub_warp(panel) *
                                             kSlotsPerGroup),
              (n_b + panel - 1) / panel);
}

// acc is the zeroed f32 output for f32, a zeroed f32 buffer beside the
// bf16 output c otherwise.
template <typename V, typename D, typename I>
int large_launch(const void* rid, const void* cid, const void* val,
                 const void* b, float* acc, void* c, int batch, int nnz_pad,
                 int m_pad, int n_b, int n_block, void* stream_ptr) {
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  const int panel = min(n_block, repro::kPanelMax);
  coo_large_kernel<V, D, I>
      <<<large_grid(batch, nnz_pad, n_b, panel), kThreads, 0, stream>>>(
          static_cast<const I*>(rid), static_cast<const I*>(cid),
          static_cast<const V*>(val), static_cast<const D*>(b), acc, nnz_pad,
          m_pad, n_b, panel, repro::sub_warp(panel));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || static_cast<void*>(acc) == c) return e;
  return finish_launch(acc, nullptr, static_cast<D*>(c),
                       static_cast<size_t>(batch) * m_pad, n_b, repro::kSum,
                       stream);
}

template <typename V, typename D, typename I>
int launch(const void* rid, const void* cid, const void* val, const void* b,
           void* c, int batch, int nnz_pad, int m_pad, int n_b, int n_block,
           void* stream) {
  const size_t smem = static_cast<size_t>(m_pad) * n_block * sizeof(float);
  cudaError_t e = repro::allow_smem(coo_kernel<V, D, I>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(batch, (n_b + n_block - 1) / n_block);
  coo_kernel<V, D, I>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const I*>(rid), static_cast<const I*>(cid),
          static_cast<const V*>(val), static_cast<const D*>(b),
          static_cast<D*>(c), nnz_pad, m_pad, n_b, n_block,
          repro::sub_warp(n_block));
  return cudaGetLastError();
}

}  // namespace

extern "C" int batched_spmm_coo_f32(const int* rid, const int* cid,
                                    const float* val, const float* b,
                                    float* c, int batch, int nnz_pad,
                                    int m_pad, int n_b, int n_block,
                                    void* stream) {
  return launch<float, float, int>(rid, cid, val, b, c, batch, nnz_pad,
                                   m_pad, n_b, n_block, stream);
}

// rid and cid (batch, nnz_pad) int16, val bf16, b and c (batch, m_pad, n_b)
// bf16
extern "C" int batched_spmm_coo_bf16(const void* rid, const void* cid,
                                     const void* val, const void* b, void* c,
                                     int batch, int nnz_pad, int m_pad,
                                     int n_b, int n_block, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16, short>(
      rid, cid, val, b, c, batch, nnz_pad, m_pad, n_b, n_block, stream);
}

// The large-matrix entries. acc (batch, m_pad, n_b) f32 zeroed by the
// caller: for f32 it is c itself; for bf16 the kernel rounds it into c.
extern "C" int batched_spmm_coo_large_f32(const int* rid, const int* cid,
                                          const float* val, const float* b,
                                          float* c, int batch, int nnz_pad,
                                          int m_pad, int n_b, int n_block,
                                          void* stream) {
  return large_launch<float, float, int>(rid, cid, val, b, c, c, batch,
                                         nnz_pad, m_pad, n_b, n_block,
                                         stream);
}

extern "C" int batched_spmm_coo_large_bf16(const void* rid, const void* cid,
                                           const void* val, const void* b,
                                           float* acc, void* c, int batch,
                                           int nnz_pad, int m_pad, int n_b,
                                           int n_block, int ids32,
                                           void* stream) {
  using B = __nv_bfloat16;
  return ids32 ? large_launch<B, B, int>(rid, cid, val, b, acc, c, batch,
                                         nnz_pad, m_pad, n_b, n_block,
                                         stream)
               : large_launch<B, B, short>(rid, cid, val, b, acc, c, batch,
                                           nnz_pad, m_pad, n_b, n_block,
                                           stream);
}

// c (batch, m_pad, n_b) f32 filled by the caller with 0.0 (-3e38 for max),
// deg (batch, m_pad) int32 zeroed by the caller; c is finished in place.
extern "C" int batched_gspmm_coo_large_f32(
    const int* rid, const int* cid, const float* val, const int* nnz,
    const float* b, float* c, int* deg, int batch, int nnz_pad, int m_pad,
    int n_b, int n_block, int op, int reduce, int vec, void* stream_ptr) {
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  const int panel = min(n_block, repro::kPanelMax);
  coo_gspmm_large_kernel<<<large_grid(batch, nnz_pad, n_b, panel), kThreads,
                           0, stream>>>(
      rid, cid, val, nnz, b, c, deg, nnz_pad, m_pad, n_b, panel,
      repro::sub_warp(panel), op, reduce, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return finish_launch(c, deg, c, static_cast<size_t>(batch) * m_pad, n_b,
                       reduce, stream);
}
