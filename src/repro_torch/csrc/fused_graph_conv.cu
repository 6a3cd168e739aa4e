// Fused graph-conv layer — Y = epi(sum_ch A_ch (X W_ch + b_ch) [+ res]) in
// ONE kernel, the whole ChemGCN layer of paper Fig. 7 per launch.
//
// Replaces the TPU kernel src/repro/kernels/fused_graph_conv.py
// (fused_forward / _kernel, the fused registry entry, and its rank/slab
// hybrid branch reached from fused_hybrid_forward, the fused_hybrid entry).
//
// What bounds it on an H100: operations at wide layers, launches at narrow
// ones. The feature transform is 2 * m_pad * n_in * n_out FLOP per sample
// and channel (15 GFLOP per Reaction100 layer at 128 samples: 0.23 ms at
// the 67 TFLOP/s f32 peak) against a few MB of X, W and Y; at Tox21 widths
// (62 -> 64) it is 0.23 GFLOP, ~3.4 us, the size of one launch.
//
// Design: one block per (sample x output-column panel), grid (batch, p).
// Shared memory holds the sample's X tile (m_pad x n_in), one channel's
// U_ch panel (m_pad x n_block) and the accumulator (m_pad x n_block): 42 KB
// at Tox21, 172 KB at Reaction100 layers 2-3 (n_in 512, n_block 128), which
// is why the launch opts into more than 48 KB of dynamic shared memory. For
// each channel the block computes U_ch = X W_ch[:, panel] + b_ch with f32
// FMAs (no TF32): a warp spans 32 columns, each thread keeps a 8-row x
// 4-column tile in registers, reads X from shared memory (one broadcast per
// row) and W from global memory (L2; W is 4 MB at Reaction100 and is not
// staged). After a barrier, sub-warps scatter val * U_ch[cid] into the
// accumulator with shared-memory atomicAdd. Each (sample x channel) visits
// only its real chunks[s, ch] * chunk slots (the reference's skew-aware
// bound; a channel with no chunk skips its transform too), and a slot whose
// value is 0.0 — padding, which the reference lets sit anywhere inside the
// visited chunks — costs a load and no atomic. The epilogue adds the
// residual, applies ReLU and stores the panel once. The atomics make the
// last bits of a sum vary from run to run; the result is held to the f32
// tolerance.
//
// Hybrid branch (entry fused_graph_conv_hybrid_f32; template kHybrid): the
// accumulator holds the rows in degree-sorted order. The sparse slots'
// row ids are already sorted positions (hub slots carry the m_pad
// sentinel and are skipped), and for each channel, once U_ch is in shared
// memory, the block adds the head slab_ch . U_ch into accumulator rows
// [0, d_pad): one thread per (hub row, column) reads the slab row from
// device memory (a broadcast load per m for the warp; 12.5 KB per channel
// at m_pad 56, 128 KB at m_pad 256, so it is streamed, not staged, and
// the shared memory stays the plain kernel's) against the staged U_ch
// panel and adds the sum with one atomicAdd, so no extra barrier is needed
// against the scatter's atomics. Every channel runs its transform even
// with no sparse chunk, since its hub rows may still hold slots. The
// epilogue reads acc[rank[r]] for output row r, then adds the residual and
// applies ReLU, the reference's order. The head costs d_pad * m_pad FMAs
// per column and channel: 4 * 128 * 256 * 64 per powerlaw sample.
//
// bf16 entry (fused_graph_conv_bf16, the fused_bf16 registry entry), the
// reference kernel's other operand branch (_kernel :54 with int16 ids
// widened on load (:90) and bf16 values, X, W and bias): one template over
// the value type V, the dense type D (X, W, bias, residual and Y) and the
// id type I. The X tile is staged as bf16 (half the f32 tile), U_ch =
// X W_ch + b_ch is computed with f32 FMAs of the widened operands and kept
// in the f32 shared panel, never rounded; the scatter adds f32 products
// into the f32 accumulator, and only Y is rounded to bf16, once, in the
// epilogue (__float2bfloat16_rn), as the reference stores its f32
// accumulator in X's dtype. At 512 width the transform's operations bound
// it: the bf16 tensor-core peak is the yardstick, and this f32-FMA loop is
// far from it.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 32;                     // threads along the columns
constexpr int kRowGroups = kThreads / kLanes;  // threads along the rows
constexpr int kCols = 4;                       // columns per thread
constexpr int kRows = 8;                       // rows per thread and pass

template <typename V, typename D, typename I, bool kHybrid>
__global__ void __launch_bounds__(kThreads)
fused_kernel(const I* __restrict__ rid, const I* __restrict__ cid,
             const V* __restrict__ val, const int* __restrict__ chunks,
             const D* __restrict__ x, const D* __restrict__ w,
             const D* __restrict__ bias, const D* __restrict__ res,
             const int* __restrict__ rank, const V* __restrict__ slab,
             D* __restrict__ y, int channels, int nnz_pad, int chunk,
             int m_pad, int n_in, int n_out, int n_block, int d_pad, int relu,
             int sub) {
  extern __shared__ __align__(16) float fused_smem[];
  D* xs = reinterpret_cast<D*>(fused_smem);  // (m_pad, n_in) X tile
  // the f32 panels start at the next 16 bytes, an offset from the float
  // base: with U at xs + m_pad * n_in the f32 entry compiled to code ~8%
  // slower on an H100 (PERF.md, Findings)
  float* us = fused_smem + repro::words16(m_pad * n_in * sizeof(D));
  float* acc = us + m_pad * n_block;         // (m_pad, nbw) accumulator
  const int s = blockIdx.x;
  const int col0 = blockIdx.y * n_block;
  const int nbw = min(n_block, n_out - col0);
  const int tid = threadIdx.x;

  const D* xsrc = x + static_cast<size_t>(s) * m_pad * n_in;
  for (int i = tid; i < m_pad * n_in; i += kThreads) xs[i] = xsrc[i];
  for (int i = tid; i < m_pad * nbw; i += kThreads) acc[i] = 0.f;
  __syncthreads();

  const int tx = tid % kLanes, ty = tid / kLanes;
  const int lane = tid % sub, groups = kThreads / sub;
  for (int ch = 0; ch < channels; ++ch) {
    const int sc = s * channels + ch;
    const int n = min(max(chunks[sc], 0) * chunk, nnz_pad);
    // the same for every thread of the block; hub rows need U_ch regardless
    if (!kHybrid && n == 0) continue;

    const D* wch = w + static_cast<size_t>(ch) * n_in * n_out + col0;
    const D* bch = bias + static_cast<size_t>(ch) * n_out + col0;
    for (int r0 = 0; r0 < m_pad; r0 += kRowGroups * kRows) {
      float a[kRows][kCols];
      const D* xr[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        xr[i] = xs + min(r0 + ty + kRowGroups * i, m_pad - 1) * n_in;
#pragma unroll
        for (int q = 0; q < kCols; ++q) a[i][q] = 0.f;
      }
      for (int k = 0; k < n_in; ++k) {
        float wv[kCols];
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          const int cc = tx + kLanes * q;
          wv[q] = cc < nbw
                      ? repro::ldf(wch + static_cast<size_t>(k) * n_out + cc)
                      : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float xv = repro::to_f32(xr[i][k]);
#pragma unroll
          for (int q = 0; q < kCols; ++q) a[i][q] = fmaf(xv, wv[q], a[i][q]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = r0 + ty + kRowGroups * i;
        if (r >= m_pad) continue;
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          const int cc = tx + kLanes * q;
          if (cc < nbw) us[r * nbw + cc] = a[i][q] + repro::ldf(bch + cc);
        }
      }
    }
    __syncthreads();

    if constexpr (kHybrid) {
      const V* sl = slab + static_cast<size_t>(sc) * d_pad * m_pad;
      for (int i = tid; i < d_pad * nbw; i += kThreads) {
        const int d = i / nbw, cc = i - d * nbw;
        const V* srow = sl + static_cast<size_t>(d) * m_pad;
        float h = 0.f;
        for (int m = 0; m < m_pad; ++m)
          h = fmaf(repro::ldf(srow + m), us[m * nbw + cc], h);
        atomicAdd(acc + i, h);
      }
    }

    const size_t off = static_cast<size_t>(sc) * nnz_pad;
    for (int i = tid / sub; i < n; i += groups) {
      const float v = repro::ldf(val + off + i);
      const int r = repro::ldi(rid + off + i), j = repro::ldi(cid + off + i);
      if (v == 0.f || static_cast<unsigned>(r) >= static_cast<unsigned>(m_pad) ||
          static_cast<unsigned>(j) >= static_cast<unsigned>(m_pad))
        continue;
      const float* urow = us + j * nbw;
      float* arow = acc + r * nbw;
      for (int cc = lane; cc < nbw; cc += sub)
        atomicAdd(arow + cc, v * urow[cc]);
    }
    __syncthreads();  // U_ch is overwritten by the next channel
  }

  for (int i = tid; i < m_pad * nbw; i += kThreads) {
    const int r = i / nbw, cc = i - r * nbw;
    const size_t g = (static_cast<size_t>(s) * m_pad + r) * n_out + col0 + cc;
    float o = acc[i];
    if constexpr (kHybrid) {
      const int q = __ldg(rank + static_cast<size_t>(s) * m_pad + r);
      o = static_cast<unsigned>(q) < static_cast<unsigned>(m_pad)
              ? acc[q * nbw + cc] : 0.f;
    }
    if (res) o += repro::ldf(res + g);
    if (relu) o = fmaxf(o, 0.f);
    y[g] = repro::from_f32<D>(o);
  }
}

template <typename V, typename D, typename I, bool kHybrid>
int launch(const void* rid, const void* cid, const void* val,
           const int* chunks, const void* x, const void* w, const void* bias,
           const void* res, const int* rank, const void* slab, void* y,
           int batch, int channels, int nnz_pad, int chunk, int m_pad,
           int n_in, int n_out, int n_block, int d_pad, int relu,
           void* stream) {
  if (n_block < 1 || n_block > kLanes * kCols) return cudaErrorInvalidValue;
  const size_t smem =
      repro::align16(static_cast<size_t>(m_pad) * n_in * sizeof(D)) +
      2 * static_cast<size_t>(m_pad) * n_block * sizeof(float);
  cudaError_t e = repro::allow_smem(fused_kernel<V, D, I, kHybrid>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(batch, (n_out + n_block - 1) / n_block);
  fused_kernel<V, D, I, kHybrid>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const I*>(rid), static_cast<const I*>(cid),
          static_cast<const V*>(val), chunks, static_cast<const D*>(x),
          static_cast<const D*>(w), static_cast<const D*>(bias),
          static_cast<const D*>(res), rank, static_cast<const V*>(slab),
          static_cast<D*>(y), channels, nnz_pad, chunk, m_pad, n_in, n_out,
          n_block, d_pad, relu, repro::sub_warp(n_block));
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_graph_conv_f32(const int* rid, const int* cid,
                                    const float* val, const int* chunks,
                                    const float* x, const float* w,
                                    const float* bias, const float* res,
                                    float* y, int batch, int channels,
                                    int nnz_pad, int chunk, int m_pad,
                                    int n_in, int n_out, int n_block,
                                    int relu, void* stream) {
  return launch<float, float, int, false>(
      rid, cid, val, chunks, x, w, bias, res, nullptr, nullptr, y, batch,
      channels, nnz_pad, chunk, m_pad, n_in, n_out, n_block, 0, relu,
      stream);
}

// rank (batch, m_pad) and slab (batch, channels, d_pad, m_pad), d_pad >= 1
extern "C" int fused_graph_conv_hybrid_f32(
    const int* rid, const int* cid, const float* val, const int* chunks,
    const float* x, const float* w, const float* bias, const float* res,
    const int* rank, const float* slab, float* y, int batch, int channels,
    int nnz_pad, int chunk, int m_pad, int n_in, int n_out, int n_block,
    int d_pad, int relu, void* stream) {
  if (d_pad < 1 || d_pad > m_pad || rank == nullptr || slab == nullptr)
    return cudaErrorInvalidValue;
  return launch<float, float, int, true>(
      rid, cid, val, chunks, x, w, bias, res, rank, slab, y, batch, channels,
      nnz_pad, chunk, m_pad, n_in, n_out, n_block, d_pad, relu, stream);
}

// ids (batch, channels, nnz_pad) int16; val, x, w, bias, res and y bf16
extern "C" int fused_graph_conv_bf16(const void* rid, const void* cid,
                                     const void* val, const int* chunks,
                                     const void* x, const void* w,
                                     const void* bias, const void* res,
                                     void* y, int batch, int channels,
                                     int nnz_pad, int chunk, int m_pad,
                                     int n_in, int n_out, int n_block,
                                     int relu, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16, short, false>(
      rid, cid, val, chunks, x, w, bias, res, nullptr, nullptr, y, batch,
      channels, nnz_pad, chunk, m_pad, n_in, n_out, n_block, 0, relu,
      stream);
}
