// Flash attention, forward: out[b, t, h] = softmax_k(q[b, t, h] . k[b, k, h / g]
// * hd^-0.5, masked) . v[b, k, h / g], with g = H / KV query heads per KV
// head (GQA by index, K and V never repeated in memory), an optional causal
// mask (key position <= query position) and an optional sliding window
// (key position > query position - window). Positions count from 0 for
// both q and k. q is (B, Tq, H, hd), k and v (B, Tk, KV, hd), in f32 or
// bf16; out has q's shape and type.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _kernel, the attention_impl="pallas" branch of
// models/layers.attention_apply, which lm.forward and lm.prefill reach).
// Its numeric contract is kept: q, k and v are widened to f32;
// s = q.k^T * hd^-0.5; masked scores are the finite -1e30; per kv tile
// m_new = max(m, rowmax(s)), p = exp(s - m_new) set to 0 where masked and
// kept in f32 into p.v, corr = exp(m - m_new), l = l corr + rowsum(p),
// acc = acc corr + p.v; out = acc / max(l, 1e-20), rounded to q's type.
//
// What bounds it on an H100: at the Llama-3-8B prefill (B 2, T 4096, H 32,
// KV 8, hd 128, bf16, causal) a call must move 168 MB (q, k, v read once,
// out written once: 0.05 ms at 3.35 TB/s) and do 2.75e11 operations on
// the unmasked half (0.28 ms at the 989 TFLOP/s bf16 tensor-core peak):
// operations. This kernel runs on the f32 FMA pipes (67 TFLOP/s), so its
// own floor is ~4 ms; wgmma on bf16 tiles, TMA and a producer warp are
// later work.
//
// Design: one block of 128 threads per (q tile of 64 rows, head, batch). The
// q tile is staged once in shared memory, transposed and widened to f32; then
// 64-key tiles of K (transposed) and V pass through shared memory, widened on
// load. Each thread owns 4 rows x 8 keys of the score tile (rows ty + 16 i,
// keys tx + 8 j): the 8 threads of a row sit in 8 neighbouring lanes, so a
// row's max and sum are 3 xor-shuffles. P goes back through shared memory
// (transposed, over the K tile, which is dead by then: 97 KB a block at hd
// 128, two blocks an SM) for p.v, where the thread owns the same 4 rows x hd
// / 8 columns (tx + 8 j) of the accumulator, which stays in registers with
// the row's m and l. Key tiles are aligned to multiples of 64 from position
// 0, and a tile that lies wholly above the causal diagonal or before the
// window of every row of the block is skipped: in the recurrence above it
// changes nothing (corr = 1, p = 0). Keys past Tk load as 0.0 (and are
// masked), so padding never meets a NaN. No atomics: the same inputs give the
// same bits.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;               // query rows per block
constexpr int kBK = 64;               // keys per tile
constexpr int kThreads = 128;
constexpr int kTX = 8;                // threads along a row
constexpr int kTY = kThreads / kTX;   // threads along the rows (16)
constexpr int kRows = kBQ / kTY;      // rows per thread (4)
constexpr int kKeys = kBK / kTX;      // keys per thread (8)
constexpr int kPad = kBQ + 1;         // padded row of a transposed tile
static_assert(kBQ == kBK, "qs, ks and ps share the padded row kPad");
constexpr float kMaskScore = -1e30f;  // the reference kernel's NEG_INF

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int tq, int tk,
             int h, int kvh, float scale, int causal, int window) {
  constexpr int kCols = HD / kTX;     // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                   // [HD][kPad]: q tile, transposed
  float* ks = qs + HD * kPad;         // [HD][kPad]: k tile, transposed
  float* ps = ks;                     // [kBK][kPad]: p tile, transposed,
                                      // once the scores are taken
  float* vs = ks + (HD > kBK ? HD : kBK) * kPad;   // [kBK][HD]: v tile

  const int q0 = blockIdx.x * kBQ;
  const int head = blockIdx.y, b = blockIdx.z;
  const int kv_head = head / (h / kvh);
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const size_t q_step = static_cast<size_t>(h) * HD;     // between rows
  const size_t kv_step = static_cast<size_t>(kvh) * HD;
  const T* qb = q + (static_cast<size_t>(b) * tq * h + head) * HD;
  const T* kb = k + (static_cast<size_t>(b) * tk * kvh + kv_head) * HD;
  const T* vb = v + (static_cast<size_t>(b) * tk * kvh + kv_head) * HD;
  T* ob = out + (static_cast<size_t>(b) * tq * h + head) * HD;

  for (int l = tid; l < kBQ * HD; l += kThreads) {
    const int r = l / HD, d = l - r * HD;
    const int t = q0 + r;
    qs[d * kPad + r] = t < tq ? widen(qb[t * q_step + d]) : 0.f;
  }

  float acc[kRows][kCols], m_run[kRows], l_run[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m_run[i] = kMaskScore;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  // the key tiles that hold a key some row of the block may attend
  int k_end = tk;
  if (causal) k_end = min(tk, q0 + kBQ);
  int k_begin = 0;
  if (window) k_begin = max(0, q0 - window + 1) / kBK * kBK;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();   // q staged; the last tile's ks, vs, ps reads done
    for (int l = tid; l < kBK * HD; l += kThreads) {
      const int c = l / HD, d = l - c * HD;
      const int t = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (t < tk) {
        kx = widen(kb[t * kv_step + d]);
        vx = widen(vb[t * kv_step + d]);
      }
      ks[d * kPad + c] = kx;
      vs[c * HD + d] = vx;
    }
    __syncthreads();

    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[kRows], bk[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = qs[d * kPad + ty + kTY * i];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) bk[j] = ks[d * kPad + tx + kTX * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }
    __syncthreads();   // every read of ks done: ps overwrites it

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty + kTY * i;
      unsigned live = 0;   // bit j: key tx + 8 j is attended
      float mx = kMaskScore;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int kpos = k0 + tx + kTX * j;
        bool ok = kpos < tk;
        if (causal) ok = ok && kpos <= qpos;
        if (window) ok = ok && kpos > qpos - window;
        s[i][j] = ok ? s[i][j] * scale : kMaskScore;
        if (ok) live |= 1u << j;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < kTX; off *= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = (live >> j) & 1u ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        ps[(tx + kTX * j) * kPad + ty + kTY * i] = p;
      }
#pragma unroll
      for (int off = 1; off < kTX; off *= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * corr + sum;
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pr[kRows], vx[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pr[i] = ps[c * kPad + ty + kTY * i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) vx[j] = vs[c * HD + tx + kTX * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(pr[i], vx[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = q0 + ty + kTY * i;
    if (t >= tq) continue;
    const float denom = fmaxf(l_run[i], 1e-20f);
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      put(ob + t * q_step + tx + kTX * j, acc[i][j] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const T* q, const T* k, const T* v, T* out, int batch,
                   int tq, int tk, int h, int kvh, float scale, int causal,
                   int window, cudaStream_t stream) {
  const size_t smem =
      ((HD + (HD > kBK ? HD : kBK)) * kPad + kBK * HD) * sizeof(float);
  cudaError_t e = repro::allow_smem(flash_kernel<T, HD>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((tq + kBQ - 1) / kBQ, h, batch);
  flash_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, tq, tk, h, kvh, scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const T* q, const T* k, const T* v, T* out, int batch, int tq,
             int tk, int h, int kvh, int hd, float scale, int causal,
             int window, void* stream_ptr) {
  if (batch < 1 || tq < 1 || h < 1 || kvh < 1 || h % kvh != 0 ||
      batch > 65535 || h > 65535 || window < 0)
    return cudaErrorInvalidValue;
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, out, batch, tq, tk, h, kvh, scale,
                           causal, window, stream);
    case 32:
      return launch<T, 32>(q, k, v, out, batch, tq, tk, h, kvh, scale,
                           causal, window, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, batch, tq, tk, h, kvh, scale,
                           causal, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, batch, tq, tk, h, kvh, scale,
                            causal, window, stream);
    case 160:
      return launch<T, 160>(q, k, v, out, batch, tq, tk, h, kvh, scale,
                            causal, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* out, int batch,
                                   int tq, int tk, int h, int kvh, int hd,
                                   float scale, int causal, int window,
                                   void* stream) {
  return dispatch(q, k, v, out, batch, tq, tk, h, kvh, hd, scale, causal,
                  window, stream);
}

extern "C" int flash_attention_bf16(const __nv_bfloat16* q,
                                    const __nv_bfloat16* k,
                                    const __nv_bfloat16* v,
                                    __nv_bfloat16* out, int batch, int tq,
                                    int tk, int h, int kvh, int hd,
                                    float scale, int causal, int window,
                                    void* stream) {
  return dispatch(q, k, v, out, batch, tq, tk, h, kvh, hd, scale, causal,
                  window, stream);
}
