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
// Its numeric contract is kept: s = q.k^T * hd^-0.5 summed in f32; masked
// scores are the finite -1e30; per kv tile m_new = max(m, rowmax(s)),
// p = exp(s - m_new) set to 0 where masked, corr = exp(m - m_new),
// l = l corr + rowsum(p), acc = acc corr + p.v; out = acc / max(l, 1e-20),
// rounded to q's type once. Key tiles are aligned to multiples of 64 from
// position 0, and a tile that lies wholly above the causal diagonal or
// before the window of every row it meets is skipped: in the recurrence
// above it changes nothing (corr = 1, p = 0). No atomics: the same inputs
// give the same bits.
//
// What bounds it on an H100: at the Llama-3-8B prefill (B 2, T 4096, H 32,
// KV 8, hd 128, bf16, causal) a call must move 168 MB (q, k, v read once,
// out written once: 0.05 ms at 3.35 TB/s) and do 2.75e11 operations on the
// unmasked half (0.28 ms at the 989 TFLOP/s bf16 tensor-core peak):
// operations, and only the tensor cores reach that rate.
//
// bf16 entry (flash_attention_bf16): built for Hopper. One block per
// (128-query tile, head, batch) of 288 threads: two consumer warpgroups,
// each owning 64 query rows, and one producer warp. The producer's first
// lane issues TMA loads through 4-D tensor maps over (hd, heads, tokens,
// batch) with 128-byte swizzle, encoded on the host per call
// (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so
// nothing links against libcuda): the q tile once, then K and V tiles of
// 64 keys into a ring of two stages guarded by full / empty mbarriers.
// Head columns travel in chunks of 64 (128 bytes); columns past hd and
// keys past Tk arrive as TMA's out-of-bounds zeros, so any hd that is a
// multiple of 16 up to 256 runs at the next multiple of 64 with no copy.
// Each consumer warpgroup computes S = Q.K^T with wgmma.mma_async
// m64n64k16 (bf16 A and B from shared memory, f32 accumulators: the
// bf16 x bf16 products are exact in f32, so S differs from the widened f32
// product only in the order of summation), runs the online softmax on the
// accumulator fragment in registers (row max and sum over the 4 lanes of a
// quad, exponentials in base 2 with log2(e) folded into the scale, one
// FFMA and one ex2 per score; the mask is computed only on tiles that the
// diagonal, the window or Tk cuts), converts P in place into wgmma's A-register layout, which for
// 16-bit operands is the accumulator's own, and adds P.V with wgmma (A from
// registers, V from shared memory in its natural (keys, hd) layout through
// the transpose bit). P is split as hi = bf16(p) and lo = bf16(p - hi), and
// P.V runs as hi.V + lo.V (1.5x the operations of S.V alone): p keeps ~16
// bits, and the output stays within one bf16 ulp of the plain version's,
// which keeps p in f32. With P rounded to bf16 alone (built with
// -DREPRO_FLASH_P_LO=0, as scripts/flash_ablation.py builds it), hundreds
// of thousands of outputs of the Llama-3-8B prefill shape fall outside
// that on an H100: rows whose terms nearly cancel move by 2^-9 of a term.
// The epilogue divides by max(l, 1e-20), rounds to bf16 once and stores
// rows below Tq only.
//
// f32 entry (flash_attention_f32): f32 FMAs, because tensor cores would
// take f32 inputs as tf32, which cannot meet the reference's 2e-5. One
// block of 128 threads per (q tile of 64 rows, head, batch). The q tile is
// staged once in shared memory, transposed; then 64-key tiles of K
// (transposed) and V pass through shared memory. Each thread owns 4 rows x
// 8 keys of the score tile (rows ty + 16 i, keys tx + 8 j): the 8 threads
// of a row sit in 8 neighbouring lanes, so a row's max and sum are 3
// xor-shuffles. P goes back through shared memory (transposed, over the K
// tile, which is dead by then) for p.v, where the thread owns the same 4
// rows x hd / 8 columns (tx + 8 j) of the accumulator, which stays in
// registers with the row's m and l. Built for the widths of
// kernels/flash_attention.F32_WIDTHS; the wrapper pads other widths with
// zero columns. Its floor on the f32 FMA pipes (67
// TFLOP/s) is ~4 ms at the Llama-3-8B shape.
#include <cuda.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

// 0 drops the lo half of P, for the ablation only (see above).
#ifndef REPRO_FLASH_P_LO
#define REPRO_FLASH_P_LO 1
#endif

namespace {

constexpr float kMaskScore = -1e30f;  // the reference kernel's NEG_INF

// ---------------------------------------------------------------------------
// f32: FMA design

constexpr int kBQ = 64;               // query rows per block
constexpr int kBK = 64;               // keys per tile
constexpr int kThreads = 128;
constexpr int kTX = 8;                // threads along a row
constexpr int kTY = kThreads / kTX;   // threads along the rows (16)
constexpr int kRows = kBQ / kTY;      // rows per thread (4)
constexpr int kKeys = kBK / kTX;      // keys per thread (8)
constexpr int kPad = kBQ + 1;         // padded row of a transposed tile
static_assert(kBQ == kBK, "qs, ks and ps share the padded row kPad");

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int tq,
             int tk, int h, int kvh, float scale, int causal, int window) {
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
  const float* qb = q + (static_cast<size_t>(b) * tq * h + head) * HD;
  const float* kb = k + (static_cast<size_t>(b) * tk * kvh + kv_head) * HD;
  const float* vb = v + (static_cast<size_t>(b) * tk * kvh + kv_head) * HD;
  float* ob = out + (static_cast<size_t>(b) * tq * h + head) * HD;

  for (int l = tid; l < kBQ * HD; l += kThreads) {
    const int r = l / HD, d = l - r * HD;
    const int t = q0 + r;
    qs[d * kPad + r] = t < tq ? qb[t * q_step + d] : 0.f;
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
        kx = kb[t * kv_step + d];
        vx = vb[t * kv_step + d];
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
      ob[t * q_step + tx + kTX * j] = acc[i][j] / denom;
  }
}

template <int HD>
cudaError_t launch_f32(const float* q, const float* k, const float* v,
                       float* out, int batch, int tq, int tk, int h, int kvh,
                       float scale, int causal, int window,
                       cudaStream_t stream) {
  const size_t smem =
      ((HD + (HD > kBK ? HD : kBK)) * kPad + kBK * HD) * sizeof(float);
  cudaError_t e = repro::allow_smem(flash_kernel<HD>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((tq + kBQ - 1) / kBQ, h, batch);
  flash_kernel<HD><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, tq, tk, h, kvh, scale, causal, window);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA design

namespace wg {

constexpr int kBQ = 128;              // query rows per block
constexpr int kBK = 64;               // keys per K / V tile
constexpr int kStages = 2;            // K / V ring
constexpr int kChunk = 64;            // head columns per 128-byte chunk
constexpr int kConsumers = 256;       // two warpgroups of 64 rows each
constexpr int kThreads = kConsumers + 32;   // and one producer warp

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle
// repeats every 8 rows of 128 bytes): the q tile, then the stages' K and V
// tiles, each as hd / 64 chunks of (rows x 128 bytes), then the mbarriers.
template <int HDP>
struct Layout {
  static constexpr int kChunks = HDP / kChunk;
  static constexpr int kQBytes = kChunks * kBQ * 128;
  static constexpr int kTileBytes = kChunks * kBK * 128;   // K or V
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the phase of ``bar`` with this parity has completed.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One TMA box (64 head columns x rows tokens) at (col, head, token, batch).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int token, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(token), "r"(batch) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte swizzled tile: start
// address, leading and stride byte offsets (in 16-byte units) and the
// layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving accesses of accumulator registers across
// the asynchronous wgmma that reads and writes them.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define REPRO_D8(i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define REPRO_D32 REPRO_D8(0), REPRO_D8(8), REPRO_D8(16), REPRO_D8(24)
#define REPRO_R32                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31}"

// d (64 x 64 f32) (+)= A (64 x 16, K-major in shared memory) .
// B (16 x 64, K-major in shared memory); accumulate unless acc is 0.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a,
                                       uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : REPRO_D32
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 64 f32) += A (64 x 16 bf16 in registers) . B (16 x 64, stored
// MN-major (N contiguous) in shared memory: the transpose bit).
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : REPRO_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef REPRO_D8
#undef REPRO_D32
#undef REPRO_R32

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float ex2(float x) {   // 2^x, subnormals to 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The wgmma accumulator fragment of a 64 x 64 tile (m64n64, f32): thread t
// of the warpgroup holds d[4 j + e] at row 16 (t / 32) + (t % 32) / 4 + 8
// (e / 2) and column 8 j + 2 (t % 4) + e % 2, j in 0..7, so a row's 64
// scores lie in the 4 lanes of a quad.
//
// Keys past Tk, past the diagonal or before the window of a tile that one
// of them cuts: their raw score becomes -inf, so that softmax_tile gives
// them p = 2^-inf = 0 and leaves a row with no live key at the reference's
// masked score -1e30.
__device__ __forceinline__ void mask_tile(float (&sc)[32], int row, int k0,
                                          int col, int tk, int causal,
                                          int window) {
  const float neg_inf = __int_as_float(0xff800000);
#pragma unroll
  for (int idx = 0; idx < 32; ++idx) {
    const int qpos = row + 8 * ((idx / 2) % 2);
    const int kpos = k0 + 8 * (idx / 4) + col + idx % 2;
    bool ok = kpos < tk;
    if (causal) ok = ok && kpos <= qpos;
    if (window) ok = ok && kpos > qpos - window;
    sc[idx] = ok ? sc[idx] : neg_inf;
  }
}

// One tile of the online softmax on the fragment: raw scores s in, p out;
// m in base 2 (m = max(s) hd^-0.5 log2(e)), p = 2^(s scale2 - m_new) in one
// FFMA and one ex2, corr = 2^(m - m_new), l = l corr + rowsum(p).
__device__ __forceinline__ void softmax_tile(float (&sc)[32],
                                             float (&m_run)[2],
                                             float (&l_run)[2],
                                             float (&corr)[2], float scale2) {
  const float neg_inf = __int_as_float(0xff800000);
  float mx[2] = {neg_inf, neg_inf};   // raw row maxima
#pragma unroll
  for (int idx = 0; idx < 32; ++idx)
    mx[(idx / 2) % 2] = fmaxf(mx[(idx / 2) % 2], sc[idx]);
  float sum[2] = {0.f, 0.f}, neg_m[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
    // a row with every key masked so far keeps the masked score
    const float m_new = fmaxf(m_run[hf], fmaxf(mx[hf] * scale2, kMaskScore));
    corr[hf] = ex2(m_run[hf] - m_new);
    m_run[hf] = m_new;
    neg_m[hf] = -m_new;
  }
#pragma unroll
  for (int idx = 0; idx < 32; ++idx) {
    const float p = ex2(fmaf(sc[idx], scale2, neg_m[(idx / 2) % 2]));
    sum[(idx / 2) % 2] += p;
    sc[idx] = p;
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    sum[hf] += __shfl_xor_sync(0xffffffffu, sum[hf], 1);
    sum[hf] += __shfl_xor_sync(0xffffffffu, sum[hf], 2);
    l_run[hf] = l_run[hf] * corr[hf] + sum[hf];
  }
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   __nv_bfloat16* __restrict__ out, int tq, int tk, int h,
                   int kvh, int hd, float scale, int causal, int window) {
  using L = Layout<HDP>;
  constexpr int kChunks = L::kChunks;
  extern __shared__ unsigned char flash_smem[];
  const uint32_t base = (smem_addr(flash_smem) + 1023) & ~1023u;
  const uint32_t sq = base;
  const uint32_t q_full = base + L::kBar;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * kStages;

  // heaviest causal tiles first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int head = blockIdx.y, b = blockIdx.z;
  const int kv_head = head / (h / kvh);
  const int k_end = causal ? min(tk, q0 + kBQ) : tk;
  const int k_begin = window ? max(0, q0 - window + 1) / kBK * kBK : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(full0 + 8 * s, 1);
      bar_init(empty0 + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {   // the producer warp: one lane issues TMA
    if (tid == kConsumers) {
      bar_expect_tx(q_full, L::kQBytes);
      for (int c = 0; c < kChunks; ++c)
        tma_load(sq + c * kBQ * 128, &qmap, q_full, c * kChunk, head, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const int k0 = k_begin + i * kBK;
        bar_wait(empty0 + 8 * s, ((i / kStages) & 1) ^ 1);
        bar_expect_tx(full0 + 8 * s, 2 * L::kTileBytes);
        const uint32_t sk = base + L::kK + s * L::kTileBytes;
        const uint32_t sv = base + L::kV + s * L::kTileBytes;
        for (int c = 0; c < kChunks; ++c) {
          tma_load(sk + c * kBK * 128, &kmap, full0 + 8 * s, c * kChunk,
                   kv_head, k0, b);
          tma_load(sv + c * kBK * 128, &vmap, full0 + 8 * s, c * kChunk,
                   kv_head, k0, b);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows r_lo .. r_lo + 63 of the q tile
  const int wgi = tid / 128, t = tid % 128, lane = t % 32;
  const int r_lo = q0 + 64 * wgi;
  const int row = r_lo + 16 * (t / 32) + lane / 4;   // and row + 8
  const int col = 2 * (lane % 4);                    // within 8 columns
  float o[kChunks][32];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m_run[2] = {kMaskScore, kMaskScore}, l_run[2] = {0.f, 0.f};
  // scores in base 2: exp(s - m) = exp2(s log2(e) - m log2(e))
  const float scale2 = scale * 1.44269504088896341f;

  bar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const int k0 = k_begin + i * kBK;
    bar_wait(full0 + 8 * s, (i / kStages) & 1);
    const bool dead = (causal && k0 > r_lo + 63) ||
                      (window && k0 + kBK - 1 <= r_lo - window);
    if (!dead) {
      const uint32_t sk = base + L::kK + s * L::kTileBytes;
      const uint32_t sv = base + L::kV + s * L::kTileBytes;
      // S = Q . K^T over hd in steps of 16 columns (32 bytes of a chunk)
      float sc[32];
#pragma unroll
      for (int idx = 0; idx < 32; ++idx) sc[idx] = 0.f;
      mma_fence();
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        const uint32_t qa = sq + (kk / 4) * (kBQ * 128) + wgi * (64 * 128) +
                            (kk % 4) * 32;
        const uint32_t kb = sk + (kk / 4) * (kBK * 128) + (kk % 4) * 32;
        mma_ss(sc, desc(qa, 16, 1024), desc(kb, 16, 1024), kk);
      }
      mma_commit();
      mma_wait();
      pin(sc);

      // the online softmax on the fragment; the mask only where the tile
      // is cut by the diagonal, the window or Tk
      const bool whole = k0 + kBK <= tk &&
                         (!causal || k0 + kBK - 1 <= r_lo) &&
                         (!window || k0 > r_lo + 63 - window);
      if (!whole) mask_tile(sc, row, k0, col, tk, causal, window);
      float corr[2];
      softmax_tile(sc, m_run, l_run, corr, scale2);
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int idx = 0; idx < 32; ++idx) o[c][idx] *= corr[(idx / 2) % 2];

      // P as wgmma A fragments (keys 16 kk .. 16 kk + 15): the 16-bit A
      // layout is the accumulator's, so register pair (8 kk + 2 r, + 1) is
      // A register r. hi = bf16(p), lo = bf16(p - hi).
      uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x0 = sc[8 * kk + 2 * r], x1 = sc[8 * kk + 2 * r + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
          const float2 back = __bfloat1622float2(hi);
          p_hi[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
          p_lo[kk][r] = pack_bf16(x0 - back.x, x1 - back.y);
        }

      // O += P . V, per 64-column chunk of V, in steps of 16 keys
#pragma unroll
      for (int c = 0; c < kChunks; ++c) pin(o[c]);
      mma_fence();
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t vb = desc(sv + c * (kBK * 128) + kk * 2048,
                                   kBK * 128, 1024);
          mma_rs(o[c], p_hi[kk], vb);
#if REPRO_FLASH_P_LO
          mma_rs(o[c], p_lo[kk], vb);
#endif
        }
      mma_commit();
      mma_wait();
#pragma unroll
      for (int c = 0; c < kChunks; ++c) pin(o[c]);
    }
    bar_arrive(empty0 + 8 * s);
  }

  // epilogue: acc / max(l, 1e-20), rounded to bf16 once, rows below Tq
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int t_row = row + 8 * hf;
    if (t_row >= tq) continue;
    const float denom = fmaxf(l_run[hf], 1e-20f);
    __nv_bfloat16* dst =
        out + ((static_cast<size_t>(b) * tq + t_row) * h + head) * hd;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cc = c * kChunk + 8 * j + col;
        if (cc >= hd) continue;
        const int idx = 4 * j + 2 * hf;
        *reinterpret_cast<uint32_t*>(dst + cc) =
            pack_bf16(o[c][idx] / denom, o[c][idx + 1] / denom);
      }
  }
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a (batch, tokens, heads, hd) bf16 tensor, boxes of 64
// head columns x ``rows`` tokens, 128-byte swizzle, zeros out of bounds.
bool tensor_map(CUtensorMap* map, const void* ptr, int hd, int heads,
                int tokens, int batch, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(tokens),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {row, row * heads, row * heads * tokens};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kChunk), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HDP>
cudaError_t launch(const CUtensorMap& qm, const CUtensorMap& km,
                   const CUtensorMap& vm, __nv_bfloat16* out, int batch,
                   int tq, int tk, int h, int kvh, int hd, float scale,
                   int causal, int window, cudaStream_t stream) {
  constexpr int smem = Layout<HDP>::kBytes;
  cudaError_t e = repro::allow_smem(flash_wgmma_kernel<HDP>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((tq + kBQ - 1) / kBQ, h, batch);
  flash_wgmma_kernel<HDP><<<grid, kThreads, smem, stream>>>(
      qm, km, vm, out, tq, tk, h, kvh, hd, scale, causal, window);
  return cudaGetLastError();
}

}  // namespace wg

bool bad_shape(int batch, int tq, int tk, int h, int kvh, int window) {
  return batch < 1 || tq < 1 || tk < 0 || h < 1 || kvh < 1 || h % kvh != 0 ||
         batch > 65535 || h > 65535 || window < 0;
}

}  // namespace

// hd one of 16, 32, 64, 96, 128, 160, 192, 256 (kernels/flash_attention.py
// F32_WIDTHS; the wrapper pads the others)
extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* out, int batch,
                                   int tq, int tk, int h, int kvh, int hd,
                                   float scale, int causal, int window,
                                   void* stream_ptr) {
  if (bad_shape(batch, tq, tk, h, kvh, window)) return cudaErrorInvalidValue;
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  switch (hd) {
#define REPRO_CASE(HD)                                                       \
  case HD:                                                                   \
    return launch_f32<HD>(q, k, v, out, batch, tq, tk, h, kvh, scale, causal, \
                          window, stream);
    REPRO_CASE(16)
    REPRO_CASE(32)
    REPRO_CASE(64)
    REPRO_CASE(96)
    REPRO_CASE(128)
    REPRO_CASE(160)
    REPRO_CASE(192)
    REPRO_CASE(256)
#undef REPRO_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// hd a multiple of 16 up to 256; q, k, v 16-byte aligned
extern "C" int flash_attention_bf16(const __nv_bfloat16* q,
                                    const __nv_bfloat16* k,
                                    const __nv_bfloat16* v,
                                    __nv_bfloat16* out, int batch, int tq,
                                    int tk, int h, int kvh, int hd,
                                    float scale, int causal, int window,
                                    void* stream_ptr) {
  if (bad_shape(batch, tq, tk, h, kvh, window) || hd < 16 || hd > 256 ||
      hd % 16 != 0 || tk < 1)
    return cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  if (!wg::tensor_map(&qm, q, hd, h, tq, batch, wg::kBQ) ||
      !wg::tensor_map(&km, k, hd, kvh, tk, batch, wg::kBK) ||
      !wg::tensor_map(&vm, v, hd, kvh, tk, batch, wg::kBK))
    return cudaErrorNotSupported;
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  switch ((hd + wg::kChunk - 1) / wg::kChunk * wg::kChunk) {
#define REPRO_CASE(HDP)                                                    \
  case HDP:                                                                \
    return wg::launch<HDP>(qm, km, vm, out, batch, tq, tk, h, kvh, hd,     \
                           scale, causal, window, stream);
    REPRO_CASE(64)
    REPRO_CASE(128)
    REPRO_CASE(192)
    REPRO_CASE(256)
#undef REPRO_CASE
    default:
      return cudaErrorInvalidValue;
  }
}
