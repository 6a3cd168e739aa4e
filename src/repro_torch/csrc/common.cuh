// Shared by every kernel library of the port: the error-string entry point
// the Python wrappers call when a launch returns a non-zero code, the
// paper's sub-warp width, the opt-in for more than 48 KB of dynamic
// shared memory (without it such a launch is refused and never runs), the
// g-SpMM pieces of the ELL, COO and CSR kernels (the (op, reduce) codes the
// wrappers pass, the per-edge combine and the empty-row fix-up), and the
// element types of the reduced-precision entries: loads that widen f32,
// bf16 and int8 to f32 and int32 or int16 ids to int, and the one rounding
// of an f32 sum to the output type, and the panel and grid sizes of the
// kernels that read B through the L2 and their loads and stores of a
// lane's four neighbouring columns (in device and in shared memory).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace repro {

constexpr int kWarp = 32;

// Lanes per row or per non-zero (paper §IV-C): next_pow2(n_B) capped at one
// warp, so a narrow panel does not leave most lanes of a warp idle.
inline int sub_warp(int n_block) {
  int sw = 1;
  while (sw < n_block && sw < kWarp) sw *= 2;
  return sw;
}

// g-SpMM codes, in the order of kernels/ops.GSPMM_OPS / GSPMM_REDUCES.
enum GspmmOp { kOpMul = 0, kOpAdd = 1, kOpCopyLhs = 2 };
enum GspmmReduce { kSum = 0, kMax = 1, kMean = 2 };

// The reference's finite stand-in for -inf in max accumulators.
constexpr float kNegInf = -3.0e38f;

// op(u, e): u the gathered B element, e the edge value (ignored by
// copy_lhs). A lone multiply or add, rounded as PyTorch rounds it, so a
// max over these messages equals the plain version's bit for bit.
__device__ __forceinline__ float combine(float u, float e, int op) {
  if (op == kOpMul) return u * e;
  if (op == kOpAdd) return u + e;
  return u;
}

// The empty-row fix-up of every reduce: max writes 0.0 where no edge
// landed, mean divides by max(deg, 1).
__device__ __forceinline__ float finish(float acc, int deg, int reduce) {
  if (reduce == kMax) return deg > 0 ? acc : 0.f;
  if (reduce == kMean) return acc / static_cast<float>(deg > 1 ? deg : 1);
  return acc;
}

// a / d for an integer d >= 1, correctly rounded where the quotient is a
// normal float, as PyTorch divides (Markstein's correction of a * RN(1/d)),
// without the slow-path call of the IEEE division, which, inlined at every
// row store of the COO and CSR kernels' walks, made their mean corners
// several times slower than the sum
__device__ __forceinline__ float div_count(float a, int d) {
  const float fd = static_cast<float>(d), r = __frcp_rn(fd);
  const float q = a * r;
  return fmaf(fmaf(-q, fd, a), r, q);
}

// Element types: value and dense operands are float, __nv_bfloat16 or (int8
// value codes) signed char; ids are int or (narrowed) short. to_f32 widens
// an element already read (from shared memory), ldf / ldi read one through
// the read-only cache and widen it.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(signed char v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float ldf(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ float ldf(const signed char* p) {
  return static_cast<float>(__ldg(p));
}
__device__ __forceinline__ int ldi(const int* p) { return __ldg(p); }
__device__ __forceinline__ int ldi(const short* p) { return __ldg(p); }

// The one rounding of an f32 sum to the output type (round to nearest
// even, as PyTorch's .to(torch.bfloat16)).
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Where the next array starts in dynamic shared memory after one of
// ``bytes``, at 16-byte alignment: align16 in bytes (the launch's size),
// words16 in 4-byte words (an offset from a float-typed base).
__host__ __device__ constexpr size_t align16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}
__device__ __forceinline__ int words16(size_t bytes) {
  return static_cast<int>(align16(bytes) / 4);
}

// Elements of type T in an array of n that a 4-byte (float or int) array
// may follow in dynamic shared memory: n itself for 4-byte types, n
// rounded up to an even count for bf16.
template <typename T>
__host__ __device__ constexpr int pad4(int n) {
  constexpr int k = sizeof(T) >= 4 ? 1 : 4 / static_cast<int>(sizeof(T));
  return (n + k - 1) / k * k;
}

// Large-matrix entries (paper case 3, matrices whose panel does not fit a
// block's shared memory): column panels of at most kPanelMax columns, and
// grid.y blocks of ``per_block`` rows (or slots) each, at most 65535 of
// them; a kernel strides over whatever lies past that.
constexpr int kPanelMax = 128;
inline int large_blocks(long long items, int per_block) {
  const long long n = (items + per_block - 1) / per_block;
  return static_cast<int>(n < 1 ? 1 : (n > 65535 ? 65535 : n));
}

// Columns a lane of the kernels that read B through the L2 holds (hybrid,
// ELL, COO, CSR): four neighbours, one 16-byte f32 or 8-byte bf16 access;
// 32 lanes x 4 cover a panel of kPanelMax columns.
constexpr int kW = 4;

// The kW columns of a row of B at p (through the read-only cache), widened
// to f32 into x: one 16-byte (f32) or 8-byte (bf16) load where `vec`
// (aligned and whole), else one at a time for the n of them in the panel,
// the rest 0. (bf16: 64 bits widened by shifts, not the __nv_bfloat162
// __ldg: that one is inline asm the compiler may hoist out of the `vec`
// branch, where the address is not aligned.)
__device__ __forceinline__ void load_cols(const float* p, bool vec, int n,
                                          float* x) {
  if (vec) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < kW; ++i) x[i] = i < n ? __ldg(p + i) : 0.f;
}
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p, bool vec,
                                          int n, float* x) {
  if (vec) {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
    x[0] = __uint_as_float(w.x << 16), x[1] = __uint_as_float(w.x & ~0xffffu);
    x[2] = __uint_as_float(w.y << 16), x[3] = __uint_as_float(w.y & ~0xffffu);
    return;
  }
  const auto* u = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
  for (int i = 0; i < kW; ++i)
    x[i] = i < n ? __uint_as_float(static_cast<unsigned>(__ldg(u + i)) << 16)
                 : 0.f;
}

// A value or slab element widened to f32 through the read-only cache (bf16:
// a 16-bit load shifted into place, not the inline-asm bf16 __ldg, so that
// the compiler schedules it as freely as the f32 one; int8: a code)
__device__ __forceinline__ float ldv(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldv(const __nv_bfloat16* p) {
  return __uint_as_float(
      static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p)))
      << 16);
}
__device__ __forceinline__ float ldv(const signed char* p) {
  return static_cast<float>(__ldg(p));
}

// x (kW sums) to the n columns of C at p, each rounded once to C's type
__device__ __forceinline__ void store_cols(float* p, const float* x,
                                           bool vec, int n) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < kW; ++i)
    if (i < n) p[i] = x[i];
}
__device__ __forceinline__ void store_cols(__nv_bfloat16* p, const float* x,
                                           bool vec, int n) {
  if (vec) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
    *reinterpret_cast<uint2*>(p) =
        make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                   *reinterpret_cast<const unsigned*>(&hi));
    return;
  }
#pragma unroll
  for (int i = 0; i < kW; ++i)
    if (i < n) p[i] = __float2bfloat16_rn(x[i]);
}

// Four floats of shared memory (16-byte aligned) into a, and back.
__device__ __forceinline__ void ld4(float (&a)[kW], const float* p) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  a[0] = t.x, a[1] = t.y, a[2] = t.z, a[3] = t.w;
}
__device__ __forceinline__ void st4(float* p, const float (&a)[kW]) {
  *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
}

// Exclusive prefix sum of the n ints at a (shared memory), by the block:
// each thread sums a contiguous share, the warps scan the shares with
// shuffles, and each warp adds the totals of the warps before it (ws: one
// int per warp). The share is odd, so that a warp's 32 threads, a share
// apart, read 32 different banks. Barriers before and after are the
// caller's. kThreads is the block's size.
template <int kThreads>
__device__ __forceinline__ void exclusive_scan(int* a, int n, int* ws) {
  const int share = (n + kThreads - 1) / kThreads | 1;
  const int lo = min(n, static_cast<int>(threadIdx.x) * share);
  const int hi = min(n, lo + share);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += a[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += t;
  }
  if (lane == 31) ws[warp] = inc;
  __syncthreads();
  int off = inc - sum;
  for (int w = 0; w < warp; ++w) off += ws[w];
  for (int i = lo; i < hi; ++i) {
    const int t = a[i];
    a[i] = off;
    off += t;
  }
}

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
}

}  // namespace repro
