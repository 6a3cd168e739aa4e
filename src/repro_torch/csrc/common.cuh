// Shared by every kernel library of the port: the error-string entry point
// the Python wrappers call when a launch returns a non-zero code, the
// paper's sub-warp width, the opt-in for more than 48 KB of dynamic
// shared memory (without it such a launch is refused and never runs), and
// the g-SpMM pieces of the ELL, COO and CSR kernels: the (op, reduce) codes
// the wrappers pass, the per-edge combine and a shared-memory float max.
#pragma once

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

// *addr = max(*addr, v) for a float in shared memory: a compare-and-swap
// loop on its bits (there is no native float atomic max). It only ever
// replaces a smaller value, so -0.0 and 0.0, being equal, never swap, and
// the result is the exact maximum whatever the order of the calls.
__device__ __forceinline__ void atomic_max_f32(float* addr, float v) {
  int* bits = reinterpret_cast<int*>(addr);
  int old = *reinterpret_cast<volatile int*>(bits);
  while (v > __int_as_float(old)) {
    const int seen = atomicCAS(bits, old, __float_as_int(v));
    if (seen == old) break;
    old = seen;
  }
}

// The empty-row fix-up of every reduce: max writes 0.0 where no edge
// landed, mean divides by max(deg, 1).
__device__ __forceinline__ float finish(float acc, int deg, int reduce) {
  if (reduce == kMax) return deg > 0 ? acc : 0.f;
  if (reduce == kMean) return acc / static_cast<float>(deg > 1 ? deg : 1);
  return acc;
}

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
}

}  // namespace repro
