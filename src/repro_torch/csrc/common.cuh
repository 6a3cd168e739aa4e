// Shared by every kernel library of the port: the error-string entry point
// the Python wrappers call when a launch returns a non-zero code, the
// paper's sub-warp width, and the opt-in for more than 48 KB of dynamic
// shared memory (without it such a launch is refused and never runs).
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

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
}

}  // namespace repro
