// Shared helpers for the orbslam2_tpu_torch kernels.
//
// Every entry point has a plain C interface (loaded with ctypes): raw device
// pointers, int sizes, and the caller's cudaStream_t passed as void*. An
// entry point launches on that stream, never synchronises, allocates
// nothing, and returns cudaGetLastError() so the Python wrapper can raise
// on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define OSL_EXPORT extern "C" __attribute__((visibility("default")))

namespace osl {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

}  // namespace osl
