// Shared helpers for the orbslam2_tpu_torch kernels.
//
// Every entry point has a plain C interface (loaded with ctypes): raw device
// pointers, int sizes, and the caller's cudaStream_t passed as void*. An
// entry point launches on that stream, never synchronises, allocates
// nothing, and returns cudaGetLastError() so the Python wrapper can raise
// on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define OSL_EXPORT extern "C" __attribute__((visibility("default")))

namespace osl {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// se3_exp(xi) @ T into Tn (one thread, row-major 4x4s), as
// geometry.se3_exp computes it.
__device__ inline void se3_exp_left(const float xi[6], const float* T, float* Tn) {
  const float p0 = xi[3], p1 = xi[4], p2 = xi[5];
  const float theta2 = p0 * p0 + p1 * p1 + p2 * p2;
  const float theta = sqrtf(theta2 + 1e-16f);
  const bool small = theta2 < 1e-8f;
  const float a = small ? 1.0f - theta2 / 6.0f : sinf(theta) / theta;
  const float b = small ? 0.5f - theta2 / 24.0f : (1.0f - cosf(theta)) / theta2;
  const float c = small ? 1.0f / 6.0f - theta2 / 120.0f
                        : (theta - sinf(theta)) / (theta2 * theta);
  const float K[3][3] = {{0.0f, -p2, p1}, {p2, 0.0f, -p0}, {-p1, p0, 0.0f}};
  float KK[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      KK[i][j] = K[i][0] * K[0][j] + K[i][1] * K[1][j] + K[i][2] * K[2][j];
    }
  }
  float E[4][4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float t = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float eye = (i == j) ? 1.0f : 0.0f;
      E[i][j] = eye + a * K[i][j] + b * KK[i][j];
      const float V = eye + b * K[i][j] + c * KK[i][j];
      t = (j == 0) ? V * xi[0] : t + V * xi[j];
    }
    E[i][3] = t;
  }
  E[3][0] = E[3][1] = E[3][2] = 0.0f;
  E[3][3] = 1.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      Tn[4 * i + j] = E[i][0] * T[j] + E[i][1] * T[4 + j] +
                      E[i][2] * T[8 + j] + E[i][3] * T[12 + j];
    }
  }
}

}  // namespace osl
