// Shared helpers for the orbslam2_tpu_torch kernels: clamping, se3_exp, the
// DLT triangulation with its unrolled 4x4 Cholesky (kernels S and X), cyclic
// Jacobi eigen-solves and a fixed-order block sum in double (X and Z).
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

// torch.clamp_min: NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float m) {
  return x < m ? m : x;
}

// jnp.maximum / jnp.minimum: a NaN in either operand gives NaN, where
// fmaxf / fminf return the other operand and so drop it. One instruction
// each (PTX max.NaN / min.NaN, sm_80 on); a test-and-select cost kernel D
// 3%.
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// x = A^-1 y for SPD A by ops/linalg_small.solve_spd_small (n = 4)
__device__ inline void solve_spd4(const float A[4][4], const float y[4], float x[4]) {
  float L[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float s = A[j][j];
#pragma unroll
    for (int q = 0; q < j; ++q) s = s - L[j][q] * L[j][q];
    L[j][j] = sqrtf(clamp_min(s, 1e-12f));
    const float inv = 1.0f / L[j][j];
#pragma unroll
    for (int i = j + 1; i < 4; ++i) {
      float t = A[i][j];
#pragma unroll
      for (int q = 0; q < j; ++q) t = t - L[i][q] * L[j][q];
      L[i][j] = t * inv;
    }
  }
  float z[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float s = y[i];
#pragma unroll
    for (int q = 0; q < i; ++q) s = s - L[i][q] * z[q];
    z[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = 3; i >= 0; --i) {
    float s = z[i];
#pragma unroll
    for (int q = i + 1; q < 4; ++q) s = s - L[q][i] * x[q];
    x[i] = s / L[i][i];
  }
}

// ops/geometry.triangulate_dlt for one pair
__device__ inline void dlt(const float* P1, const float* P2, float u1, float v1,
                    float u2, float v2, float X[3]) {
  float A[4][4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    A[0][k] = u1 * P1[8 + k] - P1[k];
    A[1][k] = v1 * P1[8 + k] - P1[4 + k];
    A[2][k] = u2 * P2[8 + k] - P2[k];
    A[3][k] = v2 * P2[8 + k] - P2[4 + k];
  }
  float G[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      G[m][n] = A[0][m] * A[0][n] + A[1][m] * A[1][n] + A[2][m] * A[2][n] +
                A[3][m] * A[3][n];
    }
  }
  float dd[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) dd[m] = 1.0f / sqrtf(clamp_min(G[m][m], 1e-12f));
  float Bm[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int n = 0; n < 4; ++n) Bm[m][n] = G[m][n] * dd[n] * dd[m];
  }
  const float tr = Bm[0][0] + Bm[1][1] + Bm[2][2] + Bm[3][3];
  const float damp = 1e-7f * tr + 1e-12f;
#pragma unroll
  for (int m = 0; m < 4; ++m) Bm[m][m] = Bm[m][m] + damp;
  float Y[4] = {0.0f, 0.0f, 0.0f, 1.0f};
  for (int it = 0; it < 3; ++it) {
    float Z[4];
    solve_spd4(Bm, Y, Z);
    const float nrm = clamp_min(
        sqrtf(Z[0] * Z[0] + Z[1] * Z[1] + Z[2] * Z[2] + Z[3] * Z[3]), 1e-8f);
#pragma unroll
    for (int m = 0; m < 4; ++m) Y[m] = Z[m] / nrm;
  }
  float w = Y[3] * dd[3];
  if (fabsf(w) < 1e-8f) w = w < 0.0f ? -1e-8f : 1e-8f;
#pragma unroll
  for (int m = 0; m < 3; ++m) X[m] = Y[m] * dd[m] / w;
}


constexpr unsigned kFullMask = 0xffffffffu;

// Cyclic Jacobi: a (symmetric) is diagonalized in place, v gets the
// eigenvectors as columns.
template <int n>
__device__ inline void jacobi(double (&a)[n][n], double (&v)[n][n]) {
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) v[i][j] = i == j ? 1.0 : 0.0;
  for (int sweep = 0; sweep < 40; ++sweep) {
    double off = 0.0, diag = 0.0;
    for (int p = 0; p < n; ++p) {
      diag += a[p][p] * a[p][p];
      for (int q = p + 1; q < n; ++q) off += a[p][q] * a[p][q];
    }
    if (!(off > 1e-32 * diag)) break;
    for (int p = 0; p < n - 1; ++p) {
      for (int q = p + 1; q < n; ++q) {
        const double apq = a[p][q];
        if (apq == 0.0) continue;
        const double theta = (a[q][q] - a[p][p]) / (2.0 * apq);
        const double t = (theta >= 0.0 ? 1.0 : -1.0) /
                         (fabs(theta) + sqrt(theta * theta + 1.0));
        const double c = 1.0 / sqrt(t * t + 1.0);
        const double s = t * c;
        for (int k = 0; k < n; ++k) {
          const double akp = a[k][p], akq = a[k][q];
          a[k][p] = c * akp - s * akq;
          a[k][q] = s * akp + c * akq;
        }
        for (int k = 0; k < n; ++k) {
          const double apk = a[p][k], aqk = a[q][k];
          a[p][k] = c * apk - s * aqk;
          a[q][k] = s * apk + c * aqk;
        }
        for (int k = 0; k < n; ++k) {
          const double vkp = v[k][p], vkq = v[k][q];
          v[k][p] = c * vkp - s * vkq;
          v[k][q] = s * vkp + c * vkq;
        }
      }
    }
  }
}

// Sum over the block in a fixed order; every thread gets the sum.
__device__ inline double block_sum(double v, double* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += scratch[w];
  return s;
}

}  // namespace osl
