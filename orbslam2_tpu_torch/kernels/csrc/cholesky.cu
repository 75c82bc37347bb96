// Kernel F': a multi-block Cholesky factorization and solve of a dense SPD
// system (K9', the global-BA size, and kernel P's essential graph), and the
// bundle-adjustment solve built on it for 6K > 384.
//
// Replaces orbslam2_tpu/ops/ba.py: _schur_solve (jnp.linalg.cholesky +
// cho_solve) at the global-BA sizes of orbslam2_tpu/loop_closing.py:594
// (6K up to 1536), and the dense solve of orbslam2_tpu/ops/pose_graph.py:345
// (7K up to 2688).
//
// The factorization A = L L^T runs right-looking in 32-column panels, three
// launches a panel on the caller's stream:
//   cholesky_diag_kernel    one warp factorises the 32 x 32 diagonal block
//                           in shared memory (a pivot that is not > 0 sets
//                           the failure flag);
//   cholesky_panel_kernel   a warp per row below it: L[i, J:J+32] =
//                           A[i, J:J+32] L_JJ^-T, the substitution carried by
//                           shuffles;
//   cholesky_update_kernel  a block per 32 x 32 tile of the trailing lower
//                           triangle: A[i][j] -= L[i, J:J+32] . L[j, J:J+32],
//                           both panels' rows staged in shared memory.
// Then cholesky_solve_kernel (one block) solves L y = b and L^T x = y panel by
// panel, right-looking, the vector in shared memory. Every sum runs in a
// fixed order, so the result is the same from run to run. A system of n
// unknowns takes 3 ceil(n / 32) + 1 launches (one fewer for the last panel).
//
// osl_ba_solve_blocked is kernel F's contract at any K: fixed cameras as
// identity rows, each camera block damped by lam times its mean diagonal,
// the system made symmetric (cholesky_ba_damp_kernel), the factorization
// and solve, then cholesky_ba_step_kernel: dc = -x (NaN for the optimised
// cameras if a pivot failed, 0 for fixed ones) and se3_exp(dc) @ T per
// camera.
#include "common.cuh"

namespace {

constexpr int kP = 32;               // panel width
constexpr int kRowsPerBlock = 8;     // warps per panel block
constexpr int kSolveThreads = 1024;

__global__ void cholesky_diag_kernel(float* __restrict__ A, int n, int J, int w,
                                     int* __restrict__ failed) {
  __shared__ float sD[kP][kP + 1];
  const int lane = threadIdx.x;
  for (int r = 0; r < w; ++r) {
    if (lane <= r) sD[r][lane] = A[static_cast<size_t>(J + r) * n + J + lane];
  }
  __syncwarp();
  for (int j = 0; j < w; ++j) {
    const float djj = sD[j][j];
    const float ljj = sqrtf(djj);
    __syncwarp();
    if (lane == 0) {
      if (!(djj > 0.0f)) *failed = 1;
      sD[j][j] = ljj;
    }
    if (lane > j && lane < w) sD[lane][j] /= ljj;
    __syncwarp();
    if (lane > j && lane < w) {
      const float lij = sD[lane][j];
      for (int k = j + 1; k <= lane; ++k) sD[lane][k] -= lij * sD[k][j];
    }
    __syncwarp();
  }
  for (int r = 0; r < w; ++r) {
    if (lane <= r) A[static_cast<size_t>(J + r) * n + J + lane] = sD[r][lane];
  }
}

__global__ void __launch_bounds__(32 * kRowsPerBlock)
cholesky_panel_kernel(float* __restrict__ A, int n, int J, int w) {
  __shared__ float sD[kP][kP + 1];
  for (int t = threadIdx.x; t < w * kP; t += blockDim.x) {
    const int r = t / kP, c = t % kP;
    if (c <= r) sD[r][c] = A[static_cast<size_t>(J + r) * n + J + c];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int i = J + w + blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (i >= n) return;
  float* row = A + static_cast<size_t>(i) * n + J;
  float v = lane < w ? row[lane] : 0.0f;
  for (int c = 0; c < w; ++c) {
    const float vc = __shfl_sync(0xffffffffu, v, c) / sD[c][c];
    if (lane == c) v = vc;
    if (lane > c && lane < w) v -= vc * sD[lane][c];
  }
  if (lane < w) row[lane] = v;
}

__global__ void __launch_bounds__(kP * 8)
cholesky_update_kernel(float* __restrict__ A, int n, int J, int w) {
  __shared__ float Li[kP][kP + 1], Lj[kP][kP + 1];
  // tile b of the lower triangle: tile row ti, tile column tj <= ti
  const int b = blockIdx.x;
  int ti = static_cast<int>((sqrtf(8.0f * b + 1.0f) - 1.0f) * 0.5f);
  while ((ti + 1) * (ti + 2) / 2 <= b) ++ti;
  while (ti * (ti + 1) / 2 > b) --ti;
  const int tj = b - ti * (ti + 1) / 2;
  const int T0 = J + w;
  const int r0 = T0 + kP * ti, c0 = T0 + kP * tj;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int r = ty; r < kP; r += 8) {
    const int gi = r0 + r, gj = c0 + r;
    Li[r][tx] = (gi < n && tx < w) ? A[static_cast<size_t>(gi) * n + J + tx] : 0.0f;
    Lj[r][tx] = (gj < n && tx < w) ? A[static_cast<size_t>(gj) * n + J + tx] : 0.0f;
  }
  __syncthreads();
  const int j = c0 + tx;
  for (int r = ty; r < kP; r += 8) {
    const int i = r0 + r;
    if (i >= n || j >= n || j > i) continue;
    float s = 0.0f;
    for (int c = 0; c < w; ++c) s = s + Li[r][c] * Lj[tx][c];
    A[static_cast<size_t>(i) * n + j] -= s;
  }
}

__global__ void __launch_bounds__(kSolveThreads)
cholesky_solve_kernel(const float* __restrict__ L, int n, float* __restrict__ b) {
  extern __shared__ float x[];
  __shared__ float sD[kP][kP + 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < n; i += blockDim.x) x[i] = b[i];
  __syncthreads();
  // L y = b
  for (int J = 0; J < n; J += kP) {
    const int w = min(kP, n - J);
    for (int t = tid; t < w * kP; t += blockDim.x) {
      const int r = t / kP, c = t % kP;
      if (c <= r) sD[r][c] = L[static_cast<size_t>(J + r) * n + J + c];
    }
    __syncthreads();
    if (warp == 0) {
      float y = lane < w ? x[J + lane] : 0.0f;
      for (int j = 0; j < w; ++j) {
        const float yj = __shfl_sync(0xffffffffu, y, j) / sD[j][j];
        if (lane == j) y = yj;
        if (lane > j && lane < w) y -= sD[lane][j] * yj;
      }
      if (lane < w) x[J + lane] = y;
    }
    __syncthreads();
    for (int i = J + w + tid; i < n; i += blockDim.x) {
      const float* Li = L + static_cast<size_t>(i) * n + J;
      float s = 0.0f;
      for (int c = 0; c < w; ++c) s = s + Li[c] * x[J + c];
      x[i] -= s;
    }
    __syncthreads();
  }
  // L^T x = y
  for (int J = ((n - 1) / kP) * kP; J >= 0; J -= kP) {
    const int w = min(kP, n - J);
    for (int t = tid; t < w * kP; t += blockDim.x) {
      const int r = t / kP, c = t % kP;
      if (c <= r) sD[r][c] = L[static_cast<size_t>(J + r) * n + J + c];
    }
    __syncthreads();
    if (warp == 0) {
      float z = lane < w ? x[J + lane] : 0.0f;
      for (int j = w - 1; j >= 0; --j) {
        const float zj = __shfl_sync(0xffffffffu, z, j) / sD[j][j];
        if (lane == j) z = zj;
        if (lane < j) z -= sD[j][lane] * zj;
      }
      if (lane < w) x[J + lane] = z;
    }
    __syncthreads();
    for (int i = tid; i < J; i += blockDim.x) {
      float s = 0.0f;
      for (int c = 0; c < w; ++c) s = s + L[static_cast<size_t>(J + c) * n + i] * x[J + c];
      x[i] -= s;
    }
    __syncthreads();
  }
  for (int i = tid; i < n; i += blockDim.x) b[i] = x[i];
}

// kernel F's system: fixed cameras as identity rows, damping, symmetry
__global__ void cholesky_ba_damp_kernel(const float* __restrict__ S,
                               const float* __restrict__ b_S,
                               const uint8_t* __restrict__ opt_mask,
                               const float* __restrict__ lam_p, int K,
                               float* __restrict__ A, float* __restrict__ x) {
  const int n = 6 * K;
  const size_t t = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t < static_cast<size_t>(n)) x[t] = opt_mask[t / 6] ? b_S[t] : 0.0f;
  if (t >= static_cast<size_t>(n) * n) return;
  const int i = static_cast<int>(t / n), j = static_cast<int>(t % n);
  if (j > i) return;
  const bool fi = !opt_mask[i / 6], fj = !opt_mask[j / 6];
  if (i == j) {
    const int k = i / 6;
    float s = 0.0f;
    for (int c = 0; c < 6; ++c) {
      const int ii = 6 * k + c;
      s += fi ? 1.0f : S[static_cast<size_t>(ii) * n + ii];
    }
    A[t] = (fi ? 1.0f : S[t]) + lam_p[0] * osl::nan_max(s / 6.0f, 1e-6f);
  } else {
    A[t] = (fi || fj) ? 0.0f : 0.5f * (S[t] + S[static_cast<size_t>(j) * n + i]);
  }
}

__global__ void cholesky_ba_step_kernel(const float* __restrict__ x,
                               const uint8_t* __restrict__ opt_mask,
                               const int* __restrict__ failed,
                               const float* __restrict__ poses, int K,
                               float* __restrict__ dc, float* __restrict__ poses_n) {
  const float nan = __int_as_float(0x7fc00000);
  for (int t = threadIdx.x; t < 6 * K; t += blockDim.x) {
    dc[t] = !opt_mask[t / 6] ? 0.0f : (*failed ? nan : -x[t]);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    osl::se3_exp_left(dc + 6 * k, poses + 16 * k, poses_n + 16 * k);
  }
}

}  // namespace

// A (n x n, row-major, the lower triangle read) is overwritten by L; b by
// the solution of A x = b; *failed (zeroed here) is set if a pivot is not
// > 0. Launches only, on `stream`.
OSL_EXPORT int osl_cholesky_solve_blocked(float* A, int n, float* b, int* failed,
                                          void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(failed, 0, sizeof(int), st);
  for (int J = 0; J < n; J += kP) {
    const int w = min(kP, n - J);
    cholesky_diag_kernel<<<1, 32, 0, st>>>(A, n, J, w, failed);
    const int below = n - J - w;
    if (below > 0) {
      cholesky_panel_kernel<<<(below + kRowsPerBlock - 1) / kRowsPerBlock,
                              32 * kRowsPerBlock, 0, st>>>(A, n, J, w);
      const int t = (below + kP - 1) / kP;
      cholesky_update_kernel<<<t * (t + 1) / 2, dim3(kP, 8), 0, st>>>(A, n, J, w);
    }
  }
  const int smem = static_cast<int>(sizeof(float)) * n;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(cholesky_solve_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  cholesky_solve_kernel<<<1, kSolveThreads, smem, st>>>(A, n, b);
  return static_cast<int>(cudaGetLastError());
}

OSL_EXPORT int osl_ba_solve_blocked(const float* S, const float* b_S,
                                    const uint8_t* opt_mask, const float* lam,
                                    const float* poses, int K, float* work,
                                    float* x, int* failed, float* dc,
                                    float* poses_n, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n = 6 * static_cast<size_t>(K);
  cholesky_ba_damp_kernel<<<static_cast<unsigned>((n * n + 255) / 256), 256,
                            0, st>>>(S, b_S, opt_mask, lam, K, work, x);
  const int err = osl_cholesky_solve_blocked(work, static_cast<int>(n), x, failed,
                                             stream);
  if (err != 0) return err;
  cholesky_ba_step_kernel<<<1, 256, 0, st>>>(x, opt_mask, failed, poses, K, dc,
                                             poses_n);
  return static_cast<int>(cudaGetLastError());
}
