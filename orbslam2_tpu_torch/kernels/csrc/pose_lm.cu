// Kernel D: motion-only Levenberg-Marquardt on one SE(3) pose, the whole
// 4 rounds x 10 iterations schedule in one launch.
//
// Replaces orbslam2_tpu/ops/pose_opt.py: optimize_pose (with
// _residuals_jacobians, the unrolled 6x6 Cholesky of ops/linalg_small.py and
// geometry.se3_exp).
//
// Bound on the H100: launch latency and serial dependence. Each iteration is
// one pass over the edges, a 6x6 solve and one more pass for the trial cost,
// and every iteration depends on the last; as eager PyTorch that is ~40
// small kernels per iteration, 1600 per call, several calls a frame.
// Design: one thread block of 512 threads owns the problem. Per iteration
// every thread accumulates the 21 upper entries of H and the 6 of b over a
// strided slice of the edges (skipping edges outside the round's mask, which
// add exact zeros in the reference), the block reduces them in a fixed order,
// thread 0 damps (lam * diag(H) + 1e-9 I), solves by the same unrolled
// Cholesky as the reference and forms se3_exp(dx) @ Tcw in shared memory,
// the block reduces the robust trial cost, and thread 0 accepts or rejects
// with the x0.5 / x4 lambda schedule. Between rounds each thread
// reclassifies its own edges by chi2 (Huber in rounds 0-1, inliers only
// from round 2). Built without FMA contraction; the block reduction sums in
// another order than the plain version, so the pose agrees to rounding,
// not bit for bit.
// A launch given a gate (the retry pass of the tracking cascade) returns at
// once unless the first pass's inlier count is below the threshold; the
// retry writes its pose and count over the first pass's, so the gate count
// and n_inliers may be one buffer (every thread reads the gate before the
// first barrier, thread 0 writes the count after the last).
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kNH = 21;  // upper triangle of the 6x6 H
constexpr int kNB = 27;  // + 6 entries of b
constexpr float kChi2Mono = 5.991f;
constexpr float kChi2Stereo = 7.815f;
constexpr unsigned kFull = 0xffffffffu;

struct Cam {
  float fx, fy, cx, cy, bf;
};

// Camera-frame point and its clamped depth for edge i under pose T
// (row-major 4x4 in shared memory).
__device__ __forceinline__ void transform(const float* T, const float* pts,
                                          int i, float pc[3]) {
  const float p0 = pts[3 * i], p1 = pts[3 * i + 1], p2 = pts[3 * i + 2];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    pc[r] = T[4 * r] * p0 + T[4 * r + 1] * p1 + T[4 * r + 2] * p2 + T[4 * r + 3];
  }
}

// Squared residual over sigma^2 and, when J != nullptr, the residual and the
// 3x6 Jacobian for a left twist update. Returns the clamped depth.
__device__ __forceinline__ float edge_eval(const float* T, const float* pts,
                                           const float* obs, int i,
                                           bool stereo, const Cam& cam,
                                           float inv_sigma2, float* chi2,
                                           float r[3], float J[3][6]) {
  float pc[3];
  transform(T, pts, i, pc);
  const float x = pc[0], y = pc[1];
  const float z = fmaxf(pc[2], 1e-6f);
  const float inv_z = 1.0f / z;
  const float inv_z2 = inv_z * inv_z;
  const float u = cam.fx * x * inv_z + cam.cx;
  const float v = cam.fy * y * inv_z + cam.cy;
  const float ur = u - cam.bf * inv_z;
  r[0] = u - obs[3 * i];
  r[1] = v - obs[3 * i + 1];
  r[2] = stereo ? ur - obs[3 * i + 2] : 0.0f;
  *chi2 = (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]) * inv_sigma2;
  if (J != nullptr) {
    // d(pixel)/d(pc); the pose part is Jpix @ [I | -hat(pc)] with the
    // unclamped pc, as the reference writes it
    float jp[3][3] = {
        {cam.fx * inv_z, 0.0f, -cam.fx * x * inv_z2},
        {0.0f, cam.fy * inv_z, -cam.fy * y * inv_z2},
        {0.0f, 0.0f, 0.0f}};
    if (stereo) {
      jp[2][0] = cam.fx * inv_z;
      jp[2][2] = -cam.fx * x * inv_z2 + cam.bf * inv_z2;
    }
    const float zr = pc[2];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      J[k][0] = jp[k][0];
      J[k][1] = jp[k][1];
      J[k][2] = jp[k][2];
      J[k][3] = jp[k][1] * (-zr) + jp[k][2] * y;
      J[k][4] = jp[k][0] * zr + jp[k][2] * (-x);
      J[k][5] = jp[k][0] * (-y) + jp[k][1] * x;
    }
  }
  return z;
}

__device__ __forceinline__ float rho(float chi2, bool huber, float delta2) {
  const float c = fminf(chi2, 1e9f);
  if (!huber) return fminf(c, 1e6f);
  return c <= delta2 ? c : 2.0f * sqrtf(delta2 * fmaxf(c, 1e-12f)) - delta2;
}

// Sum `n` per-thread values over the block; the totals land in out[0..n).
template <int n>
__device__ void block_sum(float (&v)[n], float (*scratch)[kNB], float* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < n; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_xor_sync(kFull, v[k], o);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < n; ++k) scratch[warp][k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < n) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += scratch[w][threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// Damped 6x6 solve dx = -(H + lam diag(H) + 1e-9 I)^-1 b by the reference's
// unrolled Cholesky (thread 0 only). hb holds the 21 upper entries of H
// row-major, then b.
__device__ void solve_step(const float* hb, float lam, float dx[6]) {
  float A[6][6];
  int k = 0;
  for (int i = 0; i < 6; ++i) {
    for (int j = i; j < 6; ++j) {
      A[i][j] = A[j][i] = hb[k++];
    }
  }
  for (int i = 0; i < 6; ++i) A[i][i] = (A[i][i] + lam * A[i][i]) + 1e-9f;
  float L[6][6];
  for (int j = 0; j < 6; ++j) {
    float s = A[j][j];
    for (int q = 0; q < j; ++q) s = s - L[j][q] * L[j][q];
    L[j][j] = sqrtf(fmaxf(s, 1e-12f));
    const float inv = 1.0f / L[j][j];
    for (int i = j + 1; i < 6; ++i) {
      float t = A[i][j];
      for (int q = 0; q < j; ++q) t = t - L[i][q] * L[j][q];
      L[i][j] = t * inv;
    }
  }
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float s = hb[kNH + i];
    for (int q = 0; q < i; ++q) s = s - L[i][q] * y[q];
    y[i] = s / L[i][i];
  }
  float x[6];
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int q = i + 1; q < 6; ++q) s = s - L[q][i] * x[q];
    x[i] = s / L[i][i];
  }
  for (int i = 0; i < 6; ++i) dx[i] = -x[i];
}

__global__ void __launch_bounds__(kThreads)
pose_lm_kernel(const float* __restrict__ T_init, const float* __restrict__ pts,
               const float* __restrict__ obs, const float* __restrict__ sigma2,
               const uint8_t* __restrict__ valid, int N, Cam cam, int rounds,
               int iters, const int* gate_n, int gate_min,
               float* __restrict__ T_out, uint8_t* __restrict__ inliers,
               int* n_inliers, float* __restrict__ chi2_out) {
  if (gate_n != nullptr && !(*gate_n < gate_min)) return;
  __shared__ float T[16];
  __shared__ float Tn[16];
  __shared__ float scratch[kWarps][kNB];
  __shared__ float red[kNB];
  __shared__ int accept_flag;
  const int tid = threadIdx.x;
  if (tid < 16) T[tid] = T_init[tid];
  for (int i = tid; i < N; i += kThreads) inliers[i] = valid[i];
  __syncthreads();

  float lam = 0.0f;   // thread 0's copies of the LM state
  float cost = 0.0f;
  for (int rnd = 0; rnd < rounds; ++rnd) {
    const bool huber = rnd < 2;
    // edge mask: valid in rounds 0-1, the previous round's inliers after
    // (each thread reads and writes only its own edges of inliers[])
    float c0[1] = {0.0f};
    for (int i = tid; i < N; i += kThreads) {
      if (!(huber ? valid[i] : inliers[i])) continue;
      const bool st = obs[3 * i + 2] >= 0.0f;
      const float d2 = st ? kChi2Stereo : kChi2Mono;
      float chi2, r[3];
      const float z = edge_eval(T, pts, obs, i, st, cam,
                                1.0f / fmaxf(sigma2[i], 1e-12f), &chi2, r,
                                nullptr);
      c0[0] += rho(z <= 1e-5f ? 1e9f : chi2, huber, d2);
    }
    block_sum<1>(c0, scratch, red);
    if (tid == 0) {
      lam = 1e-3f;
      cost = red[0];
    }
    for (int it = 0; it < iters; ++it) {
      float acc[kNB];
#pragma unroll
      for (int k = 0; k < kNB; ++k) acc[k] = 0.0f;
      for (int i = tid; i < N; i += kThreads) {
        if (!(huber ? valid[i] : inliers[i])) continue;
        const bool st = obs[3 * i + 2] >= 0.0f;
        const float d2 = st ? kChi2Stereo : kChi2Mono;
        const float inv_s2 = 1.0f / fmaxf(sigma2[i], 1e-12f);
        float chi2, r[3], J[3][6];
        edge_eval(T, pts, obs, i, st, cam, inv_s2, &chi2, r, J);
        const float wh =
            chi2 <= d2 ? 1.0f : sqrtf(d2 / fmaxf(chi2, 1e-12f));
        const float w = (huber ? wh : 1.0f) * inv_s2;
        int k = 0;
#pragma unroll
        for (int a = 0; a < 6; ++a) {
#pragma unroll
          for (int b = a; b < 6; ++b) {
            acc[k++] += (J[0][a] * w) * J[0][b] + (J[1][a] * w) * J[1][b] +
                        (J[2][a] * w) * J[2][b];
          }
        }
#pragma unroll
        for (int a = 0; a < 6; ++a) {
          acc[kNH + a] += (J[0][a] * w) * r[0] + (J[1][a] * w) * r[1] +
                          (J[2][a] * w) * r[2];
        }
      }
      block_sum<kNB>(acc, scratch, red);
      if (tid == 0) {
        float dx[6];
        solve_step(red, lam, dx);
        osl::se3_exp_left(dx, T, Tn);
      }
      __syncthreads();
      float cn[1] = {0.0f};
      for (int i = tid; i < N; i += kThreads) {
        if (!(huber ? valid[i] : inliers[i])) continue;
        const bool st = obs[3 * i + 2] >= 0.0f;
        const float d2 = st ? kChi2Stereo : kChi2Mono;
        float chi2, r[3];
        edge_eval(Tn, pts, obs, i, st, cam, 1.0f / fmaxf(sigma2[i], 1e-12f),
                  &chi2, r, nullptr);
        cn[0] += rho(chi2, huber, d2);
      }
      block_sum<1>(cn, scratch, red);
      if (tid == 0) {
        const bool accept = red[0] < cost;
        accept_flag = accept;
        if (accept) cost = red[0];
        lam = accept ? lam * 0.5f : lam * 4.0f;
      }
      __syncthreads();
      if (accept_flag && tid < 16) T[tid] = Tn[tid];
      __syncthreads();
    }
    // chi2 reclassification of every edge at the round's pose
    for (int i = tid; i < N; i += kThreads) {
      const bool st = obs[3 * i + 2] >= 0.0f;
      float chi2, r[3];
      const float z = edge_eval(T, pts, obs, i, st, cam,
                                1.0f / fmaxf(sigma2[i], 1e-12f), &chi2, r,
                                nullptr);
      if (z <= 1e-5f) chi2 = 1e9f;
      inliers[i] = valid[i] && chi2 <= (st ? kChi2Stereo : kChi2Mono);
      chi2_out[i] = chi2;
    }
  }
  float cnt[1] = {0.0f};
  for (int i = tid; i < N; i += kThreads) cnt[0] += inliers[i] ? 1.0f : 0.0f;
  block_sum<1>(cnt, scratch, red);
  if (tid < 16) T_out[tid] = T[tid];
  if (tid == 0) *n_inliers = static_cast<int>(red[0]);
}

}  // namespace

OSL_EXPORT int osl_pose_lm(const float* T_init, const float* pts,
                           const float* obs, const float* sigma2,
                           const uint8_t* valid, int N, float fx, float fy,
                           float cx, float cy, float bf, int rounds, int iters,
                           const int* gate_n, int gate_min, float* T_out,
                           uint8_t* inliers, int* n_inliers, float* chi2_out,
                           void* stream) {
  const Cam cam{fx, fy, cx, cy, bf};
  pose_lm_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      T_init, pts, obs, sigma2, valid, N, cam, rounds, iters, gate_n, gate_min,
      T_out, inliers, n_inliers, chi2_out);
  return static_cast<int>(cudaGetLastError());
}
