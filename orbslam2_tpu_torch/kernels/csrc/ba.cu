// Kernels E-H: one Levenberg-Marquardt iteration of bundle adjustment with
// the landmark Schur complement, as launches on the caller's stream.
//
// Replaces orbslam2_tpu/ops/ba.py: optimize_ba_impl (with _project_t,
// _robust_t, _cost_t, _build_and_solve, _schur_solve and _apply). The JAX
// program keeps an observation-last layout and reduces over cameras with
// one-hot matmuls and two dense (6K, 3M) products on the TPU's matrix unit;
// here each landmark owns its observations and adds its pairs' blocks to
// the camera system in fixed point.
//
//   E ba_linearize_kernel   8 lanes per landmark (one per observation slot,
//                           O <= 8), 16 landmarks per block. Each lane
//                           projects its observation, forms Jp, Jl and the
//                           robust weight, and writes E = Jp^T w Jl and its
//                           diagonal block Jp^T w Jp. The group sums D and
//                           b_l with shuffles in a fixed order, every lane
//                           forms the damped adjugate inverse, and then
//                           writes E D^-1, its b_S term Jp^T w r -
//                           E D^-1 b_l and its camera (-1 when it does not
//                           count). Writes E, D^-1, b_l.
//                           Each camera's largest finite |E D^-1|, |E|,
//                           |Jp^T w Jp| and |b_S term| (integer atomics on
//                           the float bits) bound every term of its blocks.
//     ba_linearize_pairs_kernel
//                           the camera system in fixed point: lane o1 of a
//                           landmark adds -E_o1 D^-1 E_o2^T (plus Jp^T w Jp
//                           where o2 = o1) for every observation o2 to block
//                           (k(o1), k(o2)), and its b_S term, each entry
//                           rounded to kFixedBits bits below the block's
//                           bound into a 64-bit integer (integer atomics:
//                           the sum has no order); NaN and infinite terms
//                           are marked instead.
//     ba_linearize_sum_kernel
//                           writes S and b_S from the integer sums (IEEE's
//                           NaN or infinity where a term was marked). S is
//                           the same from run to run, each term within
//                           2^-41 of its block's bound.
//   F ba_solve_kernel       one block of 1024 threads: fixed cameras,
//                           damping, symmetrisation into a 6K x 6K device
//                           workspace (L2-resident), a left-looking blocked
//                           Cholesky in 32-column panels (panel update with
//                           the panel's rows of L in shared memory, the
//                           diagonal block in shared memory by one warp, the
//                           rows below by warps with shuffles: four block
//                           barriers a panel), the triangular solves panel by
//                           panel against the kept diagonal blocks, then
//                           se3_exp(dc) @ T per camera. A pivot that is not
//                           > 0 makes the steps of the optimised cameras NaN.
//   G ba_update_cost_kernel same layout as E: back-substitution
//                           dl = -D^-1 (b_l + sum_o E_o^T dc), the robust
//                           cost at the trial parameters and the chi2
//                           classification. Each block writes its partial
//                           cost; the last block to finish sums the partials
//                           in block order (deterministic).
//   H ba_accept_kernel      one block: cost test, lambda x0.5 / x4, keep or
//                           revert poses and points, all on the device.
//
// Bound on the H100: latency, not bytes or operations. At the local-BA
// shape (K = 16, M = 1024, O = 8) an iteration is ~15 MFLOP and ~1 MB, a
// few microseconds of the card's peak; the dependent chain of launches and
// F's serial panel steps and triangular solves set the time. No sum uses
// float atomics. Built without FMA contraction.
#include "common.cuh"

namespace {

constexpr int kSlots = 8;                 // lanes per landmark, O <= kSlots
constexpr int kLandmarksPerBlock = 16;    // LANDMARKS_PER_BLOCK in Python
constexpr int kThreads = kSlots * kLandmarksPerBlock;
constexpr int kSolveThreads = 1024;
constexpr int kMaxN = 6 * 64;             // 6K for K <= 64
constexpr int kPanel = 32;                // Cholesky panel width
// a term of the camera system in fixed point: |term| < 2^e for its block's
// bound f 2^e (frexp), rounded to 2^(e - kFixedBits); an entry sums at most
// MAX_M * O * O = 2^21 terms, so |sum| < 2^62
constexpr int kFixedBits = 41;
constexpr int kSumThreads = 256;
constexpr float kChi2Mono = 5.991f;
constexpr float kChi2Stereo = 7.815f;
constexpr unsigned kFull = 0xffffffffu;

struct Cam {
  float fx, fy, cx, cy, bf;
};

// Sum over the 8 lanes of a landmark's group; every lane gets the same sum
// (float addition commutes, so the butterfly is order-consistent).
__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  v += __shfl_xor_sync(kFull, v, 2);
  v += __shfl_xor_sync(kFull, v, 4);
  return v;
}

// Residual r, camera-frame point (x, y, unclamped z) and the clamped depth
// of one observation under pose T (row-major 4x4).
__device__ __forceinline__ float project(const float* __restrict__ T,
                                         const float p[3], const float* uvr,
                                         const Cam& cam, float r[3],
                                         float pc[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    pc[i] = T[4 * i] * p[0] + T[4 * i + 1] * p[1] + T[4 * i + 2] * p[2] +
            T[4 * i + 3];
  }
  const float z = fmaxf(pc[2], 1e-6f);
  const float inv_z = 1.0f / z;
  const float u = cam.fx * pc[0] * inv_z + cam.cx;
  const float v = cam.fy * pc[1] * inv_z + cam.cy;
  r[0] = u - uvr[0];
  r[1] = v - uvr[1];
  r[2] = uvr[2] >= 0.0f ? (u - cam.bf * inv_z) - uvr[2] : 0.0f;
  return z;
}

__device__ __forceinline__ float chi2_of(const float r[3], float sigma2) {
  return (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]) / fmaxf(sigma2, 1e-12f);
}

__device__ __forceinline__ float rho(float chi2, bool huber, float delta2) {
  // a NaN chi2 (a trial step from a failed factorization) stays NaN, as
  // the reference's jnp.minimum / jnp.maximum keep it, so that the trial
  // cost is NaN and H rejects the step; fminf / fmaxf would return the
  // other operand, a finite (with Huber, negative) cost that H accepts
  if (isnan(chi2)) return chi2;
  if (!huber) return fminf(chi2, 1e6f);
  return chi2 <= delta2 ? chi2
                        : 2.0f * sqrtf(delta2 * fmaxf(chi2, 1e-12f)) - delta2;
}

__device__ __forceinline__ float finite_abs(float v) {
  return isfinite(v) ? fabsf(v) : 0.0f;
}

// ---------------------------------------------------------------------------
// E: linearise, then sum the camera system in fixed point
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
ba_linearize_kernel(const float* __restrict__ poses,
                    const float* __restrict__ points,
                    const uint8_t* __restrict__ point_valid,
                    const int* __restrict__ obs_kf,
                    const float* __restrict__ obs_uvr,
                    const float* __restrict__ obs_sigma2,
                    const uint8_t* __restrict__ obs_mask,
                    const float* __restrict__ lam_p, int M, int O, Cam cam,
                    int huber, float* __restrict__ E_out,
                    float* __restrict__ Dinv_out, float* __restrict__ bl_out,
                    float* __restrict__ ED_out, float* __restrict__ Hd_out,
                    float* __restrict__ bo_out, int* __restrict__ act_out,
                    int* __restrict__ cam_max) {
  const int g = threadIdx.x / kSlots;       // landmark within the block
  const int o = threadIdx.x % kSlots;       // observation slot
  const int m = blockIdx.x * kLandmarksPerBlock + g;
  const bool in_range = m < M && o < O;
  const int idx = m * O + o;
  const int kf = in_range ? obs_kf[idx] : -1;
  const bool pv = m < M && point_valid[m];
  const bool active = in_range && kf >= 0 && pv && obs_mask[idx];

  float E[6][3], D[3][3], bl[3], jr[6];
  // the observation's largest finite |E D^-1|, |E|, |Jp^T w Jp|, |b_S term|
  float mx[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < 6; ++c) E[c][0] = E[c][1] = E[c][2] = jr[c] = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    D[i][0] = D[i][1] = D[i][2] = 0.0f;
    bl[i] = 0.0f;
  }
  if (active) {
    const float* T = poses + 16 * kf;
    const float p[3] = {points[3 * m], points[3 * m + 1], points[3 * m + 2]};
    const float* uvr = obs_uvr + 3 * idx;
    float r[3], pc[3];
    const float z = project(T, p, uvr, cam, r, pc);
    const float x = pc[0], y = pc[1];
    const float inv_z = 1.0f / z;
    const float inv_z2 = inv_z * inv_z;
    const bool st = uvr[2] >= 0.0f;
    const float s2 = fmaxf(obs_sigma2[idx], 1e-12f);
    const float chi2 = (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]) / s2;
    const float d2 = st ? kChi2Stereo : kChi2Mono;
    const float wh = chi2 <= d2 ? 1.0f : sqrtf(d2 / fmaxf(chi2, 1e-12f));
    const float w = z > 1e-5f ? (huber ? wh : 1.0f) / s2 : 0.0f;
    // d(pixel)/d(pc), then the pose part Jpix @ [I | -hat(pc)] with the
    // clamped depth, and the point part Jpix @ R
    const float stf = st ? 1.0f : 0.0f;
    const float j00 = cam.fx * inv_z;
    const float j02 = -cam.fx * x * inv_z2;
    const float Jpix[3][3] = {
        {j00, 0.0f, j02},
        {0.0f, cam.fy * inv_z, -cam.fy * y * inv_z2},
        {stf * j00, 0.0f, stf * (j02 + cam.bf * inv_z2)}};
    const float Jpose[3][6] = {{1.0f, 0.0f, 0.0f, 0.0f, z, -y},
                               {0.0f, 1.0f, 0.0f, -z, 0.0f, x},
                               {0.0f, 0.0f, 1.0f, y, -x, 0.0f}};
    float Jp[3][6], Jl[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        Jp[i][c] = Jpix[i][0] * Jpose[0][c] + Jpix[i][1] * Jpose[1][c] +
                   Jpix[i][2] * Jpose[2][c];
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        Jl[i][j] = Jpix[i][0] * T[j] + Jpix[i][1] * T[4 + j] +
                   Jpix[i][2] * T[8 + j];
      }
    }
    // the observation's camera block Jp^T w Jp, its Jp^T w r and E
    float* Hd = Hd_out + 36 * idx;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      const float a0 = Jp[0][c] * w, a1 = Jp[1][c] * w, a2 = Jp[2][c] * w;
#pragma unroll
      for (int d = 0; d < 6; ++d) {
        const float h = a0 * Jp[0][d] + a1 * Jp[1][d] + a2 * Jp[2][d];
        Hd[6 * c + d] = h;
        mx[2] = fmaxf(mx[2], finite_abs(h));
      }
      jr[c] = a0 * r[0] + a1 * r[1] + a2 * r[2];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        E[c][j] = a0 * Jl[0][j] + a1 * Jl[1][j] + a2 * Jl[2][j];
        mx[1] = fmaxf(mx[1], finite_abs(E[c][j]));
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float a0 = Jl[0][i] * w, a1 = Jl[1][i] * w, a2 = Jl[2][i] * w;
#pragma unroll
      for (int j = 0; j < 3; ++j) D[i][j] = a0 * Jl[0][j] + a1 * Jl[1][j] + a2 * Jl[2][j];
      bl[i] = a0 * r[0] + a1 * r[1] + a2 * r[2];
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) D[i][j] = group_sum(D[i][j]);
    bl[i] = group_sum(bl[i]);
  }

  // damped adjugate inverse of D (every lane of the group, same values)
  const float trD = D[0][0] + D[1][1] + D[2][2];
  const float damp = (1e-9f + lam_p[0]) * fmaxf(trD / 3.0f, 1e-6f) + 1e-8f;
  const float a = D[0][0] + damp, b = D[0][1], c = D[0][2];
  const float d = D[1][0], e = D[1][1] + damp, f = D[1][2];
  const float gg = D[2][0], h = D[2][1], i = D[2][2] + damp;
  float Di[3][3] = {{e * i - f * h, c * h - b * i, b * f - c * e},
                    {f * gg - d * i, a * i - c * gg, c * d - a * f},
                    {d * h - e * gg, b * gg - a * h, a * e - b * d}};
  const float det = a * Di[0][0] + b * Di[1][0] + c * Di[2][0];
  const float safe = fabsf(det) < 1e-12f ? 1e-12f : det;
  const float inv_det = pv ? 1.0f / safe : 0.0f;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int s = 0; s < 3; ++s) Di[r][s] = Di[r][s] * inv_det;
  }

  if (active) {
    // E D^-1 and the observation's b_S term Jp^T w r - E D^-1 b_l
    float* EDo = ED_out + 18 * idx;
#pragma unroll
    for (int c6 = 0; c6 < 6; ++c6) {
      float ed[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        ed[j] = E[c6][0] * Di[0][j] + E[c6][1] * Di[1][j] + E[c6][2] * Di[2][j];
        EDo[3 * c6 + j] = ed[j];
        mx[0] = fmaxf(mx[0], finite_abs(ed[j]));
      }
      const float b = jr[c6] + -(ed[0] * bl[0] + ed[1] * bl[1] + ed[2] * bl[2]);
      bo_out[6 * idx + c6] = b;
      mx[3] = fmaxf(mx[3], finite_abs(b));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (mx[i] > 0.0f) atomicMax(cam_max + 4 * kf + i, __float_as_int(mx[i]));
    }
  }
  if (in_range) {
    act_out[idx] = active ? kf : -1;
    float* Eo = E_out + 18 * idx;
#pragma unroll
    for (int c6 = 0; c6 < 6; ++c6) {
#pragma unroll
      for (int j = 0; j < 3; ++j) Eo[3 * c6 + j] = E[c6][j];
    }
  }
  if (m < M && o == 0) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int s = 0; s < 3; ++s) Dinv_out[9 * m + 3 * r + s] = Di[r][s];
      bl_out[3 * m + r] = bl[r];
    }
  }
}

// The multiplier 2^(kFixedBits - e) of a sum whose terms are bounded by
// f 2^e (f in [0.5, 1)); 0 for a bound of 0 (no finite term is non-zero).
__device__ __forceinline__ double fixed_scale(double bound) {
  if (!(bound > 0.0)) return 0.0;
  int e;
  frexp(bound, &e);
  return ldexp(1.0, kFixedBits - e);
}

// The bound of block (k1, k2)'s terms: |sum_j u_j v_j| <= 3 max|u| max|v|,
// plus Jp^T w Jp on the diagonal, with room for the terms' rounding.
__device__ __forceinline__ double block_scale(const int* __restrict__ cam_max,
                                              int k1, int k2) {
  double b = 3.0 * static_cast<double>(__int_as_float(cam_max[4 * k1])) *
             static_cast<double>(__int_as_float(cam_max[4 * k2 + 1]));
  if (k1 == k2) b += static_cast<double>(__int_as_float(cam_max[4 * k1 + 2]));
  return fixed_scale(b * (1.0 + 0x1p-10));
}

__device__ __forceinline__ double rhs_scale(const int* __restrict__ cam_max,
                                            int k) {
  return fixed_scale(static_cast<double>(__int_as_float(cam_max[4 * k + 3])) *
                     (1.0 + 0x1p-10));
}

// One term into its sum: rounded to the sum's fixed point, or marked (1
// NaN, 2 +inf, 4 -inf).
__device__ __forceinline__ void add_term(float v, double scale,
                                         unsigned long long* acc, int* mark) {
  if (!isfinite(v)) {
    atomicOr(mark, isnan(v) ? 1 : (v > 0.0f ? 2 : 4));
  } else if (v != 0.0f) {
    atomicAdd(acc, static_cast<unsigned long long>(
                       llrint(static_cast<double>(v) * scale)));
  }
}

// Lane o1 of landmark m: every pair (o1, o2) of its counted observations
// into the sums of block (k(o1), k(o2)), S's entry (k1, c, k2, d) at
// (k1 * K + k2) * 36 + 6 c + d, and its b_S term at 36 K^2 + 6 k1 + c.
__global__ void __launch_bounds__(kThreads)
ba_linearize_pairs_kernel(int M, int O, int K, const int* __restrict__ act,
                          const float* __restrict__ E,
                          const float* __restrict__ ED,
                          const float* __restrict__ Hd,
                          const float* __restrict__ bo,
                          const int* __restrict__ cam_max,
                          unsigned long long* __restrict__ acc,
                          int* __restrict__ marks) {
  const int o1 = threadIdx.x % kSlots;
  const int m = blockIdx.x * kLandmarksPerBlock + threadIdx.x / kSlots;
  if (m >= M || o1 >= O) return;
  const int i1 = m * O + o1;
  const int k1 = act[i1];
  if (k1 < 0) return;
  float u[18];
#pragma unroll
  for (int j = 0; j < 18; ++j) u[j] = ED[18 * i1 + j];
  for (int o2 = 0; o2 < O; ++o2) {
    const int i2 = m * O + o2;
    const int k2 = act[i2];
    if (k2 < 0) continue;
    const int key = k1 * K + k2;
    const double scale = block_scale(cam_max, k1, k2);
    const float* v = E + 18 * i2;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
#pragma unroll
      for (int d = 0; d < 6; ++d) {
        const float pair = -(u[3 * c] * v[3 * d] + u[3 * c + 1] * v[3 * d + 1] +
                             u[3 * c + 2] * v[3 * d + 2]);
        const float t = o2 == o1 ? Hd[36 * i1 + 6 * c + d] + pair : pair;
        add_term(t, scale, acc + 36 * key + 6 * c + d,
                 marks + 36 * key + 6 * c + d);
      }
    }
  }
  const double scale = rhs_scale(cam_max, k1);
  const int base = 36 * K * K + 6 * k1;
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    add_term(bo[6 * i1 + c], scale, acc + base + c, marks + base + c);
  }
}

// S (6K x 6K, row 6 k + c) and b_S from the sums: the IEEE sum of the
// marked terms where there are any, else the fixed-point sum.
__global__ void __launch_bounds__(kSumThreads)
ba_linearize_sum_kernel(int K, const int* __restrict__ cam_max,
                        const unsigned long long* __restrict__ acc,
                        const int* __restrict__ marks, float* __restrict__ S,
                        float* __restrict__ b_S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n_s = 36 * K * K;
  if (i >= n_s + 6 * K) return;
  const int mk = marks[i];
  const int k1 = i < n_s ? i / 36 / K : (i - n_s) / 6;
  const int k2 = (i / 36) % K;
  float v;
  if ((mk & 1) || (mk & 6) == 6) {
    v = __int_as_float(0x7fc00000);
  } else if (mk) {
    v = (mk & 2) ? INFINITY : -INFINITY;
  } else {
    const double scale = i < n_s ? block_scale(cam_max, k1, k2)
                                 : rhs_scale(cam_max, k1);
    const long long f = static_cast<long long>(acc[i]);
    v = scale > 0.0 ? static_cast<float>(static_cast<double>(f) / scale) : 0.0f;
  }
  if (i < n_s) {
    const int c = (i % 36) / 6, d = i % 6;
    S[(6 * k1 + c) * (6 * K) + 6 * k2 + d] = v;
  } else {
    b_S[i - n_s] = v;
  }
}

// ---------------------------------------------------------------------------
// F: fixed cameras, damping, blocked Cholesky, triangular solves, pose update
// ---------------------------------------------------------------------------
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__global__ void __launch_bounds__(kSolveThreads)
ba_solve_kernel(const float* __restrict__ S, const float* __restrict__ b_S,
                const uint8_t* __restrict__ opt_mask,
                const float* __restrict__ lam_p,
                const float* __restrict__ poses, int K, float* __restrict__ A,
                float* __restrict__ dc_out, float* __restrict__ poses_n) {
  // A: the n x n workspace (row-major, lower triangle used). Dynamic
  // shared memory: the current panel's rows of L for the panel update
  // (kPanel rows of stride n + 1, against bank conflicts), then every
  // panel's diagonal block of L (kPanel x (kPanel + 1) each), which the
  // triangular solves reuse. Static: the right-hand side.
  extern __shared__ float smem[];
  float* sP = smem;
  float (*sDiag)[kPanel][kPanel + 1] =
      reinterpret_cast<float (*)[kPanel][kPanel + 1]>(smem + kPanel * (6 * K + 1));
  __shared__ float x[kMaxN];
  __shared__ float add[kMaxN / 6];
  __shared__ int failed;
  const int n = 6 * K;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = kSolveThreads / 32;
  const float lam = lam_p[0];
  if (tid == 0) failed = 0;
  if (tid < K) {
    // mean diagonal of the camera's block, 1 for a fixed camera
    const bool fixed = !opt_mask[tid];
    float s = 0.0f;
    for (int c = 0; c < 6; ++c) {
      const int ii = 6 * tid + c;
      s += fixed ? 1.0f : S[ii * n + ii];
    }
    add[tid] = lam * fmaxf(s / 6.0f, 1e-6f);
  }
  __syncthreads();
  for (int t = tid; t < n * n; t += kSolveThreads) {
    const int i = t / n, j = t % n;
    if (j > i) continue;
    const bool fi = !opt_mask[i / 6], fj = !opt_mask[j / 6];
    if (i == j) {
      A[t] = (fi ? 1.0f : S[t]) + add[i / 6];
    } else {
      A[t] = (fi || fj) ? 0.0f : 0.5f * (S[t] + S[j * n + i]);
    }
  }
  for (int i = tid; i < n; i += kSolveThreads) x[i] = opt_mask[i / 6] ? b_S[i] : 0.0f;
  __syncthreads();

  // left-looking blocked Cholesky A = L L^T in panels of kPanel columns,
  // with the forward substitution L y = b done panel by panel (y in x)
  for (int J = 0; J < n; J += kPanel) {
    const int w = min(kPanel, n - J);
    // (1) panel update A[i][J + c] -= sum_{k < J} L[i][k] L[J + c][k] for
    // rows i >= J + c, with the panel's rows of L staged in shared memory
    // (one warp per row, one lane per panel column, four partial sums);
    // and x[J + c] -= sum_{k < J} L[J + c][k] y[k]
    if (J > 0) {
      for (int t = tid; t < w * J; t += kSolveThreads) {
        sP[(t / J) * (n + 1) + t % J] = A[(J + t / J) * n + t % J];
      }
      __syncthreads();
      const int c = lane;
      const float* Pc = sP + c * (n + 1);
      for (int i = J + warp; i < n; i += n_warps) {
        if (c < w && J + c <= i) {
          const float* Li = A + i * n;
          float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
          int k = 0;
          for (; k + 4 <= J; k += 4) {
            s0 = s0 + Li[k] * Pc[k];
            s1 = s1 + Li[k + 1] * Pc[k + 1];
            s2 = s2 + Li[k + 2] * Pc[k + 2];
            s3 = s3 + Li[k + 3] * Pc[k + 3];
          }
          for (; k < J; ++k) s0 = s0 + Li[k] * Pc[k];
          A[i * n + J + c] -= (s0 + s1) + (s2 + s3);
        }
      }
      if (warp == 0 && c < w) {
        float s = 0.0f;
        for (int k = 0; k < J; ++k) s = s + Pc[k] * x[k];
        x[J + c] -= s;
      }
      __syncthreads();
    }
    // (2) the w x w diagonal block, loaded by the whole block, factorised
    // in shared memory by warp 0, which then solves it for y[J .. J + w)
    float (*sD)[kPanel + 1] = sDiag[J / kPanel];
    if (tid < w * kPanel && tid % kPanel <= tid / kPanel) {
      sD[tid / kPanel][tid % kPanel] = A[(J + tid / kPanel) * n + J + tid % kPanel];
    }
    __syncthreads();
    if (warp == 0) {
      for (int j = 0; j < w; ++j) {
        const float djj = sD[j][j];
        const float ljj = sqrtf(djj);
        __syncwarp();
        if (lane == 0) {
          if (!(djj > 0.0f)) failed = 1;
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
      float y = lane < w ? x[J + lane] : 0.0f;
      for (int j = 0; j < w; ++j) {
        const float yj = __shfl_sync(kFull, y, j) / sD[j][j];
        if (lane == j) y = yj;
        if (lane > j && lane < w) y -= sD[lane][j] * yj;
      }
      if (lane < w) x[J + lane] = y;
    }
    __syncthreads();
    // (3) the rows below: L[i][J + c] = (A[i][J + c] - sum_{q < c} L[i][J + q]
    // L[J + c][J + q]) / L[J + c][J + c], one warp per row, lane c holding
    // column c, the substitution carried by shuffles
    for (int i = J + w + warp; i < n; i += n_warps) {
      float v = lane < w ? A[i * n + J + lane] : 0.0f;
      for (int c = 0; c < w; ++c) {
        const float vc = __shfl_sync(kFull, v, c) / sD[c][c];
        if (lane == c) v = vc;
        if (lane > c && lane < w) v -= vc * sD[lane][c];
      }
      if (lane < w) A[i * n + J + lane] = v;
    }
    __syncthreads();
  }

  // L^T z = y panel by panel from the last: z[J + c] = (y[J + c] -
  // sum_{i >= J + w} L[i][J + c] z[i]) solved against the diagonal block
  for (int J = ((n - 1) / kPanel) * kPanel; J >= 0; J -= kPanel) {
    const int w = min(kPanel, n - J);
    // one warp per panel column c: the dot over the rows below, lanes
    // striding over i
    if (warp < w) {
      float s = 0.0f;
      for (int i = J + w + lane; i < n; i += 32) s = s + A[i * n + J + warp] * x[i];
      s = warp_sum(s);
      if (lane == 0) sP[warp] = s;
    }
    __syncthreads();
    if (warp == 0) {
      float (*sD)[kPanel + 1] = sDiag[J / kPanel];
      float z = lane < w ? x[J + lane] - sP[lane] : 0.0f;
      for (int j = w - 1; j >= 0; --j) {
        const float zj = __shfl_sync(kFull, z, j) / sD[j][j];
        if (lane == j) z = zj;
        if (lane < j) z -= sD[j][lane] * zj;
      }
      if (lane < w) x[J + lane] = z;
    }
    __syncthreads();
  }
  const float nan = __int_as_float(0x7fc00000);
  for (int t = tid; t < n; t += kSolveThreads) {
    x[t] = !opt_mask[t / 6] ? 0.0f : (failed ? nan : -x[t]);
    dc_out[t] = x[t];
  }
  __syncthreads();
  if (tid < K) osl::se3_exp_left(x + 6 * tid, poses + 16 * tid, poses_n + 16 * tid);
}

// ---------------------------------------------------------------------------
// G: back-substitution, robust cost, chi2 classification
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
ba_update_cost_kernel(const float* __restrict__ poses,
                      const float* __restrict__ points,
                      const uint8_t* __restrict__ point_valid,
                      const int* __restrict__ obs_kf,
                      const float* __restrict__ obs_uvr,
                      const float* __restrict__ obs_sigma2,
                      const uint8_t* __restrict__ obs_valid,
                      const uint8_t* __restrict__ obs_mask,
                      const float* __restrict__ dc, const float* __restrict__ E,
                      const float* __restrict__ Dinv,
                      const float* __restrict__ b_l, int M, int O, Cam cam,
                      int huber, float* __restrict__ points_n,
                      float* __restrict__ cost, uint8_t* __restrict__ inlier,
                      float* __restrict__ partial,
                      unsigned* __restrict__ done) {
  __shared__ float warp_part[kThreads / 32];
  __shared__ bool is_last;
  const int g = threadIdx.x / kSlots;
  const int o = threadIdx.x % kSlots;
  const int m = blockIdx.x * kLandmarksPerBlock + g;
  const bool in_range = m < M && o < O;
  const int idx = m * O + o;
  const int kf = in_range ? obs_kf[idx] : -1;
  const bool pv = m < M && point_valid[m];
  float p[3] = {0.0f, 0.0f, 0.0f};
  if (m < M) {
    p[0] = points[3 * m];
    p[1] = points[3 * m + 1];
    p[2] = points[3 * m + 2];
  }
  if (dc != nullptr) {
    float t[3] = {0.0f, 0.0f, 0.0f};
    if (in_range && kf >= 0) {
      const float* Eo = E + 18 * idx;
      const float* dk = dc + 6 * kf;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        float s = Eo[j] * dk[0];
#pragma unroll
        for (int c = 1; c < 6; ++c) s = s + Eo[3 * c + j] * dk[c];
        t[j] = s;
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) t[j] = group_sum(t[j]);
    if (pv) {
      const float rhs[3] = {b_l[3 * m] + t[0], b_l[3 * m + 1] + t[1],
                            b_l[3 * m + 2] + t[2]};
      const float* Di = Dinv + 9 * m;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        p[i] = p[i] + -(Di[3 * i] * rhs[0] + Di[3 * i + 1] * rhs[1] +
                        Di[3 * i + 2] * rhs[2]);
      }
    }
    if (m < M && o == 0) {
#pragma unroll
      for (int i = 0; i < 3; ++i) points_n[3 * m + i] = p[i];
    }
  }
  float contrib = 0.0f;
  if (in_range) {
    bool inl = false;
    if (kf >= 0 && pv) {
      const float* uvr = obs_uvr + 3 * idx;
      float r[3], pc[3];
      project(poses + 16 * kf, p, uvr, cam, r, pc);
      const float chi2 = chi2_of(r, obs_sigma2[idx]);
      const float d2 = uvr[2] >= 0.0f ? kChi2Stereo : kChi2Mono;
      if (obs_mask[idx]) contrib = rho(chi2, huber, d2);
      inl = obs_valid[idx] && chi2 <= d2;
    }
    inlier[idx] = inl;
  }
  // block sum in a fixed order, then the last block sums the partials
  contrib = warp_sum(contrib);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = contrib;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) s += warp_part[w];
    partial[blockIdx.x] = s;
    __threadfence();
    is_last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (is_last && threadIdx.x == 0) {
    const volatile float* vp = partial;
    float s = 0.0f;
    for (unsigned b = 0; b < gridDim.x; ++b) s += vp[b];
    cost[0] = s;
  }
}

// ---------------------------------------------------------------------------
// H: accept or reject the trial step
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(1024)
ba_accept_kernel(const float* __restrict__ cost_n,
                 const float* __restrict__ poses_n,
                 const float* __restrict__ points_n, float* cost, float* lam,
                 float* poses, float* points, int K, int M) {
  const float cn = cost_n[0];
  const float c = cost[0];
  const bool accept = cn < c;   // false for a NaN trial cost
  __syncthreads();
  if (accept) {
    for (int t = threadIdx.x; t < 16 * K; t += blockDim.x) poses[t] = poses_n[t];
    for (int t = threadIdx.x; t < 3 * M; t += blockDim.x) points[t] = points_n[t];
  }
  if (threadIdx.x == 0) {
    cost[0] = accept ? cn : c;
    lam[0] = accept ? lam[0] * 0.5f : lam[0] * 4.0f;
  }
}

int blocks_for(int M) { return (M + kLandmarksPerBlock - 1) / kLandmarksPerBlock; }

}  // namespace

// Bytes of osl_ba_linearize's work buffer.
OSL_EXPORT int osl_ba_linearize_work_bytes(int K, int M, int O) {
  const long long n_obs = static_cast<long long>(M) * O;
  const long long n_sums = 36LL * K * K + 6LL * K;
  return static_cast<int>(12 * n_sums + 16LL * K + 4 * 61 * n_obs);
}

OSL_EXPORT int osl_ba_linearize(const float* poses, const float* points,
                                const uint8_t* point_valid, const int* obs_kf,
                                const float* obs_uvr, const float* obs_sigma2,
                                const uint8_t* obs_mask, const float* lam,
                                int K, int M, int O, float fx, float fy,
                                float cx, float cy, float bf, int huber,
                                void* work, float* S, float* b_S, float* E,
                                float* Dinv, float* b_l, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // work (osl_ba_linearize_work_bytes): each entry's 64-bit sum and marks,
  // each camera's four maxima (these three zeroed here), then each
  // observation's E D^-1 (18), Jp^T w Jp (36), b_S term (6) and counted
  // camera
  const size_t n_obs = static_cast<size_t>(M) * O;
  const int n_sums = 36 * K * K + 6 * K;
  unsigned long long* acc = static_cast<unsigned long long*>(work);
  int* marks = reinterpret_cast<int*>(acc + n_sums);
  int* cam_max = marks + n_sums;
  float* ED = reinterpret_cast<float*>(cam_max + 4 * K);
  float* Hd = ED + 18 * n_obs;
  float* bo = Hd + 36 * n_obs;
  int* act = reinterpret_cast<int*>(bo + 6 * n_obs);
  cudaMemsetAsync(work, 0, (12 * static_cast<size_t>(n_sums) + 16 * K), st);
  if (M > 0) {
    ba_linearize_kernel<<<blocks_for(M), kThreads, 0, st>>>(
        poses, points, point_valid, obs_kf, obs_uvr, obs_sigma2, obs_mask, lam,
        M, O, Cam{fx, fy, cx, cy, bf}, huber, E, Dinv, b_l, ED, Hd, bo, act,
        cam_max);
    ba_linearize_pairs_kernel<<<blocks_for(M), kThreads, 0, st>>>(
        M, O, K, act, E, ED, Hd, bo, cam_max, acc, marks);
  }
  if (K > 0) {
    ba_linearize_sum_kernel<<<(n_sums + kSumThreads - 1) / kSumThreads,
                              kSumThreads, 0, st>>>(K, cam_max, acc, marks, S,
                                                    b_S);
  }
  return static_cast<int>(cudaGetLastError());
}

OSL_EXPORT int osl_ba_solve(const float* S, const float* b_S,
                            const uint8_t* opt_mask, const float* lam,
                            const float* poses, int K, float* work, float* dc,
                            float* poses_n, void* stream) {
  const int n = 6 * K;
  const int n_panels = (n + kPanel - 1) / kPanel;
  const int smem = static_cast<int>(sizeof(float)) *
                   (kPanel * (n + 1) + n_panels * kPanel * (kPanel + 1));
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(ba_solve_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  ba_solve_kernel<<<1, kSolveThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      S, b_S, opt_mask, lam, poses, K, work, dc, poses_n);
  return static_cast<int>(cudaGetLastError());
}

OSL_EXPORT int osl_ba_update_cost(
    const float* poses, const float* points, const uint8_t* point_valid,
    const int* obs_kf, const float* obs_uvr, const float* obs_sigma2,
    const uint8_t* obs_valid, const uint8_t* obs_mask, const float* dc,
    const float* E, const float* Dinv, const float* b_l, int K, int M, int O,
    float fx, float fy, float cx, float cy, float bf, int huber,
    float* points_n, float* cost, uint8_t* inlier, float* scratch,
    void* stream) {
  (void)K;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_blocks = blocks_for(M);
  if (n_blocks == 0) {
    cudaMemsetAsync(cost, 0, sizeof(float), st);
    return static_cast<int>(cudaGetLastError());
  }
  // scratch: one partial per block, then the completion counter
  unsigned* done = reinterpret_cast<unsigned*>(scratch + n_blocks);
  cudaMemsetAsync(done, 0, sizeof(unsigned), st);
  ba_update_cost_kernel<<<n_blocks, kThreads, 0, st>>>(
      poses, points, point_valid, obs_kf, obs_uvr, obs_sigma2, obs_valid,
      obs_mask, dc, E, Dinv, b_l, M, O, Cam{fx, fy, cx, cy, bf}, huber,
      points_n, cost, inlier, scratch, done);
  return static_cast<int>(cudaGetLastError());
}

OSL_EXPORT int osl_ba_accept(const float* cost_n, const float* poses_n,
                             const float* points_n, float* cost, float* lam,
                             float* poses, float* points, int K, int M,
                             void* stream) {
  ba_accept_kernel<<<1, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
      cost_n, poses_n, points_n, cost, lam, poses, points, K, M);
  return static_cast<int>(cudaGetLastError());
}
