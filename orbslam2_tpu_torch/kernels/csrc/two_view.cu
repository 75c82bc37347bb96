// Kernel X: the monocular two-view initializer, four launches.
//
// Replaces orbslam2_tpu/ops/initializer.py: initialize_two_view (the
// Initializer's H/F RANSAC, model selection, decomposition and CheckRT),
// stage by stage as ops/initializer.py writes them:
//   X1 hypotheses: a block per hypothesis (200 H, 200 F). Thread 0 builds
//      the normalized minimal system (16 DLT rows for H, 8 for F), its 9x9
//      normal matrix, and takes the eigenvector of the smallest eigenvalue by
//      cyclic Jacobi sweeps in double (the reference: eigh); for F it removes
//      the smallest singular value (F - (F v3) v3^T, v3 from a 3x3 Jacobi of
//      F^T F: the reference's rank-2 SVD); then denormalizes. The block
//      scores all N correspondences by symmetric transfer error in the plain
//      version's float32 operations and reduces the score.
//   X2 refine: one block takes the best H and F (first on ties), their
//      inlier masks, the weighted all-inlier normal matrices (a thread per
//      entry, summed over N in double), the refits as in X1, RH = SH /
//      (SH + SF) > 0.40, and decomposes the chosen model: Faugeras' 8 (R, t)
//      for H, 4 (twice) for E = K^T F K; each SVD is a 3x3 Jacobi of A^T A
//      in double (U = A V / s; for E, u3 = u1 x u2 and v3 = v1 x v2).
//   X3 check: a block per candidate: the DLT of kernel S (osl::dlt, the
//      unrolled 4x4 Cholesky) for every correspondence, cheirality, the
//      4 sigma^2 reprojection gates, parallax < 0.99998, the good count, and
//      the 50th-smallest parallax of the good points by a bitonic sort of the
//      block's parallaxes in shared memory.
//   X4 select: one block takes the best and second-best counts (first on
//      ties) and the success gates, and writes [success, used_homography,
//      T21 (16), points3d (3N), good (N)] into one buffer for one copy.
//
// Bound on the H100: operations, and far from it: the work is 400 small
// eigen-solves and 400 x N transfer errors, serial inside a thread, so the
// kernel is latency-bound; 10 launches' worth of it would not fill the card.
// The SVDs come out with other signs than the library's: the candidate sets
// are the same poses (checked in the tests), and CheckRT picks among them.
// SVD, Jacobi and normal matrices run in double, the scoring, DLT and gates
// in float32, so the result agrees with the plain version within the
// tolerance of its float32 eigen-solves, not bit for bit.
#include "common.cuh"

namespace {

constexpr int kIters = 200;      // initializer.N_ITERS
constexpr float kThH = 5.991f;   // TH_H
constexpr float kThF = 3.841f;   // TH_F
constexpr float kThScore = 5.991f;
constexpr int kMaxN = 8192;      // correspondences the check keeps in shared memory

using osl::block_sum;
using osl::jacobi;

// The eigenvector of the smallest eigenvalue of the 9x9 normal matrix A.
__device__ void smallest_eigvec9(double (&A)[9][9], double (&out)[3][3]) {
  double V[9][9];
  jacobi<9>(A, V);
  int k = 0;
  for (int i = 1; i < 9; ++i) k = A[i][i] < A[k][k] ? i : k;
  for (int i = 0; i < 9; ++i) out[i / 3][i % 3] = V[i][k];
}

__device__ void matmul3(const double (&A)[3][3], const double (&B)[3][3],
                        double (&C)[3][3]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[i][j] = A[i][0] * B[0][j] + A[i][1] * B[1][j] + A[i][2] * B[2][j];
}

__device__ double det3(const double (&A)[3][3]) {
  return A[0][0] * (A[1][1] * A[2][2] - A[1][2] * A[2][1]) -
         A[0][1] * (A[1][0] * A[2][2] - A[1][2] * A[2][0]) +
         A[0][2] * (A[1][0] * A[2][1] - A[1][1] * A[2][0]);
}

__device__ void inv3(const double (&A)[3][3], double (&B)[3][3]) {
  const double d = det3(A);
  B[0][0] = (A[1][1] * A[2][2] - A[1][2] * A[2][1]) / d;
  B[0][1] = (A[0][2] * A[2][1] - A[0][1] * A[2][2]) / d;
  B[0][2] = (A[0][1] * A[1][2] - A[0][2] * A[1][1]) / d;
  B[1][0] = (A[1][2] * A[2][0] - A[1][0] * A[2][2]) / d;
  B[1][1] = (A[0][0] * A[2][2] - A[0][2] * A[2][0]) / d;
  B[1][2] = (A[0][2] * A[1][0] - A[0][0] * A[1][2]) / d;
  B[2][0] = (A[1][0] * A[2][1] - A[1][1] * A[2][0]) / d;
  B[2][1] = (A[0][1] * A[2][0] - A[0][0] * A[2][1]) / d;
  B[2][2] = (A[0][0] * A[1][1] - A[0][1] * A[1][0]) / d;
}

__device__ void cross3(const double* a, const double* b, double* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ void unit3(double* a) {
  const double n = sqrt(a[0] * a[0] + a[1] * a[1] + a[2] * a[2]);
  const double d = n > 1e-300 ? n : 1e-300;
  a[0] /= d;
  a[1] /= d;
  a[2] /= d;
}

// Right singular vectors (columns of V, by descending singular value) and
// singular values of A, from a Jacobi eigen-decomposition of A^T A.
__device__ void svd3_right(const double (&A)[3][3], double (&V)[3][3],
                           double (&s)[3]) {
  double G[3][3], W[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      G[i][j] = A[0][i] * A[0][j] + A[1][i] * A[1][j] + A[2][i] * A[2][j];
  jacobi<3>(G, W);
  int idx[3] = {0, 1, 2};
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (G[idx[j]][idx[j]] > G[idx[i]][idx[i]]) {
        const int t = idx[i];
        idx[i] = idx[j];
        idx[j] = t;
      }
  for (int k = 0; k < 3; ++k) {
    const double l = G[idx[k]][idx[k]];
    s[k] = sqrt(l > 0.0 ? l : 0.0);
    for (int i = 0; i < 3; ++i) V[i][k] = W[i][idx[k]];
  }
}

// u = A v / |A v| for column k of V
__device__ void left_vec(const double (&A)[3][3], const double (&V)[3][3],
                         int k, double* u) {
  for (int i = 0; i < 3; ++i)
    u[i] = A[i][0] * V[0][k] + A[i][1] * V[1][k] + A[i][2] * V[2][k];
  unit3(u);
}

// F - (F v3) v3^T: the rank-2 projection of the reference's SVD
__device__ void rank2(double (&F)[3][3]) {
  double V[3][3], s[3];
  svd3_right(F, V, s);
  for (int i = 0; i < 3; ++i) {
    const double fv = F[i][0] * V[0][2] + F[i][1] * V[1][2] + F[i][2] * V[2][2];
    for (int j = 0; j < 3; ++j) F[i][j] -= fv * V[j][2];
  }
}

struct Norm {
  float m1x, m1y, s1x, s1y, m2x, m2y, s2x, s2y;
};

// initializer.normalize_points for both views
__device__ Norm block_normalize(const float* x1, const float* x2,
                                const uint8_t* valid, int N, double* scratch) {
  double n = 0.0, a = 0.0, b = 0.0, c = 0.0, d = 0.0;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    if (!valid[i]) continue;
    n += 1.0;
    a += x1[2 * i];
    b += x1[2 * i + 1];
    c += x2[2 * i];
    d += x2[2 * i + 1];
  }
  n = block_sum(n, scratch);
  const double nn = n > 1.0 ? n : 1.0;
  Norm r;
  r.m1x = static_cast<float>(block_sum(a, scratch) / nn);
  r.m1y = static_cast<float>(block_sum(b, scratch) / nn);
  r.m2x = static_cast<float>(block_sum(c, scratch) / nn);
  r.m2y = static_cast<float>(block_sum(d, scratch) / nn);
  a = b = c = d = 0.0;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    if (!valid[i]) continue;
    a += fabsf(x1[2 * i] - r.m1x);
    b += fabsf(x1[2 * i + 1] - r.m1y);
    c += fabsf(x2[2 * i] - r.m2x);
    d += fabsf(x2[2 * i + 1] - r.m2y);
  }
  r.s1x = 1.0f / fmaxf(static_cast<float>(block_sum(a, scratch) / nn), 1e-8f);
  r.s1y = 1.0f / fmaxf(static_cast<float>(block_sum(b, scratch) / nn), 1e-8f);
  r.s2x = 1.0f / fmaxf(static_cast<float>(block_sum(c, scratch) / nn), 1e-8f);
  r.s2y = 1.0f / fmaxf(static_cast<float>(block_sum(d, scratch) / nn), 1e-8f);
  return r;
}

// The DLT rows of one normalized correspondence: H's two, or F's one (in r1)
__device__ void dlt_rows(bool is_h, float u1, float v1, float u2, float v2,
                         float* r1, float* r2) {
  if (is_h) {
    const float a[9] = {0.0f, 0.0f, 0.0f, -u1, -v1, -1.0f, v2 * u1, v2 * v1, v2};
    const float b[9] = {u1, v1, 1.0f, 0.0f, 0.0f, 0.0f, -u2 * u1, -u2 * v1, -u2};
    for (int k = 0; k < 9; ++k) {
      r1[k] = a[k];
      r2[k] = b[k];
    }
  } else {
    const float a[9] = {u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, 1.0f};
    for (int k = 0; k < 9; ++k) {
      r1[k] = a[k];
      r2[k] = 0.0f;
    }
  }
}

// The 9x9 solution, denormalized: H21 = T2^-1 Hn T1, F21 = T2^T Fn T1
__device__ void solve_and_denormalize(bool is_h, double (&A)[9][9],
                                      const Norm& nm, float* out) {
  double M[3][3];
  smallest_eigvec9(A, M);
  if (!is_h) rank2(M);
  const double T1[3][3] = {{nm.s1x, 0.0, -nm.m1x * nm.s1x},
                           {0.0, nm.s1y, -nm.m1y * nm.s1y},
                           {0.0, 0.0, 1.0}};
  const float t2x = -nm.m2x * nm.s2x, t2y = -nm.m2y * nm.s2y;
  double L[3][3];
  if (is_h) {
    const double Ti[3][3] = {{1.0 / nm.s2x, 0.0, -t2x / (double)nm.s2x},
                             {0.0, 1.0 / nm.s2y, -t2y / (double)nm.s2y},
                             {0.0, 0.0, 1.0}};
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) L[i][j] = Ti[i][j];
  } else {
    const double Tt[3][3] = {{nm.s2x, 0.0, 0.0}, {0.0, nm.s2y, 0.0},
                             {t2x, t2y, 1.0}};
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) L[i][j] = Tt[i][j];
  }
  double LM[3][3], R[3][3];
  matmul3(L, M, LM);
  matmul3(LM, T1, R);
  for (int i = 0; i < 9; ++i) out[i] = static_cast<float>(R[i / 3][i % 3]);
}

// score_homography's transfer error of a -> b under H (float32, as the plain
// version)
__device__ __forceinline__ float transfer(const float* H, float ax, float ay,
                                          float bx, float by) {
  const float w = H[6] * ax + H[7] * ay + H[8];
  const float iw = 1.0f / (fabsf(w) < 1e-8f ? 1e-8f : w);
  const float u = (H[0] * ax + H[1] * ay + H[2]) * iw;
  const float v = (H[3] * ax + H[4] * ay + H[5]) * iw;
  const float du = u - bx, dv = v - by;
  return (du * du + dv * dv) * 1.0f;
}

// score_fundamental's line error of b against the line F a (float32);
// ``tr`` reads F transposed
__device__ __forceinline__ float line_chi2(const float* F, bool tr, float ax,
                                           float ay, float bx, float by) {
  const float f00 = F[0], f01 = tr ? F[3] : F[1], f02 = tr ? F[6] : F[2];
  const float f10 = tr ? F[1] : F[3], f11 = F[4], f12 = tr ? F[7] : F[5];
  const float f20 = tr ? F[2] : F[6], f21 = tr ? F[5] : F[7], f22 = F[8];
  const float l0 = f00 * ax + f01 * ay + f02;
  const float l1 = f10 * ax + f11 * ay + f12;
  const float l2 = f20 * ax + f21 * ay + f22;
  const float num = l0 * bx + l1 * by + l2;
  return (num * num) / osl::clamp_min(l0 * l0 + l1 * l1, 1e-12f) * 1.0f;
}

__device__ void inverse_f(const float* H, float* Hi) {
  double A[3][3], B[3][3];
  for (int i = 0; i < 9; ++i) A[i / 3][i % 3] = H[i];
  inv3(A, B);
  for (int i = 0; i < 9; ++i) Hi[i] = static_cast<float>(B[i / 3][i % 3]);
}

// Both directions' errors of correspondence i under the model; returns the
// two score terms through s1, s2 and whether both are inliers.
__device__ __forceinline__ bool score_point(bool is_h, const float* M,
                                            const float* Mi, float x1x,
                                            float x1y, float x2x, float x2y,
                                            float& s1, float& s2) {
  if (is_h) {
    const float c21 = transfer(M, x1x, x1y, x2x, x2y);
    const float c12 = transfer(Mi, x2x, x2y, x1x, x1y);
    const bool in1 = c21 < kThH, in2 = c12 < kThH;
    s1 = in1 ? kThH - c21 : 0.0f;
    s2 = in2 ? kThH - c12 : 0.0f;
    return in1 && in2;
  }
  const float c2 = line_chi2(M, false, x1x, x1y, x2x, x2y);
  const float c1 = line_chi2(M, true, x2x, x2y, x1x, x1y);
  const bool in2 = c2 < kThF, in1 = c1 < kThF;
  s1 = in2 ? kThScore - c2 : 0.0f;
  s2 = in1 ? kThScore - c1 : 0.0f;
  return in1 && in2;
}

__global__ void __launch_bounds__(256) two_view_hypotheses_kernel(
    const float* __restrict__ x1, const float* __restrict__ x2,
    const uint8_t* __restrict__ valid, int N, const int* __restrict__ samples,
    float* __restrict__ hyp, float* __restrict__ scores) {
  __shared__ double scratch[32];
  __shared__ float M[9], Mi[9];
  const int b = blockIdx.x;
  const bool is_h = b < kIters;
  const int it = is_h ? b : b - kIters;
  const Norm nm = block_normalize(x1, x2, valid, N, scratch);
  if (threadIdx.x == 0) {
    double A[9][9];
    for (int p = 0; p < 9; ++p)
      for (int q = 0; q < 9; ++q) A[p][q] = 0.0;
    for (int k = 0; k < 8; ++k) {
      const int i = samples[8 * it + k];
      float r1[9], r2[9];
      dlt_rows(is_h, (x1[2 * i] - nm.m1x) * nm.s1x, (x1[2 * i + 1] - nm.m1y) * nm.s1y,
               (x2[2 * i] - nm.m2x) * nm.s2x, (x2[2 * i + 1] - nm.m2y) * nm.s2y, r1, r2);
      for (int p = 0; p < 9; ++p)
        for (int q = 0; q < 9; ++q)
          A[p][q] += (double)r1[p] * r1[q] + (double)r2[p] * r2[q];
    }
    solve_and_denormalize(is_h, A, nm, M);
    if (is_h) inverse_f(M, Mi);
    for (int k = 0; k < 9; ++k) hyp[9 * b + k] = M[k];
  }
  __syncthreads();
  double a1 = 0.0, a2 = 0.0;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    if (!valid[i]) continue;
    float s1, s2;
    score_point(is_h, M, Mi, x1[2 * i], x1[2 * i + 1], x2[2 * i], x2[2 * i + 1], s1, s2);
    a1 += s1;
    a2 += s2;
  }
  const double total = block_sum(a1, scratch) + block_sum(a2, scratch);
  if (threadIdx.x == 0) scores[b] = static_cast<float>(total);
}

// (p, q) of upper-triangle entry e of a 9x9 matrix
__device__ void tri_entry(int e, int& p, int& q) {
  p = 0;
  while (e >= 9 - p) {
    e -= 9 - p;
    ++p;
  }
  q = p + e;
}

__device__ bool better(float s, float b) {
  return (isnan(s) && !isnan(b)) || s > b;  // argmax: NaN first, then max
}

// decompose_essential: 4 (R, t), written twice
__device__ void decompose_e(const double (&E)[3][3], float* cand) {
  double V[3][3], s[3], u1[3], u2[3], u3[3], v1[3], v2[3], v3[3];
  svd3_right(E, V, s);
  left_vec(E, V, 0, u1);
  left_vec(E, V, 1, u2);
  cross3(u1, u2, u3);
  for (int i = 0; i < 3; ++i) {
    v1[i] = V[i][0];
    v2[i] = V[i][1];
  }
  cross3(v1, v2, v3);
  double R1[3][3], R2[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const double a = u2[i] * v1[j] - u1[i] * v2[j];
      const double c = u3[i] * v3[j];
      R1[i][j] = a + c;
      R2[i][j] = -a + c;
    }
  unit3(u3);
  for (int h = 0; h < 8; ++h) {
    const double* R = (h % 4) < 2 ? &R1[0][0] : &R2[0][0];
    const double sg = (h % 2) == 0 ? 1.0 : -1.0;
    for (int k = 0; k < 9; ++k) cand[12 * h + k] = static_cast<float>(R[k]);
    for (int k = 0; k < 3; ++k) cand[12 * h + 9 + k] = static_cast<float>(sg * u3[k]);
  }
}

// decompose_homography: Faugeras' 8 (R, t) of A = K^-1 H K
__device__ void decompose_h(const double (&A)[3][3], float* cand) {
  double V[3][3], s[3], U[3][3];
  svd3_right(A, V, s);
  for (int k = 0; k < 3; ++k) {
    double u[3];
    left_vec(A, V, k, u);
    for (int i = 0; i < 3; ++i) U[i][k] = u[i];
  }
  const double sg = det3(U) * det3(V);
  const double d1 = s[0], d2 = s[1], d3 = s[2];
  const double den13 = fmax(d1 * d1 - d3 * d3, 1e-12);
  const double x1 = sqrt(fmax((d1 * d1 - d2 * d2) / den13, 0.0));
  const double x3 = sqrt(fmax((d2 * d2 - d3 * d3) / den13, 0.0));
  const double root = sqrt(fmax((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0));
  const double e1[4] = {1.0, -1.0, 1.0, -1.0};
  const double e3[4] = {1.0, 1.0, -1.0, -1.0};
  const double stheta = root / fmax((d1 + d3) * d2, 1e-12);
  const double ctheta = (d2 * d2 + d1 * d3) / fmax((d1 + d3) * d2, 1e-12);
  const double sphi = root / fmax((d1 - d3) * d2, 1e-12);
  const double cphi = (d1 * d3 - d2 * d2) / fmax((d1 - d3) * d2, 1e-12);
  for (int h = 0; h < 8; ++h) {
    const int k = h % 4;
    double Rp[3][3], tp[3];
    if (h < 4) {  // d' = d2
      const double st = e1[k] * e3[k] * stheta;
      const double R0[3][3] = {{ctheta, 0.0, -st}, {0.0, 1.0, 0.0}, {st, 0.0, ctheta}};
      for (int i = 0; i < 9; ++i) Rp[i / 3][i % 3] = R0[i / 3][i % 3];
      tp[0] = e1[k] * x1 * (d1 - d3);
      tp[1] = 0.0;
      tp[2] = -e3[k] * x3 * (d1 - d3);
    } else {      // d' = -d2
      const double sp = e1[k] * e3[k] * sphi;
      const double R0[3][3] = {{cphi, 0.0, sp}, {0.0, -1.0, 0.0}, {sp, 0.0, -cphi}};
      for (int i = 0; i < 9; ++i) Rp[i / 3][i % 3] = R0[i / 3][i % 3];
      tp[0] = e1[k] * x1 * (d1 + d3);
      tp[1] = 0.0;
      tp[2] = e3[k] * x3 * (d1 + d3);
    }
    double URp[3][3], Vt[3][3], R[3][3];
    matmul3(U, Rp, URp);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) Vt[i][j] = V[j][i];
    matmul3(URp, Vt, R);
    double t[3];
    for (int i = 0; i < 3; ++i) t[i] = U[i][0] * tp[0] + U[i][1] * tp[1] + U[i][2] * tp[2];
    const double n = sqrt(t[0] * t[0] + t[1] * t[1] + t[2] * t[2]);
    for (int i = 0; i < 3; ++i) t[i] /= fmax(n, 1e-12);
    for (int i = 0; i < 9; ++i) cand[12 * h + i] = static_cast<float>(sg * R[i / 3][i % 3]);
    for (int i = 0; i < 3; ++i) cand[12 * h + 9 + i] = static_cast<float>(t[i]);
  }
}

__global__ void __launch_bounds__(256) two_view_refine_kernel(
    const float* __restrict__ x1, const float* __restrict__ x2,
    const uint8_t* __restrict__ valid, int N, const float* __restrict__ hyp,
    const float* __restrict__ scores, float fx, float fy, float cx, float cy,
    float* __restrict__ cand, float* __restrict__ meta) {
  __shared__ double scratch[32];
  __shared__ double AtA[2][45];
  __shared__ float Hb[9], Hbi[9], Fb[9];
  __shared__ uint8_t w[2][kMaxN];
  __shared__ int best[2];
  const Norm nm = block_normalize(x1, x2, valid, N, scratch);
  if (threadIdx.x == 0) {
    int bh = 0, bf = 0;
    for (int k = 1; k < kIters; ++k) {
      bh = better(scores[k], scores[bh]) ? k : bh;
      bf = better(scores[kIters + k], scores[kIters + bf]) ? k : bf;
    }
    best[0] = bh;
    best[1] = bf;
    for (int k = 0; k < 9; ++k) {
      Hb[k] = hyp[9 * bh + k];
      Fb[k] = hyp[9 * (kIters + bf) + k];
    }
    inverse_f(Hb, Hbi);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    float s1, s2;
    const float a = x1[2 * i], b = x1[2 * i + 1], c = x2[2 * i], d = x2[2 * i + 1];
    w[0][i] = valid[i] && score_point(true, Hb, Hbi, a, b, c, d, s1, s2);
    w[1][i] = valid[i] && score_point(false, Fb, nullptr, a, b, c, d, s1, s2);
  }
  __syncthreads();
  if (threadIdx.x < 90) {  // one upper-triangle entry of one model's matrix
    const int m = threadIdx.x / 45;
    int p, q;
    tri_entry(threadIdx.x % 45, p, q);
    double acc = 0.0;
    for (int i = 0; i < N; ++i) {
      if (!w[m][i]) continue;
      float r1[9], r2[9];
      dlt_rows(m == 0, (x1[2 * i] - nm.m1x) * nm.s1x, (x1[2 * i + 1] - nm.m1y) * nm.s1y,
               (x2[2 * i] - nm.m2x) * nm.s2x, (x2[2 * i + 1] - nm.m2y) * nm.s2y, r1, r2);
      acc += (double)r1[p] * r1[q] + (double)r2[p] * r2[q];
    }
    AtA[m][threadIdx.x % 45] = acc;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  float Hr[9], Fr[9];
  for (int m = 0; m < 2; ++m) {
    double A[9][9];
    for (int e = 0; e < 45; ++e) {
      int p, q;
      tri_entry(e, p, q);
      A[p][q] = A[q][p] = AtA[m][e];
    }
    solve_and_denormalize(m == 0, A, nm, m == 0 ? Hr : Fr);
  }
  const float SH = scores[best[0]], SF = scores[kIters + best[1]];
  const bool use_h = SH / osl::clamp_min(SH + SF, 1e-12f) > 0.40f;
  const double Ki[3][3] = {{1.0 / fx, 0.0, -cx / (double)fx},
                           {0.0, 1.0 / fy, -cy / (double)fy},
                           {0.0, 0.0, 1.0}};
  const double K[3][3] = {{fx, 0.0, cx}, {0.0, fy, cy}, {0.0, 0.0, 1.0}};
  double M[3][3], T[3][3], A[3][3];
  if (use_h) {
    for (int i = 0; i < 9; ++i) M[i / 3][i % 3] = Hr[i];
    matmul3(Ki, M, T);
    matmul3(T, K, A);
    decompose_h(A, cand);
  } else {
    double Kt[3][3];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) Kt[i][j] = K[j][i];
    for (int i = 0; i < 9; ++i) M[i / 3][i % 3] = Fr[i];
    matmul3(Kt, M, T);
    matmul3(T, K, A);
    decompose_e(A, cand);
  }
  meta[0] = use_h ? 1.0f : 0.0f;
  meta[1] = SH;
  meta[2] = SF;
  meta[3] = static_cast<float>(best[0]);
  meta[4] = static_cast<float>(best[1]);
  for (int h = 0; h < 8; ++h) meta[5 + h] = (use_h || h < 4) ? 1.0f : 0.0f;
  for (int k = 0; k < 9; ++k) {
    meta[13 + k] = Hr[k];
    meta[22 + k] = Fr[k];
  }
}

__global__ void __launch_bounds__(256) two_view_check_kernel(
    const float* __restrict__ x1, const float* __restrict__ x2,
    const uint8_t* __restrict__ valid, int N, float fx, float fy, float cx,
    float cy, const float* __restrict__ cand, const float* __restrict__ meta,
    float* __restrict__ X_out, uint8_t* __restrict__ good_out,
    int* __restrict__ n_good, float* __restrict__ parallax) {
  __shared__ float P1[12], P2[12], Rt[12];
  __shared__ float keys[kMaxN];
  __shared__ int count;
  const int h = blockIdx.x;
  if (threadIdx.x == 0) {
    for (int k = 0; k < 12; ++k) Rt[k] = cand[12 * h + k];
    const float P1v[12] = {fx, 0.0f, cx, 0.0f, 0.0f, fy, cy, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f};
    for (int k = 0; k < 12; ++k) P1[k] = P1v[k];
    for (int j = 0; j < 4; ++j) {  // K [R | t], row by row
      const float c0 = j < 3 ? Rt[j] : Rt[9];
      const float c1 = j < 3 ? Rt[3 + j] : Rt[10];
      const float c2 = j < 3 ? Rt[6 + j] : Rt[11];
      P2[j] = fx * c0 + 0.0f * c1 + cx * c2;
      P2[4 + j] = 0.0f * c0 + fy * c1 + cy * c2;
      P2[8 + j] = 0.0f * c0 + 0.0f * c1 + 1.0f * c2;
    }
    count = 0;
  }
  __syncthreads();
  int np2 = 1;
  while (np2 < N) np2 <<= 1;
  const float* R = Rt;
  const float* t = Rt + 9;
  for (int i = threadIdx.x; i < np2; i += blockDim.x) {
    if (i >= N) {
      keys[i] = INFINITY;
      continue;
    }
    const float u1 = x1[2 * i], v1 = x1[2 * i + 1];
    const float u2 = x2[2 * i], v2 = x2[2 * i + 1];
    float X[3];
    osl::dlt(P1, P2, u1, v1, u2, v2, X);
    const bool finite = isfinite(X[0]) && isfinite(X[1]) && isfinite(X[2]);
    float O2[3], n2[3];
    for (int c = 0; c < 3; ++c) O2[c] = -(R[c] * t[0] + R[3 + c] * t[1] + R[6 + c] * t[2]);
    for (int c = 0; c < 3; ++c) n2[c] = X[c] - O2[c];
    const float d1 = sqrtf(X[0] * X[0] + X[1] * X[1] + X[2] * X[2]);
    const float d2 = sqrtf(n2[0] * n2[0] + n2[1] * n2[1] + n2[2] * n2[2]);
    const float cos_par = (X[0] * n2[0] + X[1] * n2[1] + X[2] * n2[2]) /
                          osl::clamp_min(d1 * d2, 1e-12f);
    const float z2 = R[6] * X[0] + R[7] * X[1] + R[8] * X[2] + t[2];
    float e[2];
    for (int v = 0; v < 2; ++v) {
      const float* P = v ? P2 : P1;
      const float px = P[0] * X[0] + P[1] * X[1] + P[2] * X[2] + P[3];
      const float py = P[4] * X[0] + P[5] * X[1] + P[6] * X[2] + P[7];
      float pw = P[8] * X[0] + P[9] * X[1] + P[10] * X[2] + P[11];
      pw = fabsf(pw) < 1e-8f ? 1e-8f : pw;
      const float du = px / pw - (v ? u2 : u1);
      const float dv = py / pw - (v ? v2 : v1);
      e[v] = du * du + dv * dv;
    }
    const bool good = valid[i] && finite && X[2] > 0.0f && z2 > 0.0f &&
                      e[0] < 4.0f && e[1] < 4.0f && cos_par < 0.99998f;
    for (int c = 0; c < 3; ++c) X_out[(static_cast<size_t>(h) * N + i) * 3 + c] = X[c];
    good_out[static_cast<size_t>(h) * N + i] = good ? 1 : 0;
    const float cl = fminf(fmaxf(cos_par, -1.0f), 1.0f);
    keys[i] = good ? acosf(cl) * 57.29577951308232f : 1e9f;
    if (good) atomicAdd(&count, 1);
  }
  __syncthreads();
  for (int size = 2; size <= np2; size <<= 1) {  // bitonic sort, ascending
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int k = threadIdx.x; k < np2 / 2; k += blockDim.x) {
        const int lo = 2 * stride * (k / stride) + (k % stride);
        const int hi = lo + stride;
        const bool asc = (lo & size) == 0;
        const float a = keys[lo], b = keys[hi];
        if ((a > b) == asc) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  if (threadIdx.x == 0) {
    const int ng = count;
    const int idx = ng - 1 < 0 ? 0 : (ng - 1 > 49 ? 49 : ng - 1);
    parallax[h] = keys[idx];
    n_good[h] = meta[5 + h] > 0.5f ? ng : -1;
  }
}

__global__ void __launch_bounds__(256) two_view_select_kernel(
    const uint8_t* __restrict__ valid, int N, const float* __restrict__ cand,
    const float* __restrict__ meta, const float* __restrict__ X,
    const uint8_t* __restrict__ good, const int* __restrict__ n_good,
    const float* __restrict__ parallax, float* __restrict__ out) {
  __shared__ double scratch[32];
  __shared__ int sel[2];
  double nv = 0.0;
  for (int i = threadIdx.x; i < N; i += blockDim.x) nv += valid[i] ? 1.0 : 0.0;
  const int n_valid = static_cast<int>(block_sum(nv, scratch));
  if (threadIdx.x == 0) {
    int bi = 0;
    for (int h = 1; h < 8; ++h) bi = n_good[h] > n_good[bi] ? h : bi;
    int second = -2147483647;
    for (int h = 0; h < 8; ++h)
      if (h != bi && n_good[h] > second) second = n_good[h];
    const int n_best = n_good[bi];
    int min_good = static_cast<int>(0.5f * static_cast<float>(n_valid));
    min_good = min_good < 50 ? 50 : min_good;  // MIN_TRIANGULATED
    const bool success = n_best >= min_good &&
                         static_cast<float>(second) < 0.75f * static_cast<float>(n_best) &&
                         parallax[bi] > 1.0f;  // MIN_PARALLAX_DEG
    sel[0] = bi;
    sel[1] = success;
    out[0] = success ? 1.0f : 0.0f;
    out[1] = meta[0];
    const float* rt = cand + 12 * bi;
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) out[2 + 4 * i + j] = rt[3 * i + j];
      out[2 + 4 * i + 3] = rt[9 + i];
    }
    out[14] = out[15] = out[16] = 0.0f;
    out[17] = 1.0f;
  }
  __syncthreads();
  const int bi = sel[0];
  const bool success = sel[1];
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const size_t r = static_cast<size_t>(bi) * N + i;
    for (int c = 0; c < 3; ++c) out[18 + 3 * i + c] = X[3 * r + c];
    out[18 + 3 * N + i] = (good[r] && success) ? 1.0f : 0.0f;
  }
}

}  // namespace

OSL_EXPORT int osl_two_view_hypotheses(const float* x1, const float* x2,
                                       const uint8_t* valid, int N,
                                       const int* samples, float* hyp,
                                       float* scores, void* stream) {
  if (N <= 0 || N > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  two_view_hypotheses_kernel<<<2 * kIters, 256, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      x1, x2, valid, N, samples, hyp, scores);
  return static_cast<int>(cudaGetLastError());
}

OSL_EXPORT int osl_two_view_refine(const float* x1, const float* x2,
                                   const uint8_t* valid, int N, const float* hyp,
                                   const float* scores, float fx, float fy,
                                   float cx, float cy, float* cand, float* meta,
                                   void* stream) {
  if (N <= 0 || N > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  two_view_refine_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x1, x2, valid, N, hyp, scores, fx, fy, cx, cy, cand, meta);
  return static_cast<int>(cudaGetLastError());
}

OSL_EXPORT int osl_two_view_check(const float* x1, const float* x2,
                                  const uint8_t* valid, int N, float fx,
                                  float fy, float cx, float cy,
                                  const float* cand, const float* meta,
                                  float* X, uint8_t* good, int* n_good,
                                  float* parallax, void* stream) {
  if (N <= 0 || N > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  two_view_check_kernel<<<8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x1, x2, valid, N, fx, fy, cx, cy, cand, meta, X, good, n_good, parallax);
  return static_cast<int>(cudaGetLastError());
}

OSL_EXPORT int osl_two_view_select(const uint8_t* valid, int N,
                                   const float* cand, const float* meta,
                                   const float* X, const uint8_t* good,
                                   const int* n_good, const float* parallax,
                                   float* out, void* stream) {
  if (N <= 0 || N > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  two_view_select_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      valid, N, cand, meta, X, good, n_good, parallax, out);
  return static_cast<int>(cudaGetLastError());
}
