// Kernel Z: EPnP RANSAC for relocalization, two launches.
//
// Replaces orbslam2_tpu/ops/pnp.py: pnp_ransac (with _epnp_weighted and
// ops/geometry.py: horn_align), as ops/pnp.py writes it:
//   Z1 hypotheses: a block per 4-point sample. Thread 0 solves the sample's
//      EPnP in double: the PCA control points (3x3 Jacobi, ascending, each
//      axis signed by its largest component as ops/pnp.pca does), the
//      barycentric coordinates (the 4x4 [Cw; 1] inverted by Gauss-Jordan),
//      the 12x12 M^T M and its 4 smallest eigenvectors (12x12 Jacobi), the
//      6 x 10 distance system and the three beta cases (ridge 1e-9 least
//      squares), 5 Gauss-Newton steps each (ridge 1e-6), the cheirality flip,
//      Horn's alignment (the largest eigenvector of the 4x4 N by Jacobi) and
//      the reprojection SSE; the lowest SSE wins (the first on ties). The
//      block then counts the chi2 < 5.991 inliers over all N in float32, the
//      camera-frame point written term by term, as the plain version.
//   Z2 refine: one block takes the hypothesis with the most inliers (the
//      first on ties, non-finite ones at -1), its inliers over N, the
//      weighted moments and the weighted 12x12 M^T M over N (a thread per
//      entry, summed over the rows in order, in double), the same EPnP solve
//      with block sums for the depth and SSE of each beta case, the recount,
//      the better of the two (the refine where it keeps at least as many
//      inliers), and writes [Tcw (16), n_inliers, ok, inliers (N)] into one
//      buffer for one copy to the host.
//
// Bound on the H100: operations, and far from it: 256 small eigen-solves
// and Gauss-Newton runs, serial inside one thread each, so the kernel is
// latency-bound (one wave of 256 single-thread solves), then 256 x N inlier
// tests. A minimal set's M^T M has a 4-dimensional null space, so its basis
// (and a hypothesis that Gauss-Newton has not brought to convergence) is the
// eigen-solver's choice: hypotheses agree with the plain version's where
// they converge, the chosen inliers and the refined pose within tolerance.
#include "common.cuh"

namespace {

constexpr float kChi2 = 5.991f;
constexpr int kGnIters = 5;
__constant__ int kPairI[6] = {0, 0, 0, 1, 1, 2};
__constant__ int kPairJ[6] = {1, 2, 3, 2, 3, 3};
__constant__ int kLI[10] = {0, 0, 1, 0, 1, 2, 0, 1, 2, 3};
__constant__ int kLJ[10] = {0, 1, 1, 2, 2, 2, 3, 3, 3, 3};

struct Cam {
  float fx, fy, cx, cy;
};

// x = A^-1 b by Gaussian elimination with partial pivoting (A is destroyed)
template <int n>
__device__ void solve_n(double (&A)[n][n], double (&b)[n], double (&x)[n]) {
  for (int c = 0; c < n; ++c) {
    int p = c;
    for (int r = c + 1; r < n; ++r) p = fabs(A[r][c]) > fabs(A[p][c]) ? r : p;
    if (p != c) {
      for (int k = 0; k < n; ++k) {
        const double t = A[c][k];
        A[c][k] = A[p][k];
        A[p][k] = t;
      }
      const double t = b[c];
      b[c] = b[p];
      b[p] = t;
    }
    for (int r = c + 1; r < n; ++r) {
      const double f = A[r][c] / A[c][c];
      for (int k = c; k < n; ++k) A[r][k] -= f * A[c][k];
      b[r] -= f * b[c];
    }
  }
  for (int r = n - 1; r >= 0; --r) {
    double s = b[r];
    for (int k = r + 1; k < n; ++k) s -= A[r][k] * x[k];
    x[r] = s / A[r][r];
  }
}

// The inverse of the 4x4 [Cw^T; 1] (Gauss-Jordan, partial pivoting)
__device__ void inverse4(const double (&A0)[4][4], double (&Ai)[4][4]) {
  double A[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      A[i][j] = A0[i][j];
      Ai[i][j] = i == j ? 1.0 : 0.0;
    }
  for (int c = 0; c < 4; ++c) {
    int p = c;
    for (int r = c + 1; r < 4; ++r) p = fabs(A[r][c]) > fabs(A[p][c]) ? r : p;
    for (int k = 0; k < 4; ++k) {
      double t = A[c][k];
      A[c][k] = A[p][k];
      A[p][k] = t;
      t = Ai[c][k];
      Ai[c][k] = Ai[p][k];
      Ai[p][k] = t;
    }
    const double d = A[c][c];
    for (int k = 0; k < 4; ++k) {
      A[c][k] /= d;
      Ai[c][k] /= d;
    }
    for (int r = 0; r < 4; ++r) {
      if (r == c) continue;
      const double f = A[r][c];
      for (int k = 0; k < 4; ++k) {
        A[r][k] -= f * A[c][k];
        Ai[r][k] -= f * Ai[c][k];
      }
    }
  }
}

// Indices of the diagonal of a (after Jacobi) in ascending order
template <int n>
__device__ void ascending(const double (&a)[n][n], int (&idx)[n]) {
  for (int i = 0; i < n; ++i) idx[i] = i;
  for (int i = 1; i < n; ++i) {  // insertion sort, stable
    const int k = idx[i];
    int j = i - 1;
    while (j >= 0 && a[idx[j]][idx[j]] > a[k][k]) {
      idx[j + 1] = idx[j];
      --j;
    }
    idx[j + 1] = k;
  }
}

// Control points from the weighted moments: sw = sum w, mean c0, covariance
// cov (already / sw). ops/pnp.control_points with ops/pnp.pca's signs.
__device__ __noinline__ void control_points(const double (&c0)[3], const double (&cov0)[3][3],
                               double (&Cw)[4][3]) {
  double cov[3][3], V[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) cov[i][j] = cov0[i][j];
  osl::jacobi<3>(cov, V);
  int idx[3];
  ascending<3>(cov, idx);
  for (int k = 0; k < 3; ++k) Cw[0][k] = c0[k];
  for (int a = 0; a < 3; ++a) {
    const int e = idx[a];
    int lead = 0;
    for (int i = 1; i < 3; ++i) lead = fabs(V[i][e]) > fabs(V[lead][e]) ? i : lead;
    const double sgn = V[lead][e] < 0.0 ? -1.0 : 1.0;
    const double ev = cov[e][e];
    const double sc = sqrt(ev > 1e-9 ? ev : 1e-9) * sgn;
    for (int k = 0; k < 3; ++k) Cw[1 + a][k] = c0[k] + V[k][e] * sc;
  }
}

// M^T M's contribution of one point (barycentric alpha, pixel, weight)
__device__ inline void mtm_rows(const double (&al)[4], double u, double v,
                                double sw, const Cam& cam, double (&r1)[12],
                                double (&r2)[12]) {
  const double fu = cam.fx, fv = cam.fy;
  const double du = static_cast<double>(cam.cx) - u;
  const double dv = static_cast<double>(cam.cy) - v;
  for (int j = 0; j < 4; ++j) {
    r1[3 * j] = al[j] * fu * sw;
    r1[3 * j + 1] = 0.0;
    r1[3 * j + 2] = al[j] * du * sw;
    r2[3 * j] = 0.0;
    r2[3 * j + 1] = al[j] * fv * sw;
    r2[3 * j + 2] = al[j] * dv * sw;
  }
}

// Everything after M^T M: the null space, the beta cases and Gauss-Newton.
// Returns the three candidate camera-frame control points Cc[case].
__device__ __noinline__ void beta_cases(double (&MtM)[12][12], const double (&Cw)[4][3],
                           double (&Cc)[3][4][3]) {
  double V[12][12];
  osl::jacobi<12>(MtM, V);
  int idx[12];
  ascending<12>(MtM, idx);
  double vb[4][4][3];  // 4 smallest eigenvectors as (control point, xyz)
  for (int i = 0; i < 4; ++i)
    for (int c = 0; c < 4; ++c)
      for (int k = 0; k < 3; ++k) vb[i][c][k] = V[3 * c + k][idx[i]];
  double dv[4][6][3], rho[6];
  for (int p = 0; p < 6; ++p) {
    rho[p] = 0.0;
    for (int k = 0; k < 3; ++k) {
      const double d = Cw[kPairI[p]][k] - Cw[kPairJ[p]][k];
      rho[p] += d * d;
      for (int i = 0; i < 4; ++i) dv[i][p][k] = vb[i][kPairI[p]][k] - vb[i][kPairJ[p]][k];
    }
  }
  double L[6][10];
  for (int p = 0; p < 6; ++p)
    for (int c = 0; c < 10; ++c) {
      double s = 0.0;
      for (int k = 0; k < 3; ++k) s += dv[kLI[c]][p][k] * dv[kLJ[c]][p][k];
      L[p][c] = (kLI[c] == kLJ[c] ? 1.0 : 2.0) * s;
    }
  double betas[3][4];
  {  // case 1: columns b11 b12 b13 b14
    const int cols[4] = {0, 1, 3, 6};
    double A[4][4], y[4], b[4];
    for (int a = 0; a < 4; ++a) {
      y[a] = 0.0;
      for (int p = 0; p < 6; ++p) y[a] += L[p][cols[a]] * rho[p];
      for (int c = 0; c < 4; ++c) {
        double s = 0.0;
        for (int p = 0; p < 6; ++p) s += L[p][cols[a]] * L[p][cols[c]];
        A[a][c] = s + (a == c ? 1e-9 : 0.0);
      }
    }
    solve_n<4>(A, y, b);
    const double b1 = sqrt(fabs(b[0]));
    const double s1 = b[0] < 0.0 ? -1.0 : 1.0;
    const double div = b1 > 1e-9 ? b1 : 1.0;
    betas[0][0] = b1;
    betas[0][1] = s1 * b[1] / div;
    betas[0][2] = s1 * b[2] / div;
    betas[0][3] = s1 * b[3] / div;
  }
  {  // case 2: columns b11 b12 b22
    const int cols[3] = {0, 1, 2};
    double A[3][3], y[3], b[3];
    for (int a = 0; a < 3; ++a) {
      y[a] = 0.0;
      for (int p = 0; p < 6; ++p) y[a] += L[p][cols[a]] * rho[p];
      for (int c = 0; c < 3; ++c) {
        double s = 0.0;
        for (int p = 0; p < 6; ++p) s += L[p][cols[a]] * L[p][cols[c]];
        A[a][c] = s + (a == c ? 1e-9 : 0.0);
      }
    }
    solve_n<3>(A, y, b);
    const double b2 = sqrt(fabs(b[2]));
    betas[1][0] = sqrt(fabs(b[0]));
    betas[1][1] = b[1] < 0.0 ? -b2 : b2;
    betas[1][2] = 0.0;
    betas[1][3] = 0.0;
  }
  {  // case 3: columns b11 b12 b22 b13 b23
    const int cols[5] = {0, 1, 2, 3, 4};
    double A[5][5], y[5], b[5];
    for (int a = 0; a < 5; ++a) {
      y[a] = 0.0;
      for (int p = 0; p < 6; ++p) y[a] += L[p][cols[a]] * rho[p];
      for (int c = 0; c < 5; ++c) {
        double s = 0.0;
        for (int p = 0; p < 6; ++p) s += L[p][cols[a]] * L[p][cols[c]];
        A[a][c] = s + (a == c ? 1e-9 : 0.0);
      }
    }
    solve_n<5>(A, y, b);
    const double b1 = sqrt(fabs(b[0]));
    betas[2][0] = b1;
    betas[2][1] = (b[1] < 0.0 ? -1.0 : 1.0) * sqrt(fabs(b[2]));
    betas[2][2] = b[3] / (b1 > 1e-9 ? b1 : 1.0);
    betas[2][3] = 0.0;
  }
  for (int cs = 0; cs < 3; ++cs) {
    double* bt = betas[cs];
    for (int it = 0; it < kGnIters; ++it) {
      double J[6][4], e[6];
      for (int p = 0; p < 6; ++p) {
        double s[3];
        for (int k = 0; k < 3; ++k) {
          s[k] = 0.0;
          for (int i = 0; i < 4; ++i) s[k] += bt[i] * dv[i][p][k];
        }
        e[p] = s[0] * s[0] + s[1] * s[1] + s[2] * s[2] - rho[p];
        for (int i = 0; i < 4; ++i)
          J[p][i] = 2.0 * (s[0] * dv[i][p][0] + s[1] * dv[i][p][1] + s[2] * dv[i][p][2]);
      }
      double A[4][4], g[4], d[4];
      for (int a = 0; a < 4; ++a) {
        g[a] = 0.0;
        for (int p = 0; p < 6; ++p) g[a] += J[p][a] * e[p];
        for (int c = 0; c < 4; ++c) {
          double s = 0.0;
          for (int p = 0; p < 6; ++p) s += J[p][a] * J[p][c];
          A[a][c] = s + (a == c ? 1e-6 : 0.0);
        }
      }
      solve_n<4>(A, g, d);
      for (int i = 0; i < 4; ++i) bt[i] -= d[i];
    }
    for (int c = 0; c < 4; ++c)
      for (int k = 0; k < 3; ++k) {
        double s = 0.0;
        for (int i = 0; i < 4; ++i) s += bt[i] * vb[i][c][k];
        Cc[cs][c][k] = s;
      }
  }
}

// geometry.horn_align(Cw, Cc, with_scale=False) -> Tcw (row-major 4x4)
__device__ __noinline__ void horn(const double (&Cw)[4][3], const double (&Cc)[4][3],
                     double (&T)[16]) {
  double ms[3] = {0.0, 0.0, 0.0}, md[3] = {0.0, 0.0, 0.0};
  for (int n = 0; n < 4; ++n)
    for (int k = 0; k < 3; ++k) {
      ms[k] += Cw[n][k] * 0.25;
      md[k] += Cc[n][k] * 0.25;
    }
  double S[3][3] = {{0.0, 0.0, 0.0}, {0.0, 0.0, 0.0}, {0.0, 0.0, 0.0}};
  for (int n = 0; n < 4; ++n)
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        S[i][j] += (Cw[n][i] - ms[i]) * 0.25 * (Cc[n][j] - md[j]);
  const double xx = S[0][0], xy = S[0][1], xz = S[0][2];
  const double yx = S[1][0], yy = S[1][1], yz = S[1][2];
  const double zx = S[2][0], zy = S[2][1], zz = S[2][2];
  double N[4][4] = {{xx + yy + zz, yz - zy, zx - xz, xy - yx},
                    {yz - zy, xx - yy - zz, xy + yx, zx + xz},
                    {zx - xz, xy + yx, -xx + yy - zz, yz + zy},
                    {xy - yx, zx + xz, yz + zy, -xx - yy + zz}};
  double V[4][4];
  osl::jacobi<4>(N, V);
  int idx[4];
  ascending<4>(N, idx);
  double q[4];
  for (int i = 0; i < 4; ++i) q[i] = V[i][idx[3]];
  double nq = sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  nq = nq > 1e-8 ? nq : 1e-8;
  const double w = q[0] / nq, x = q[1] / nq, y = q[2] / nq, z = q[3] / nq;
  const double R[3][3] = {
      {1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)},
      {2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)},
      {2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)}};
  for (int i = 0; i < 3; ++i) {
    T[4 * i + 3] = md[i] - (R[i][0] * ms[0] + R[i][1] * ms[1] + R[i][2] * ms[2]);
    for (int j = 0; j < 3; ++j) T[4 * i + j] = R[i][j];
  }
  T[12] = T[13] = T[14] = 0.0;
  T[15] = 1.0;
}

// One point's weighted reprojection error under T (the SSE's term)
__device__ inline double sq_err(const double (&T)[16], const float* p,
                                const float* uv, double w, const Cam& cam) {
  const double X = p[0], Y = p[1], Z = p[2];
  const double x = T[0] * X + T[1] * Y + T[2] * Z + T[3];
  const double y = T[4] * X + T[5] * Y + T[6] * Z + T[7];
  double z = T[8] * X + T[9] * Y + T[10] * Z + T[11];
  z = z > 1e-6 ? z : 1e-6;
  const double du = static_cast<double>(cam.fx) * x / z + cam.cx - uv[0];
  const double dv = static_cast<double>(cam.fy) * y / z + cam.cy - uv[1];
  return (du * du + dv * dv) * w;
}

__device__ inline bool finite16(const double (&T)[16]) {
  bool ok = true;
  for (int k = 0; k < 16; ++k) ok = ok && isfinite(T[k]);
  return ok;
}

// ops/pnp.count_inliers for one point under the float32 pose T
__device__ inline bool is_inlier(const float* T, const float* pts,
                                 const float* uv, const float* sigma2,
                                 const uint8_t* valid, int i, const Cam& cam) {
  const float X = pts[3 * i], Y = pts[3 * i + 1], Z = pts[3 * i + 2];
  const float x = T[0] * X + T[1] * Y + T[2] * Z + T[3];
  const float y = T[4] * X + T[5] * Y + T[6] * Z + T[7];
  const float zc = T[8] * X + T[9] * Y + T[10] * Z + T[11];
  const float z = osl::clamp_min(zc, 1e-6f);
  const float u = cam.fx * x / z + cam.cx;
  const float v = cam.fy * y / z + cam.cy;
  const float du = u - uv[2 * i];
  const float dv = v - uv[2 * i + 1];
  const float chi2 = (du * du + dv * dv) / sigma2[i];
  return valid[i] && zc > 0.05f && chi2 < kChi2;
}

// Inlier count of T over N by the block (every thread gets it)
__device__ int block_count(const float* T, const float* pts, const float* uv,
                           const float* sigma2, const uint8_t* valid, int N,
                           const Cam& cam, double* scratch) {
  double n = 0.0;
  for (int i = threadIdx.x; i < N; i += blockDim.x)
    n += is_inlier(T, pts, uv, sigma2, valid, i, cam) ? 1.0 : 0.0;
  return static_cast<int>(osl::block_sum(n, scratch));
}

__global__ void pnp_ransac_hyp_kernel(const float* __restrict__ pts,
                                      const float* __restrict__ uv,
                                      const float* __restrict__ sigma2,
                                      const uint8_t* __restrict__ valid, int N,
                                      const int* __restrict__ samples, Cam cam,
                                      float* __restrict__ hyp,
                                      int* __restrict__ counts) {
  __shared__ float T[16];
  __shared__ double scratch[32];
  const int h = blockIdx.x;
  if (threadIdx.x == 0) {
    const int* s = samples + 4 * h;
    double P[4][3], c0[3] = {0.0, 0.0, 0.0};
    for (int n = 0; n < 4; ++n)
      for (int k = 0; k < 3; ++k) {
        P[n][k] = pts[3 * s[n] + k];
        c0[k] += P[n][k];
      }
    for (int k = 0; k < 3; ++k) c0[k] /= 4.0;
    double cov[3][3];
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) {
        double acc = 0.0;
        for (int n = 0; n < 4; ++n) acc += (P[n][a] - c0[a]) * (P[n][b] - c0[b]);
        cov[a][b] = acc / 4.0;
      }
    double Cw[4][3];
    control_points(c0, cov, Cw);
    double CwH[4][4], Ci[4][4];
    for (int j = 0; j < 4; ++j) {
      for (int k = 0; k < 3; ++k) CwH[k][j] = Cw[j][k];
      CwH[3][j] = 1.0;
    }
    inverse4(CwH, Ci);
    double al[4][4], MtM[12][12];
    for (int a = 0; a < 12; ++a)
      for (int b = 0; b < 12; ++b) MtM[a][b] = 0.0;
    for (int n = 0; n < 4; ++n) {
      const double xh[4] = {P[n][0], P[n][1], P[n][2], 1.0};
      for (int j = 0; j < 4; ++j)
        al[n][j] = Ci[j][0] * xh[0] + Ci[j][1] * xh[1] + Ci[j][2] * xh[2] + Ci[j][3] * xh[3];
      double r1[12], r2[12];
      mtm_rows(al[n], uv[2 * s[n]], uv[2 * s[n] + 1], 1.0, cam, r1, r2);
      for (int a = 0; a < 12; ++a)
        for (int b = 0; b < 12; ++b) MtM[a][b] += r1[a] * r1[b] + r2[a] * r2[b];
    }
    double Cc[3][4][3];
    beta_cases(MtM, Cw, Cc);
    double best_T[16];
    double best_sse = 0.0;
    int best = -1;
    for (int cs = 0; cs < 3; ++cs) {
      double depth = 0.0;
      for (int n = 0; n < 4; ++n)
        depth += al[n][0] * Cc[cs][0][2] + al[n][1] * Cc[cs][1][2] +
                 al[n][2] * Cc[cs][2][2] + al[n][3] * Cc[cs][3][2];
      if (depth < 0.0)
        for (int c = 0; c < 4; ++c)
          for (int k = 0; k < 3; ++k) Cc[cs][c][k] = -Cc[cs][c][k];
      double Tc[16];
      horn(Cw, Cc[cs], Tc);
      double sse = 0.0;
      for (int n = 0; n < 4; ++n) {
        const float p[3] = {pts[3 * s[n]], pts[3 * s[n] + 1], pts[3 * s[n] + 2]};
        sse += sq_err(Tc, p, uv + 2 * s[n], 1.0, cam);
      }
      if (!finite16(Tc) || isnan(sse)) sse = INFINITY;
      if (best < 0 || sse < best_sse) {
        best = cs;
        best_sse = sse;
        for (int k = 0; k < 16; ++k) best_T[k] = Tc[k];
      }
    }
    for (int k = 0; k < 16; ++k) T[k] = static_cast<float>(best_T[k]);
  }
  __syncthreads();
  bool fin = true;
  for (int k = 0; k < 16; ++k) fin = fin && isfinite(T[k]);
  const int n = block_count(T, pts, uv, sigma2, valid, N, cam, scratch);
  if (threadIdx.x < 16) hyp[16 * h + threadIdx.x] = T[threadIdx.x];
  if (threadIdx.x == 0) counts[h] = fin ? n : -1;
}

__global__ void pnp_ransac_refine_kernel(
    const float* __restrict__ pts, const float* __restrict__ uv,
    const float* __restrict__ sigma2, const uint8_t* __restrict__ valid, int N,
    int I, Cam cam, int min_inliers, const float* __restrict__ hyp,
    const int* __restrict__ counts, double* __restrict__ alpha,
    uint8_t* __restrict__ w_best, float* __restrict__ out) {
  __shared__ double scratch[32];
  __shared__ double MtM[12][12];
  __shared__ double Cw_s[4][3];
  __shared__ double Ci_s[4][4];
  __shared__ double Cc_s[3][4][3];
  __shared__ float Tb[16];
  __shared__ float Tr[16];
  __shared__ int best_s;
  if (threadIdx.x == 0) {
    int b = 0;
    for (int h = 1; h < I; ++h) b = counts[h] > counts[b] ? h : b;
    best_s = b;
  }
  __syncthreads();
  const int best = best_s;
  if (threadIdx.x < 16) Tb[threadIdx.x] = hyp[16 * best + threadIdx.x];
  __syncthreads();
  // the winner's inliers (its count again) and the weighted moments
  double sw = 0.0, sx = 0.0, sy = 0.0, sz = 0.0;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const bool in = is_inlier(Tb, pts, uv, sigma2, valid, i, cam);
    w_best[i] = in ? 1 : 0;
    if (in) {
      sw += 1.0;
      sx += pts[3 * i];
      sy += pts[3 * i + 1];
      sz += pts[3 * i + 2];
    }
  }
  const double n_best_d = osl::block_sum(sw, scratch);
  const double swc = n_best_d > 1e-9 ? n_best_d : 1e-9;
  const double c0[3] = {osl::block_sum(sx, scratch) / swc,
                        osl::block_sum(sy, scratch) / swc,
                        osl::block_sum(sz, scratch) / swc};
  double cv[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    if (!w_best[i]) continue;
    const double d[3] = {pts[3 * i] - c0[0], pts[3 * i + 1] - c0[1],
                         pts[3 * i + 2] - c0[2]};
    cv[0] += d[0] * d[0];
    cv[1] += d[0] * d[1];
    cv[2] += d[0] * d[2];
    cv[3] += d[1] * d[1];
    cv[4] += d[1] * d[2];
    cv[5] += d[2] * d[2];
  }
  for (int k = 0; k < 6; ++k) cv[k] = osl::block_sum(cv[k], scratch) / swc;
  if (threadIdx.x == 0) {
    const double cov[3][3] = {{cv[0], cv[1], cv[2]}, {cv[1], cv[3], cv[4]},
                              {cv[2], cv[4], cv[5]}};
    double Cw[4][3], CwH[4][4], Ci[4][4];
    control_points(c0, cov, Cw);
    for (int j = 0; j < 4; ++j) {
      for (int k = 0; k < 3; ++k) CwH[k][j] = Cw[j][k];
      CwH[3][j] = 1.0;
    }
    inverse4(CwH, Ci);
    for (int j = 0; j < 4; ++j) {
      for (int k = 0; k < 3; ++k) Cw_s[j][k] = Cw[j][k];
      for (int k = 0; k < 4; ++k) Ci_s[j][k] = Ci[j][k];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const double xh[4] = {pts[3 * i], pts[3 * i + 1], pts[3 * i + 2], 1.0};
    for (int j = 0; j < 4; ++j)
      alpha[4 * i + j] = Ci_s[j][0] * xh[0] + Ci_s[j][1] * xh[1] +
                         Ci_s[j][2] * xh[2] + Ci_s[j][3] * xh[3];
  }
  __syncthreads();
  // the weighted M^T M: a thread per entry of the upper triangle, the rows
  // in order
  for (int e = threadIdx.x; e < 78; e += blockDim.x) {
    int a = 0, r = e;
    while (r >= 12 - a) {
      r -= 12 - a;
      ++a;
    }
    const int b = a + r;
    double acc = 0.0;
    for (int i = 0; i < N; ++i) {
      if (!w_best[i]) continue;
      const double al[4] = {alpha[4 * i], alpha[4 * i + 1], alpha[4 * i + 2],
                            alpha[4 * i + 3]};
      double r1[12], r2[12];
      mtm_rows(al, uv[2 * i], uv[2 * i + 1], 1.0, cam, r1, r2);
      acc += r1[a] * r1[b] + r2[a] * r2[b];
    }
    MtM[a][b] = acc;
    MtM[b][a] = acc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double A[12][12], Cw[4][3], Cc[3][4][3];
    for (int a = 0; a < 12; ++a)
      for (int b = 0; b < 12; ++b) A[a][b] = MtM[a][b];
    for (int j = 0; j < 4; ++j)
      for (int k = 0; k < 3; ++k) Cw[j][k] = Cw_s[j][k];
    beta_cases(A, Cw, Cc);
    for (int cs = 0; cs < 3; ++cs)
      for (int c = 0; c < 4; ++c)
        for (int k = 0; k < 3; ++k) Cc_s[cs][c][k] = Cc[cs][c][k];
  }
  __syncthreads();
  // each case: the weighted depth (cheirality), the pose, the weighted SSE
  double best_sse = 0.0;
  int best_case = -1;
  double Tbest[16];
  for (int cs = 0; cs < 3; ++cs) {
    double dep = 0.0;
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      if (!w_best[i]) continue;
      for (int j = 0; j < 4; ++j) dep += alpha[4 * i + j] * Cc_s[cs][j][2];
    }
    dep = osl::block_sum(dep, scratch);
    double Cc[4][3], Cw[4][3], Tc[16];
    for (int c = 0; c < 4; ++c)
      for (int k = 0; k < 3; ++k) {
        Cc[c][k] = dep < 0.0 ? -Cc_s[cs][c][k] : Cc_s[cs][c][k];
        Cw[c][k] = Cw_s[c][k];
      }
    horn(Cw, Cc, Tc);
    double sse = 0.0;
    for (int i = threadIdx.x; i < N; i += blockDim.x)
      if (w_best[i]) sse += sq_err(Tc, pts + 3 * i, uv + 2 * i, 1.0, cam);
    sse = osl::block_sum(sse, scratch);
    if (!finite16(Tc) || isnan(sse)) sse = INFINITY;
    if (best_case < 0 || sse < best_sse) {
      best_case = cs;
      best_sse = sse;
      for (int k = 0; k < 16; ++k) Tbest[k] = Tc[k];
    }
  }
  if (threadIdx.x < 16) Tr[threadIdx.x] = static_cast<float>(Tbest[threadIdx.x]);
  __syncthreads();
  bool fin = true;
  for (int k = 0; k < 16; ++k) fin = fin && isfinite(Tr[k]);
  int n_ref = block_count(Tr, pts, uv, sigma2, valid, N, cam, scratch);
  n_ref = fin ? n_ref : -1;
  const int n_best = counts[best];
  const bool use_ref = n_ref >= n_best;
  const float* Tout = use_ref ? Tr : Tb;
  for (int i = threadIdx.x; i < N; i += blockDim.x)
    out[18 + i] = (use_ref ? is_inlier(Tr, pts, uv, sigma2, valid, i, cam)
                           : w_best[i] != 0) ? 1.0f : 0.0f;
  if (threadIdx.x < 16) out[threadIdx.x] = Tout[threadIdx.x];
  if (threadIdx.x == 0) {
    out[16] = static_cast<float>(use_ref ? n_ref : n_best);
    out[17] = (n_ref > n_best ? n_ref : n_best) >= min_inliers ? 1.0f : 0.0f;
  }
}

}  // namespace

OSL_EXPORT int osl_pnp_ransac(const float* pts, const float* uv,
                              const float* sigma2, const uint8_t* valid, int N,
                              const int* samples, int I, float fx, float fy,
                              float cx, float cy, int min_inliers, float* hyp,
                              int* counts, double* alpha, uint8_t* w_best,
                              float* out, void* stream) {
  if (N <= 0 || I <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Cam cam{fx, fy, cx, cy};
  pnp_ransac_hyp_kernel<<<I, 128, 0, st>>>(pts, uv, sigma2, valid, N, samples,
                                           cam, hyp, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pnp_ransac_refine_kernel<<<1, 256, 0, st>>>(pts, uv, sigma2, valid, N, I, cam,
                                              min_inliers, hyp, counts, alpha,
                                              w_best, out);
  return static_cast<int>(cudaGetLastError());
}
