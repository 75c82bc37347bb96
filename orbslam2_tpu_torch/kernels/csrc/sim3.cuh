// The Sim(3) group for kernels K, M and P, templated on the scalar: float,
// or Dual<N>, a forward-mode dual number carrying N tangents, so that a
// kernel differentiates the same expressions jax.jacfwd differentiates in
// the reference (orbslam2_tpu/ops/geometry.py: sim3_exp, sim3_log,
// sim3_compose, sim3_inverse, sim3_apply, so3_exp, so3_log and the
// quaternion conversions, with their small-angle and small-sigma branches
// chosen on the values).
//
// A Sim3 is [s, qw, qx, qy, qz, tx, ty, tz], as geometry.sim3_make packs it.
#pragma once

#include "common.cuh"

namespace osl {

constexpr float kEps = 1e-8f;  // geometry._EPS
constexpr float kPi = 3.14159265358979f;

template <int N>
struct Dual {
  float v;
  float d[N];
  __device__ Dual() {}
  __device__ Dual(float x) : v(x) {
#pragma unroll
    for (int i = 0; i < N; ++i) d[i] = 0.0f;
  }
};

__device__ __forceinline__ float val(float x) { return x; }
template <int N>
__device__ __forceinline__ float val(const Dual<N>& x) { return x.v; }

// a Dual with value x and derivative `grad` times a's tangent
template <int N>
__device__ __forceinline__ Dual<N> chain(const Dual<N>& a, float x, float grad) {
  Dual<N> r;
  r.v = x;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = grad * a.d[i];
  return r;
}

template <int N>
__device__ __forceinline__ Dual<N> operator+(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator-(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator-(const Dual<N>& a) {
  Dual<N> r;
  r.v = -a.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = -a.d[i];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator*(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator/(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> r;
  r.v = a.v / b.v;
  const float inv = 1.0f / b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = (a.d[i] - r.v * b.d[i]) * inv;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator+(const Dual<N>& a, float b) { return a + Dual<N>(b); }
template <int N>
__device__ __forceinline__ Dual<N> operator+(float a, const Dual<N>& b) { return Dual<N>(a) + b; }
template <int N>
__device__ __forceinline__ Dual<N> operator-(const Dual<N>& a, float b) { return a - Dual<N>(b); }
template <int N>
__device__ __forceinline__ Dual<N> operator-(float a, const Dual<N>& b) { return Dual<N>(a) - b; }
template <int N>
__device__ __forceinline__ Dual<N> operator*(const Dual<N>& a, float b) {
  Dual<N> r;
  r.v = a.v * b;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * b;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator*(float a, const Dual<N>& b) { return b * a; }
template <int N>
__device__ __forceinline__ Dual<N> operator/(const Dual<N>& a, float b) { return a / Dual<N>(b); }
template <int N>
__device__ __forceinline__ Dual<N> operator/(float a, const Dual<N>& b) { return Dual<N>(a) / b; }

__device__ __forceinline__ float tsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ float tsin(float x) { return sinf(x); }
__device__ __forceinline__ float tcos(float x) { return cosf(x); }
__device__ __forceinline__ float texp(float x) { return expf(x); }
__device__ __forceinline__ float tlog(float x) { return logf(x); }
__device__ __forceinline__ float tacos(float x) { return acosf(x); }
__device__ __forceinline__ float tasin(float x) { return asinf(x); }
template <int N>
__device__ __forceinline__ Dual<N> tsqrt(const Dual<N>& a) {
  const float s = sqrtf(a.v);
  return chain(a, s, 0.5f / s);
}
template <int N>
__device__ __forceinline__ Dual<N> tsin(const Dual<N>& a) { return chain(a, sinf(a.v), cosf(a.v)); }
template <int N>
__device__ __forceinline__ Dual<N> tcos(const Dual<N>& a) { return chain(a, cosf(a.v), -sinf(a.v)); }
template <int N>
__device__ __forceinline__ Dual<N> texp(const Dual<N>& a) {
  const float e = expf(a.v);
  return chain(a, e, e);
}
template <int N>
__device__ __forceinline__ Dual<N> tlog(const Dual<N>& a) { return chain(a, logf(a.v), 1.0f / a.v); }
template <int N>
__device__ __forceinline__ Dual<N> tacos(const Dual<N>& a) {
  return chain(a, acosf(a.v), -1.0f / sqrtf(1.0f - a.v * a.v));
}
template <int N>
__device__ __forceinline__ Dual<N> tasin(const Dual<N>& a) {
  return chain(a, asinf(a.v), 1.0f / sqrtf(1.0f - a.v * a.v));
}

// max(a, lo) / min(a, hi) as jnp.maximum / jnp.clip choose (NaN stays NaN)
template <class T>
__device__ __forceinline__ T tmax(const T& a, float lo) { return val(a) < lo ? T(lo) : a; }
template <class T>
__device__ __forceinline__ T tmin(const T& a, float hi) { return val(a) > hi ? T(hi) : a; }
template <class T>
__device__ __forceinline__ T tclip(const T& a, float lo, float hi) { return tmin(tmax(a, lo), hi); }

// ---------------------------------------------------------------------------
// rotations
// ---------------------------------------------------------------------------
template <class T>
__device__ inline void quat_to_rotmat(const T q[4], T R[3][3]) {
  const T n = tmax(tsqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]), kEps);
  const T w = q[0] / n, x = q[1] / n, y = q[2] / n, z = q[3] / n;
  R[0][0] = 1.0f - 2.0f * (y * y + z * z);
  R[0][1] = 2.0f * (x * y - w * z);
  R[0][2] = 2.0f * (x * z + w * y);
  R[1][0] = 2.0f * (x * y + w * z);
  R[1][1] = 1.0f - 2.0f * (x * x + z * z);
  R[1][2] = 2.0f * (y * z - w * x);
  R[2][0] = 2.0f * (x * z - w * y);
  R[2][1] = 2.0f * (y * z + w * x);
  R[2][2] = 1.0f - 2.0f * (x * x + y * y);
}

// Shepperd's method: the best-conditioned of four cases, canonical w >= 0
template <class T>
__device__ inline void rotmat_to_quat(const T R[3][3], T q[4]) {
  const T tr = R[0][0] + R[1][1] + R[2][2];
  const float sc[4] = {val(tr), val(R[0][0]) - val(R[1][1]) - val(R[2][2]),
                       -val(R[0][0]) + val(R[1][1]) - val(R[2][2]),
                       -val(R[0][0]) - val(R[1][1]) + val(R[2][2])};
  int c = 0;
  for (int i = 1; i < 4; ++i) {
    if (sc[i] > sc[c]) c = i;
  }
  if (c == 0) {
    const T w = tsqrt(tmax(1.0f + tr, kEps)) * 0.5f;
    q[0] = w;
    q[1] = (R[2][1] - R[1][2]) / (4.0f * w);
    q[2] = (R[0][2] - R[2][0]) / (4.0f * w);
    q[3] = (R[1][0] - R[0][1]) / (4.0f * w);
  } else if (c == 1) {
    const T x = tsqrt(tmax(1.0f + R[0][0] - R[1][1] - R[2][2], kEps)) * 0.5f;
    q[0] = (R[2][1] - R[1][2]) / (4.0f * x);
    q[1] = x;
    q[2] = (R[0][1] + R[1][0]) / (4.0f * x);
    q[3] = (R[0][2] + R[2][0]) / (4.0f * x);
  } else if (c == 2) {
    const T y = tsqrt(tmax(1.0f - R[0][0] + R[1][1] - R[2][2], kEps)) * 0.5f;
    q[0] = (R[0][2] - R[2][0]) / (4.0f * y);
    q[1] = (R[0][1] + R[1][0]) / (4.0f * y);
    q[2] = y;
    q[3] = (R[1][2] + R[2][1]) / (4.0f * y);
  } else {
    const T z = tsqrt(tmax(1.0f - R[0][0] - R[1][1] + R[2][2], kEps)) * 0.5f;
    q[0] = (R[1][0] - R[0][1]) / (4.0f * z);
    q[1] = (R[0][2] + R[2][0]) / (4.0f * z);
    q[2] = (R[1][2] + R[2][1]) / (4.0f * z);
    q[3] = z;
  }
  if (val(q[0]) < 0.0f) {
    for (int i = 0; i < 4; ++i) q[i] = -q[i];
  }
  const T n = tmax(tsqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]), kEps);
  for (int i = 0; i < 4; ++i) q[i] = q[i] / n;
}

template <class T>
__device__ inline void hat(const T v[3], T K[3][3]) {
  K[0][0] = T(0.0f); K[0][1] = -v[2];     K[0][2] = v[1];
  K[1][0] = v[2];     K[1][1] = T(0.0f); K[1][2] = -v[0];
  K[2][0] = -v[1];    K[2][1] = v[0];     K[2][2] = T(0.0f);
}

template <class T>
__device__ inline void matmul3(const T A[3][3], const T B[3][3], T C[3][3]) {
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      C[i][j] = A[i][0] * B[0][j] + A[i][1] * B[1][j] + A[i][2] * B[2][j];
    }
  }
}

template <class T>
__device__ inline void so3_exp(const T phi[3], T R[3][3]) {
  const T theta2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const T theta = tsqrt(theta2 + kEps * kEps);
  const bool small = val(theta2) < 1e-8f;
  const T a = small ? 1.0f - theta2 / 6.0f : tsin(theta) / theta;
  const T b = small ? 0.5f - theta2 / 24.0f : (1.0f - tcos(theta)) / theta2;
  T K[3][3], KK[3][3];
  hat(phi, K);
  matmul3(K, K, KK);
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      R[i][j] = (i == j ? 1.0f : 0.0f) + a * K[i][j] + b * KK[i][j];
    }
  }
}

// geometry.so3_log: stable near 0 (Taylor) and near pi (the column of
// R + I of largest norm, signed by the generic axis)
template <class T>
__device__ inline void so3_log(const T R[3][3], T w[3]) {
  const T trace = R[0][0] + R[1][1] + R[2][2];
  const T cos_t = tclip((trace - 1.0f) * 0.5f, -1.0f, 1.0f);
  const T wg[3] = {R[2][1] - R[1][2], R[0][2] - R[2][0], R[1][0] - R[0][1]};
  const T sin2 = 0.25f * (wg[0] * wg[0] + wg[1] * wg[1] + wg[2] * wg[2]);
  const bool small = val(cos_t) > 1.0f - 1e-5f;
  const bool near_pi = val(cos_t) < -1.0f + 1e-4f;
  if (near_pi) {
    T RpI[3][3];
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) RpI[i][j] = R[i][j] + (i == j ? 1.0f : 0.0f);
    }
    int best = 0;
    float bn = -1.0f;
    for (int j = 0; j < 3; ++j) {
      const float n = val(RpI[0][j]) * val(RpI[0][j]) + val(RpI[1][j]) * val(RpI[1][j]) +
                      val(RpI[2][j]) * val(RpI[2][j]);
      if (n > bn) {
        bn = n;
        best = j;
      }
    }
    T axis[3] = {RpI[0][best], RpI[1][best], RpI[2][best]};
    const T an = tmax(tsqrt(axis[0] * axis[0] + axis[1] * axis[1] + axis[2] * axis[2]), kEps);
    for (int i = 0; i < 3; ++i) axis[i] = axis[i] / an;
    const T sin_small =
        tclip(0.5f * tsqrt(wg[0] * wg[0] + wg[1] * wg[1] + wg[2] * wg[2]), 0.0f, 1.0f);
    const T theta_pi = kPi - tasin(sin_small);
    const float dot = val(axis[0]) * val(wg[0]) + val(axis[1]) * val(wg[1]) +
                      val(axis[2]) * val(wg[2]);
    const float sgn = dot < 0.0f ? -1.0f : 1.0f;
    for (int i = 0; i < 3; ++i) w[i] = axis[i] * sgn * theta_pi;
    return;
  }
  T scale;
  if (small) {
    scale = 0.5f + sin2 / 12.0f;
  } else {
    const T cos_safe = tclip(cos_t, -1.0f + 1e-7f, 1.0f);
    const T theta = tacos(cos_safe);
    scale = theta / (2.0f * tmax(tsin(theta), kEps));
  }
  for (int i = 0; i < 3; ++i) w[i] = wg[i] * scale;
}

// ---------------------------------------------------------------------------
// Sim(3)
// ---------------------------------------------------------------------------
template <class T>
struct Sim3 {
  T s;
  T q[4];
  T t[3];
};

template <class T>
__device__ inline Sim3<T> sim3_load(const float* p) {
  Sim3<T> S;
  S.s = T(p[0]);
  for (int i = 0; i < 4; ++i) S.q[i] = T(p[1 + i]);
  for (int i = 0; i < 3; ++i) S.t[i] = T(p[5 + i]);
  return S;
}

__device__ inline void sim3_store(const Sim3<float>& S, float* p) {
  p[0] = S.s;
  for (int i = 0; i < 4; ++i) p[1 + i] = S.q[i];
  for (int i = 0; i < 3; ++i) p[5 + i] = S.t[i];
}

template <class T>
__device__ inline Sim3<T> sim3_make(const T& s, const T R[3][3], const T t[3]) {
  Sim3<T> S;
  S.s = s;
  rotmat_to_quat(R, S.q);
  for (int i = 0; i < 3; ++i) S.t[i] = t[i];
  return S;
}

template <class T>
__device__ inline void sim3_apply(const Sim3<T>& S, const T R[3][3], const T p[3],
                                  T out[3]) {
  for (int i = 0; i < 3; ++i) {
    out[i] = S.s * (R[i][0] * p[0] + R[i][1] * p[1] + R[i][2] * p[2]) + S.t[i];
  }
}

template <class T>
__device__ inline Sim3<T> sim3_compose(const Sim3<T>& A, const Sim3<T>& B) {
  T RA[3][3], RB[3][3], R[3][3], t[3];
  quat_to_rotmat(A.q, RA);
  quat_to_rotmat(B.q, RB);
  matmul3(RA, RB, R);
  for (int i = 0; i < 3; ++i) {
    t[i] = A.s * (RA[i][0] * B.t[0] + RA[i][1] * B.t[1] + RA[i][2] * B.t[2]) + A.t[i];
  }
  return sim3_make(A.s * B.s, R, t);
}

template <class T>
__device__ inline Sim3<T> sim3_inverse(const Sim3<T>& S) {
  T R[3][3], Rt[3][3], t[3];
  quat_to_rotmat(S.q, R);
  const T s_inv = 1.0f / tmax(S.s, kEps);
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) Rt[i][j] = R[j][i];
  }
  for (int i = 0; i < 3; ++i) {
    t[i] = -s_inv * (Rt[i][0] * S.t[0] + Rt[i][1] * S.t[1] + Rt[i][2] * S.t[2]);
  }
  return sim3_make(s_inv, Rt, t);
}

// s = exp(sigma) and W = A K + B K^2 + C I of the Sim(3) exponential's
// translation (Strasdat's W, unit-axis K), with the reference's branches
template <class T>
__device__ inline void sim3_W(const T phi[3], const T& sigma, T& s, T W[3][3]) {
  s = texp(sigma);
  const T theta2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const T theta = tsqrt(theta2 + kEps * kEps);
  const T th_c = tmax(theta, kEps);
  const T axis[3] = {phi[0] / th_c, phi[1] / th_c, phi[2] / th_c};
  T K[3][3], KK[3][3];
  hat(axis, K);
  matmul3(K, K, KK);
  const bool small_sig = fabsf(val(sigma)) < 1e-5f;
  const bool small_th = val(theta) < 1e-5f;
  const T C = small_sig ? 1.0f + sigma / 2.0f + sigma * sigma / 6.0f : (s - 1.0f) / sigma;
  T A, B;
  if (small_th) {
    A = T(0.0f);
    B = T(0.0f);
  } else if (small_sig) {
    const T th_sq = theta * theta;
    A = (1.0f - tcos(theta)) / tmax(th_sq, kEps) * theta;
    B = (theta - tsin(theta)) / tmax(th_sq * theta, kEps) * th_sq;
  } else {
    const T a_ = s * tsin(theta);
    const T b_ = s * tcos(theta);
    const T th_sq = theta * theta;
    const T denom = tmax(sigma * sigma + th_sq, kEps);
    A = (a_ * sigma + (1.0f - b_) * theta) / (th_c * denom) * theta;
    B = (C - ((b_ - 1.0f) * sigma + a_ * theta) / denom) / tmax(th_sq, kEps) * th_sq;
  }
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) W[i][j] = A * K[i][j] + B * KK[i][j] + (i == j ? C : T(0.0f));
  }
}

template <class T>
__device__ inline Sim3<T> sim3_exp(const T xi[7]) {
  const T phi[3] = {xi[3], xi[4], xi[5]};
  T s, W[3][3], R[3][3], t[3];
  sim3_W(phi, xi[6], s, W);
  so3_exp(phi, R);
  for (int i = 0; i < 3; ++i) t[i] = W[i][0] * xi[0] + W[i][1] * xi[1] + W[i][2] * xi[2];
  return sim3_make(s, R, t);
}

// x = A^-1 b for 3x3 A by Gaussian elimination with partial pivoting (the
// LU of jnp.linalg.solve), pivots chosen on the values
template <class T>
__device__ inline void solve3(T A[3][3], T b[3], T x[3]) {
  for (int c = 0; c < 3; ++c) {
    int p = c;
    for (int r = c + 1; r < 3; ++r) {
      if (fabsf(val(A[r][c])) > fabsf(val(A[p][c]))) p = r;
    }
    if (p != c) {
      for (int j = 0; j < 3; ++j) {
        const T tmp = A[c][j];
        A[c][j] = A[p][j];
        A[p][j] = tmp;
      }
      const T tb = b[c];
      b[c] = b[p];
      b[p] = tb;
    }
    for (int r = c + 1; r < 3; ++r) {
      const T f = A[r][c] / A[c][c];
      for (int j = c; j < 3; ++j) A[r][j] = A[r][j] - f * A[c][j];
      b[r] = b[r] - f * b[c];
    }
  }
  for (int r = 2; r >= 0; --r) {
    T s = b[r];
    for (int j = r + 1; j < 3; ++j) s = s - A[r][j] * x[j];
    x[r] = s / A[r][r];
  }
}

template <class T>
__device__ inline void sim3_log(const Sim3<T>& S, T xi[7]) {
  const T sigma = tlog(tmax(S.s, kEps));
  T R[3][3], phi[3], s, W[3][3], t[3] = {S.t[0], S.t[1], S.t[2]}, rho[3];
  quat_to_rotmat(S.q, R);
  so3_log(R, phi);
  sim3_W(phi, sigma, s, W);
  solve3(W, t, rho);
  for (int i = 0; i < 3; ++i) {
    xi[i] = rho[i];
    xi[3 + i] = phi[i];
  }
  xi[6] = sigma;
}

}  // namespace osl
