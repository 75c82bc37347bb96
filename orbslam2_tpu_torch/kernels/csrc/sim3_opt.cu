// Kernel M: Sim3 refinement (OptimizeSim3) and guided Sim3 matching
// (SearchBySim3) between the loop's two keyframes.
//
// Replaces orbslam2_tpu/ops/sim3_opt.py: optimize_sim3 and search_by_sim3,
// as the loop closer calls them (orbslam2_tpu/loop_closing.py:226-286).
//
//   sim3_opt_lm          one block: the reference's whole schedule, 5 LM
//                        iterations on the valid pairs, the chi2 <= 10
//                        re-gate on both edges, 10 iterations on the
//                        inliers. Each iteration: thread 0 forms
//                        S_x = exp(xi) S and its inverse in dual numbers
//                        (d/dxi at xi = 0, 7 tangents, through sim3_exp,
//                        sim3_compose, sim3_inverse and the quaternion
//                        packing, as jax.jacfwd differentiates them); every
//                        thread evaluates its points' 4 residual rows and
//                        their 4 x 7 Jacobian through sim3_apply and the
//                        projection, the Huber IRLS weights (delta =
//                        sqrt(10)), and its share of H (7 x 7) and g; the
//                        block sums them in a fixed order; thread 0 pins
//                        the scale for fix_scale, solves H + lam diag(H) +
//                        1e-9 I by Gaussian elimination with partial
//                        pivoting and forms the trial S; the block sums
//                        both robust costs; thread 0 keeps the better and
//                        scales lam by 0.5 or 4, clipped to [1e-6, 1e4].
//                        Writes [S12 (8), n_inliers, inliers (N)]: one D2H.
//   sim3_search_kernel   a warp per source row of both directions (image 1's
//                        points through S21 into image 2, image 2's through
//                        S12 into image 1; S, R, t of each read as the plain
//                        version computes them): in front (z > 0.1) and in
//                        the image, level pred from the depth band, radius
//                        7.5 sf^pred, octave window [pred - 1, pred + 1];
//                        lanes scan the destination's keypoints and keep the
//                        smallest (Hamming distance, index); TH_HIGH, no
//                        ratio. No (P, N) matrix is stored.
//   sim3_search_agree    a thread per feature of image 1: kept where image
//                        2's match points back at it.
// The search's integer outputs are bit-exact against the plain version
// (the same single float32 operations, FMA contraction off).
#include "sim3.cuh"

namespace {

using osl::Dual;
using osl::Sim3;
using D7 = Dual<7>;

constexpr int kLmThreads = 256;
constexpr int kMaxDesc = 100;  // TH_HIGH
constexpr unsigned long long kNone = ~0ull;

struct Cam {
  float fx, fy, cx, cy, width, height;
};

// projection as models.camera.project: 1 / z with |z| < 1e-8 -> 1e-8
template <class T>
__device__ __forceinline__ void project(const Cam& c, const T p[3], T uv[2]) {
  const T z = fabsf(osl::val(p[2])) < 1e-8f ? T(1e-8f) : p[2];
  const T inv_z = 1.0f / z;
  uv[0] = c.fx * p[0] * inv_z + c.cx;
  uv[1] = c.fy * p[1] * inv_z + c.cy;
}

// the transform of one direction: s, R (row-major), t
struct Xform {
  D7 s, R[3][3], t[3];
};

struct Edge {
  const float *p1, *p2, *u1, *u2, *inv1, *inv2;
};

// residual rows of point n under the two transforms (forward: S applied to
// the point of image 2, projected into image 1; inverse: S^-1 applied to
// the point of image 1, projected into image 2), scaled by 1/sigma
template <class T>
__device__ void residual4(const Cam& c, const T& s, const T R[3][3], const T t[3],
                          const T& si, const T Ri[3][3], const T ti[3],
                          const Edge& e, int n, T r[4]) {
  const T a[3] = {T(e.p2[3 * n]), T(e.p2[3 * n + 1]), T(e.p2[3 * n + 2])};
  const T b[3] = {T(e.p1[3 * n]), T(e.p1[3 * n + 1]), T(e.p1[3 * n + 2])};
  T pa[3], pb[3], ua[2], ub[2];
  for (int i = 0; i < 3; ++i) {
    pa[i] = s * (R[i][0] * a[0] + R[i][1] * a[1] + R[i][2] * a[2]) + t[i];
    pb[i] = si * (Ri[i][0] * b[0] + Ri[i][1] * b[1] + Ri[i][2] * b[2]) + ti[i];
  }
  project(c, pa, ua);
  project(c, pb, ub);
  r[0] = (e.u1[2 * n] - ua[0]) * e.inv1[n];
  r[1] = (e.u1[2 * n + 1] - ua[1]) * e.inv1[n];
  r[2] = (e.u2[2 * n] - ub[0]) * e.inv2[n];
  r[3] = (e.u2[2 * n + 1] - ub[1]) * e.inv2[n];
}

__device__ __forceinline__ float huber(float c, float delta) {
  const float e = sqrtf(c + 1e-12f);
  return e <= delta ? c : 2.0f * delta * e - delta * delta;
}

// a fixed-order sum over the block of each of k floats; thread 0 gets them
template <int k>
__device__ void block_reduce(float (&v)[k], float (*sh)[kLmThreads / 32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = 0; j < k; ++j) {
    float x = v[j];
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(osl::kFullMask, x, o);
    if (lane == 0) sh[j][warp] = x;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int j = 0; j < k; ++j) {
      float s = 0.0f;
      for (int w = 0; w < kLmThreads / 32; ++w) s += sh[j][w];
      v[j] = s;
    }
  }
  __syncthreads();
}

// per-point chi2 of both edges at the float transform in shared memory
__device__ void edge_chi2(const Cam& c, const float sx[26], const Edge& e, int n,
                          float& c1, float& c2) {
  float R[3][3], Ri[3][3], t[3], ti[3];
  for (int i = 0; i < 9; ++i) {
    R[i / 3][i % 3] = sx[1 + i];
    Ri[i / 3][i % 3] = sx[14 + i];
  }
  for (int i = 0; i < 3; ++i) {
    t[i] = sx[10 + i];
    ti[i] = sx[23 + i];
  }
  float r[4];
  residual4(c, sx[0], R, t, sx[13], Ri, ti, e, n, r);
  c1 = r[0] * r[0] + r[1] * r[1];
  c2 = r[2] * r[2] + r[3] * r[3];
}

// [s, R (9), t (3)] of S and of S^-1 (26 floats)
__device__ void pack_xform(const Sim3<float>& S, float* sx) {
  const Sim3<float> Si = osl::sim3_inverse(S);
  float R[3][3], Ri[3][3];
  osl::quat_to_rotmat(S.q, R);
  osl::quat_to_rotmat(Si.q, Ri);
  sx[0] = S.s;
  sx[13] = Si.s;
  for (int i = 0; i < 9; ++i) {
    sx[1 + i] = R[i / 3][i % 3];
    sx[14 + i] = Ri[i / 3][i % 3];
  }
  for (int i = 0; i < 3; ++i) {
    sx[10 + i] = S.t[i];
    sx[23 + i] = Si.t[i];
  }
}

// x = A^-1 b, 7 x 7, Gaussian elimination with partial pivoting
__device__ void solve7(float A[7][7], float b[7], float x[7]) {
  for (int c = 0; c < 7; ++c) {
    int p = c;
    for (int r = c + 1; r < 7; ++r) {
      if (fabsf(A[r][c]) > fabsf(A[p][c])) p = r;
    }
    if (p != c) {
      for (int j = 0; j < 7; ++j) {
        const float tmp = A[c][j];
        A[c][j] = A[p][j];
        A[p][j] = tmp;
      }
      const float tb = b[c];
      b[c] = b[p];
      b[p] = tb;
    }
    for (int r = c + 1; r < 7; ++r) {
      const float f = A[r][c] / A[c][c];
      for (int j = c; j < 7; ++j) A[r][j] = A[r][j] - f * A[c][j];
      b[r] = b[r] - f * b[c];
    }
  }
  for (int r = 6; r >= 0; --r) {
    float s = b[r];
    for (int j = r + 1; j < 7; ++j) s = s - A[r][j] * x[j];
    x[r] = s / A[r][r];
  }
}

__global__ void __launch_bounds__(kLmThreads)
sim3_opt_lm(const float* __restrict__ S0, Edge e, const float* __restrict__ s2_1,
            const float* __restrict__ s2_2, const uint8_t* __restrict__ valid,
            int N, Cam cam, int fix_scale, float th2, int iters1, int iters2,
            float* __restrict__ inv1, float* __restrict__ inv2,
            uint8_t* __restrict__ mask, float* __restrict__ out,
            float* __restrict__ costs) {
  __shared__ Xform xf, xfi;      // S_x = exp(xi) S and its inverse, in duals
  __shared__ float sx_cur[26], sx_new[26];
  __shared__ Sim3<float> S, S_new;
  __shared__ float lam;
  __shared__ float red[35][kLmThreads / 32];
  __shared__ bool better;
  const float delta = sqrtf(th2);
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    inv1[n] = 1.0f / sqrtf(fmaxf(s2_1[n], 1e-9f));
    inv2[n] = 1.0f / sqrtf(fmaxf(s2_2[n], 1e-9f));
    mask[n] = valid[n];
  }
  e.inv1 = inv1;
  e.inv2 = inv2;
  if (threadIdx.x == 0) S = osl::sim3_load<float>(S0);
  __syncthreads();
  for (int phase = 0; phase < 2; ++phase) {
    if (threadIdx.x == 0) lam = 1e-3f;
    const int n_iters = phase == 0 ? iters1 : iters2;
    for (int it = 0; it < n_iters; ++it) {
      if (threadIdx.x == 0) {
        D7 xi[7];
        for (int k = 0; k < 7; ++k) {
          xi[k] = D7(0.0f);
          xi[k].d[k] = 1.0f;
        }
        const Sim3<D7> Sx = osl::sim3_compose(osl::sim3_exp(xi), osl::sim3_load<D7>(&S.s));
        const Sim3<D7> Sxi = osl::sim3_inverse(Sx);
        D7 R[3][3], Ri[3][3];
        osl::quat_to_rotmat(Sx.q, R);
        osl::quat_to_rotmat(Sxi.q, Ri);
        xf.s = Sx.s;
        xfi.s = Sxi.s;
        for (int i = 0; i < 3; ++i) {
          xf.t[i] = Sx.t[i];
          xfi.t[i] = Sxi.t[i];
          for (int j = 0; j < 3; ++j) {
            xf.R[i][j] = R[i][j];
            xfi.R[i][j] = Ri[i][j];
          }
        }
      }
      __syncthreads();
      float acc[35];
      for (int j = 0; j < 35; ++j) acc[j] = 0.0f;
      for (int n = threadIdx.x; n < N; n += blockDim.x) {
        if (!mask[n]) continue;
        D7 r[4];
        residual4(cam, xf.s, xf.R, xf.t, xfi.s, xfi.R, xfi.t, e, n, r);
        const float e1 = sqrtf(r[0].v * r[0].v + r[1].v * r[1].v + 1e-12f);
        const float e2 = sqrtf(r[2].v * r[2].v + r[3].v * r[3].v + 1e-12f);
        const float w12[2] = {fminf(1.0f, delta / e1), fminf(1.0f, delta / e2)};
        for (int row = 0; row < 4; ++row) {
          const float w = w12[row / 2];
          int k = 0;
          for (int a = 0; a < 7; ++a) {
            const float wa = w * r[row].d[a];
            for (int b = a; b < 7; ++b) acc[k++] += wa * r[row].d[b];
            acc[28 + a] += wa * r[row].v;
          }
        }
      }
      block_reduce(acc, red);
      if (threadIdx.x == 0) {
        float H[7][7], g[7], dx[7];
        int k = 0;
        for (int a = 0; a < 7; ++a) {
          for (int b = a; b < 7; ++b) {
            H[a][b] = acc[k];
            H[b][a] = acc[k];
            ++k;
          }
          g[a] = acc[28 + a];
        }
        if (fix_scale) {
          for (int j = 0; j < 7; ++j) H[6][j] = H[j][6] = 0.0f;
          H[6][6] = 1.0f;
          g[6] = 0.0f;
        }
        float Hd[7][7];
        for (int a = 0; a < 7; ++a) {
          for (int b = 0; b < 7; ++b) {
            Hd[a][b] = H[a][b] + (a == b ? lam * H[a][a] + 1e-9f : 0.0f);
          }
        }
        solve7(Hd, g, dx);
        for (int a = 0; a < 7; ++a) dx[a] = -dx[a];
        S_new = osl::sim3_compose(osl::sim3_exp(dx), S);
        pack_xform(S, sx_cur);
        pack_xform(S_new, sx_new);
      }
      __syncthreads();
      float cost[2] = {0.0f, 0.0f};  // at S_new, at S
      for (int n = threadIdx.x; n < N; n += blockDim.x) {
        if (!mask[n]) continue;
        float c1, c2;
        edge_chi2(cam, sx_new, e, n, c1, c2);
        cost[0] += huber(c1, delta) + huber(c2, delta);
        edge_chi2(cam, sx_cur, e, n, c1, c2);
        cost[1] += huber(c1, delta) + huber(c2, delta);
      }
      block_reduce(cost, red);
      if (threadIdx.x == 0) {
        better = cost[0] < cost[1];
        // each iteration's cost pair (trial, current), for a caller that
        // holds the accept decisions to another LM's
        if (costs != nullptr) {
          costs[2 * (phase * iters1 + it)] = cost[0];
          costs[2 * (phase * iters1 + it) + 1] = cost[1];
        }
        if (better) S = S_new;
        lam = fminf(fmaxf(better ? lam * 0.5f : lam * 4.0f, 1e-6f), 1e4f);
      }
      __syncthreads();
    }
    // the chi2 gate on both edges at the phase's result
    if (threadIdx.x == 0) pack_xform(S, sx_cur);
    __syncthreads();
    float n_in[1] = {0.0f};
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      float c1, c2;
      edge_chi2(cam, sx_cur, e, n, c1, c2);
      const bool inl = valid[n] && c1 <= th2 && c2 <= th2;
      mask[n] = inl;
      if (phase == 1) out[9 + n] = inl ? 1.0f : 0.0f;
      n_in[0] += inl ? 1.0f : 0.0f;
    }
    block_reduce(n_in, red);
    if (phase == 1 && threadIdx.x == 0) {
      osl::sim3_store(S, out);
      out[8] = n_in[0];
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// SearchBySim3
// ---------------------------------------------------------------------------
struct Side {
  const float* pos;     // (N, 3) points in the side's camera frame
  const uint8_t* desc;  // (N, 32)
  const uint8_t* valid;
  const float* dmax;
  const float* xy;      // (N, 2) keypoints
  const int* oct;
  int n;
};

// (s, R, t) of S21 = S12^-1 (fwd) or of S12, the inverse's rotation through
// its quaternion (ops/sim3_opt.search_parts writes the same terms)
__device__ void search_parts(const float* S12, bool fwd, float P[13]) {
  Sim3<float> S = osl::sim3_load<float>(S12);
  if (fwd) S = osl::sim3_inverse(S);
  float R[3][3];
  osl::quat_to_rotmat(S.q, R);
  P[0] = S.s;
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) P[1 + 3 * i + j] = R[i][j];
    P[10 + i] = S.t[i];
  }
}

__global__ void sim3_search_kernel(Side a, Side b, const float* __restrict__ S12,
                                   Cam cam, float log_sf,
                                   const float* __restrict__ r_table,
                                   int n_levels, int* __restrict__ idx12,
                                   int* __restrict__ idx21) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= a.n + b.n) return;  // whole warps exit together
  const bool fwd = row < a.n;    // a's points into b's image
  const Side& src = fwd ? a : b;
  const Side& dst = fwd ? b : a;
  const int i = fwd ? row : row - a.n;
  float P[13];  // S21 for a's points, S12 for b's
  search_parts(S12, fwd, P);
  const float X = src.pos[3 * i], Y = src.pos[3 * i + 1], Z = src.pos[3 * i + 2];
  float pc[3];
  for (int k = 0; k < 3; ++k) {
    pc[k] = P[0] * (P[1 + 3 * k] * X + P[2 + 3 * k] * Y + P[3 + 3 * k] * Z) + P[10 + k];
  }
  float uv[2];
  project(cam, pc, uv);
  const float dist = sqrtf(pc[0] * pc[0] + pc[1] * pc[1] + pc[2] * pc[2]);
  const bool ok = src.valid[i] && pc[2] > 0.1f && uv[0] >= 0.0f && uv[0] < cam.width &&
                  uv[1] >= 0.0f && uv[1] < cam.height;
  unsigned long long best = kNone;
  if (ok) {
    float ratio = src.dmax[i] / fmaxf(dist, 1e-9f);
    ratio = fmaxf(ratio, 1e-6f);
    // clipped before the conversion, so an infinite band gives the top level
    const int pred = static_cast<int>(
        fminf(fmaxf(ceilf(logf(ratio) / log_sf), 0.0f), static_cast<float>(n_levels - 1)));
    const float r = r_table[pred];
    const float r2 = r * r;
    const uint4* sd = reinterpret_cast<const uint4*>(src.desc + 32 * i);
    const uint4 a0 = sd[0], a1 = sd[1];
    for (int j = lane; j < dst.n; j += 32) {
      if (!dst.valid[j]) continue;
      const float dx = uv[0] - dst.xy[2 * j];
      const float dy = uv[1] - dst.xy[2 * j + 1];
      if (!(dx * dx + dy * dy <= r2)) continue;
      const int diff = dst.oct[j] - pred;
      if (diff < -1 || diff > 1) continue;
      const uint4* kd = reinterpret_cast<const uint4*>(dst.desc + 32 * j);
      const uint4 b0 = kd[0], b1 = kd[1];
      const unsigned d = __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) +
                         __popc(a0.z ^ b0.z) + __popc(a0.w ^ b0.w) +
                         __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
                         __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
      const unsigned long long key =
          (static_cast<unsigned long long>(d) << 32) | static_cast<unsigned>(j);
      best = key < best ? key : best;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long other = __shfl_xor_sync(osl::kFullMask, best, o);
    best = other < best ? other : best;
  }
  if (lane == 0) {
    const bool hit = best != kNone && static_cast<int>(best >> 32) <= kMaxDesc;
    (fwd ? idx12 : idx21)[i] = hit ? static_cast<int>(best & 0xffffffffu) : -1;
  }
}

__global__ void sim3_search_agree(const int* __restrict__ idx12,
                                  const int* __restrict__ idx21, int n1,
                                  int* __restrict__ idx2,
                                  uint8_t* __restrict__ mutual) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n1) return;
  const int j = idx12[i];
  const bool m = j >= 0 && idx21[j] == i;
  idx2[i] = m ? j : -1;
  mutual[i] = m;
}

}  // namespace

OSL_EXPORT int osl_sim3_opt(const float* S0, const float* p1, const float* p2,
                            const float* u1, const float* u2, const float* s2_1,
                            const float* s2_2, const uint8_t* valid, int N,
                            float fx, float fy, float cx, float cy,
                            int fix_scale, float th2, int iters1, int iters2,
                            float* inv1, float* inv2, uint8_t* mask, float* out,
                            float* costs, void* stream) {
  const Edge e{p1, p2, u1, u2, nullptr, nullptr};
  const Cam cam{fx, fy, cx, cy, 0.0f, 0.0f};
  sim3_opt_lm<<<1, kLmThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      S0, e, s2_1, s2_2, valid, N, cam, fix_scale, th2, iters1, iters2, inv1, inv2,
      mask, out, costs);
  return static_cast<int>(cudaGetLastError());
}

OSL_EXPORT int osl_sim3_search(
    const float* pos1, const uint8_t* desc1, const uint8_t* valid1,
    const float* dmax1, const float* xy1, const int* oct1, int n1,
    const float* pos2, const uint8_t* desc2, const uint8_t* valid2,
    const float* dmax2, const float* xy2, const int* oct2, int n2,
    const float* S12, float fx, float fy, float cx, float cy, int width,
    int height, float log_sf, const float* r_table, int n_levels, int* idx12,
    int* idx21, int* idx2, uint8_t* mutual, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Side a{pos1, desc1, valid1, dmax1, xy1, oct1, n1};
  const Side b{pos2, desc2, valid2, dmax2, xy2, oct2, n2};
  const Cam cam{fx, fy, cx, cy, static_cast<float>(width), static_cast<float>(height)};
  const int rows = n1 + n2;
  if (rows > 0) {
    sim3_search_kernel<<<(rows * 32 + 255) / 256, 256, 0, st>>>(
        a, b, S12, cam, log_sf, r_table, n_levels, idx12, idx21);
  }
  if (n1 > 0) {
    sim3_search_agree<<<(n1 + 255) / 256, 256, 0, st>>>(idx12, idx21, n1, idx2, mutual);
  }
  return static_cast<int>(cudaGetLastError());
}
