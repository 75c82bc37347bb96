// Kernel K: Sim3 RANSAC between the matched map points of two keyframes.
//
// Replaces orbslam2_tpu/ops/sim3_solver.py: sim3_ransac (the vmapped
// 3-point Horn hypotheses, the both-way reprojection inlier count, argmax,
// the weighted refit), as the loop closer calls it
// (orbslam2_tpu/loop_closing.py:170-202).
//
//   sim3_ransac_hyp     one block per hypothesis. Thread 0 solves Horn's
//                       closed form on the 3 samples in double (centroids,
//                       the 3x3 correlation, the symmetric 4x4 matrix and
//                       its largest eigenvector by cyclic Jacobi, the scale
//                       unless fix_scale) and packs the Sim3 in float; the
//                       block counts the points whose reprojections agree
//                       within th2 sigma^2 in both images (the point
//                       through S into image 1, through S^-1 into image 2,
//                       depths floored at 1e-6). A hypothesis that is not
//                       finite or has s <= 1e-4 counts -1.
//   sim3_ransac_refine  one block: the best count (first index on ties),
//                       its inliers, Horn weighted by them (the sums in a
//                       fixed order, in double), the recount, and the
//                       choice (the refit if it counts at least as many).
//                       Writes [S12 (8), n, ok, inliers (N)].
//
// Bound on the H100: the launch and the serial Horn / Jacobi of one thread,
// not bytes or operations (256 x N reprojections are ~0.1 ms of the card's
// float32 peak at N = 1024).
#include "sim3.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRefineThreads = 1024;

struct Cam {
  float fx, fy, cx, cy;
};

// Horn's rotation from the weighted correlation M = sum w sc dc^T (in
// double): the eigenvector of the largest eigenvalue of the symmetric 4x4
// matrix, packed as a Sim3 quaternion with s = 1, t = 0.
__device__ osl::Sim3<float> horn_rotation(const double M[3][3]) {
  double N[4][4], V[4][4];
  const double Sxx = M[0][0], Sxy = M[0][1], Sxz = M[0][2];
  const double Syx = M[1][0], Syy = M[1][1], Syz = M[1][2];
  const double Szx = M[2][0], Szy = M[2][1], Szz = M[2][2];
  N[0][0] = Sxx + Syy + Szz; N[0][1] = Syz - Szy; N[0][2] = Szx - Sxz; N[0][3] = Sxy - Syx;
  N[1][0] = Syz - Szy; N[1][1] = Sxx - Syy - Szz; N[1][2] = Sxy + Syx; N[1][3] = Szx + Sxz;
  N[2][0] = Szx - Sxz; N[2][1] = Sxy + Syx; N[2][2] = -Sxx + Syy - Szz; N[2][3] = Syz + Szy;
  N[3][0] = Sxy - Syx; N[3][1] = Szx + Sxz; N[3][2] = Syz + Szy; N[3][3] = -Sxx - Syy + Szz;
  osl::jacobi<4>(N, V);
  int top = 0;
  for (int i = 1; i < 4; ++i) {
    if (N[i][i] > N[top][top]) top = i;
  }
  float q[4];
  for (int i = 0; i < 4; ++i) q[i] = static_cast<float>(V[i][top]);
  float R[3][3];
  osl::quat_to_rotmat(q, R);
  osl::Sim3<float> S;
  S.s = 1.0f;
  osl::rotmat_to_quat(R, S.q);
  S.t[0] = S.t[1] = S.t[2] = 0.0f;
  return S;
}

// the translation (and scale) of a Horn solution with rotation R(S.q)
__device__ void horn_finish(osl::Sim3<float>& S, float s, const double mu_s[3],
                            const double mu_d[3]) {
  float R[3][3];
  osl::quat_to_rotmat(S.q, R);
  S.s = s;
  for (int i = 0; i < 3; ++i) {
    S.t[i] = static_cast<float>(mu_d[i]) -
             s * (R[i][0] * static_cast<float>(mu_s[0]) +
                  R[i][1] * static_cast<float>(mu_s[1]) +
                  R[i][2] * static_cast<float>(mu_s[2]));
  }
  // sim3_make packs R again through rotmat_to_quat
  osl::rotmat_to_quat(R, S.q);
}

struct Hyp {
  osl::Sim3<float> S, Si;
  float R[3][3], Ri[3][3];
};

__device__ void make_hyp(const osl::Sim3<float>& S, Hyp& h) {
  h.S = S;
  h.Si = osl::sim3_inverse(S);
  osl::quat_to_rotmat(h.S.q, h.R);
  osl::quat_to_rotmat(h.Si.q, h.Ri);
}

__device__ __forceinline__ float chi2(const Cam& c, const float pc[3],
                                      const float* ref, float s2) {
  const float z = fmaxf(pc[2], 1e-6f);
  const float u = c.fx * pc[0] / z + c.cx;
  const float v = c.fy * pc[1] / z + c.cy;
  const float zr = fmaxf(ref[2], 1e-6f);
  const float ur = c.fx * ref[0] / zr + c.cx;
  const float vr = c.fy * ref[1] / zr + c.cy;
  return ((u - ur) * (u - ur) + (v - vr) * (v - vr)) / s2;
}

__device__ __forceinline__ bool is_inlier(const Hyp& h, const Cam& c,
                                          const float* p1, const float* p2,
                                          const float* s2_1, const float* s2_2,
                                          const uint8_t* valid, int n, float th2) {
  if (!valid[n]) return false;
  const float a[3] = {p2[3 * n], p2[3 * n + 1], p2[3 * n + 2]};
  const float b[3] = {p1[3 * n], p1[3 * n + 1], p1[3 * n + 2]};
  float p21[3], p12[3];
  osl::sim3_apply(h.S, h.R, a, p21);
  osl::sim3_apply(h.Si, h.Ri, b, p12);
  return chi2(c, p21, p1 + 3 * n, s2_1[n]) < th2 &&
         chi2(c, p12, p2 + 3 * n, s2_2[n]) < th2;
}

__device__ int block_count(int v) {
  __shared__ int warp_n[32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(osl::kFullMask, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) warp_n[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) s += warp_n[w];
  return s;
}

__global__ void __launch_bounds__(kThreads)
sim3_ransac_hyp(const float* __restrict__ p1, const float* __restrict__ p2,
                const float* __restrict__ s2_1, const float* __restrict__ s2_2,
                const uint8_t* __restrict__ valid, int N,
                const int* __restrict__ samples, Cam cam, int fix_scale,
                float th2, float* __restrict__ hyps, int* __restrict__ counts) {
  __shared__ Hyp h;
  __shared__ bool usable;
  const int i = blockIdx.x;
  if (threadIdx.x == 0) {
    // Horn on the sample: src = points of 2, dst = points of 1, w = 1/3
    int idx[3];
    for (int k = 0; k < 3; ++k) idx[k] = samples[3 * i + k];
    double mu_s[3] = {0, 0, 0}, mu_d[3] = {0, 0, 0};
    for (int k = 0; k < 3; ++k) {
      for (int c = 0; c < 3; ++c) {
        mu_s[c] += static_cast<double>(p2[3 * idx[k] + c]) / 3.0;
        mu_d[c] += static_cast<double>(p1[3 * idx[k] + c]) / 3.0;
      }
    }
    double M[3][3] = {{0, 0, 0}, {0, 0, 0}, {0, 0, 0}};
    double ss = 0.0;
    for (int k = 0; k < 3; ++k) {
      double sc[3], dc[3];
      for (int c = 0; c < 3; ++c) {
        sc[c] = p2[3 * idx[k] + c] - mu_s[c];
        dc[c] = p1[3 * idx[k] + c] - mu_d[c];
      }
      for (int a = 0; a < 3; ++a) {
        for (int b = 0; b < 3; ++b) M[a][b] += sc[a] * dc[b] / 3.0;
      }
      ss += (sc[0] * sc[0] + sc[1] * sc[1] + sc[2] * sc[2]) / 3.0;
    }
    osl::Sim3<float> S = horn_rotation(M);
    float s = 1.0f;
    if (!fix_scale) {
      float R[3][3];
      osl::quat_to_rotmat(S.q, R);
      double num = 0.0;
      for (int k = 0; k < 3; ++k) {
        double sc[3], dc[3];
        for (int c = 0; c < 3; ++c) {
          sc[c] = p2[3 * idx[k] + c] - mu_s[c];
          dc[c] = p1[3 * idx[k] + c] - mu_d[c];
        }
        for (int a = 0; a < 3; ++a) {
          num += dc[a] * (R[a][0] * sc[0] + R[a][1] * sc[1] + R[a][2] * sc[2]) / 3.0;
        }
      }
      s = static_cast<float>(num / fmax(ss, 1e-8));
    }
    horn_finish(S, s, mu_s, mu_d);
    bool finite = isfinite(S.s) && S.s > 1e-4f;
    for (int k = 0; k < 4; ++k) finite = finite && isfinite(S.q[k]);
    for (int k = 0; k < 3; ++k) finite = finite && isfinite(S.t[k]);
    usable = finite;
    make_hyp(S, h);
    osl::sim3_store(S, hyps + 8 * i);
  }
  __syncthreads();
  int n_in = 0;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    n_in += is_inlier(h, cam, p1, p2, s2_1, s2_2, valid, n, th2) ? 1 : 0;
  }
  n_in = block_count(n_in);
  if (threadIdx.x == 0) counts[i] = usable ? n_in : -1;
}

// fixed-order block sums of k doubles (every thread gets them)
template <int k>
__device__ void block_sums(double (&v)[k], double* scratch) {
  for (int j = 0; j < k; ++j) v[j] = osl::block_sum(v[j], scratch);
}

__global__ void __launch_bounds__(kRefineThreads)
sim3_ransac_refine(const float* __restrict__ p1, const float* __restrict__ p2,
                   const float* __restrict__ s2_1, const float* __restrict__ s2_2,
                   const uint8_t* __restrict__ valid, int N, Cam cam,
                   int fix_scale, float th2, int min_inliers,
                   const float* __restrict__ hyps,
                   const int* __restrict__ counts, int I,
                   uint8_t* __restrict__ w_best, float* __restrict__ out) {
  __shared__ double scratch[32];
  __shared__ Hyp h;
  __shared__ int best;
  __shared__ unsigned long long best_key;
  if (threadIdx.x == 0) best_key = 0ull;
  __syncthreads();
  // argmax with the first index on ties: max of (count + 1, I - 1 - i)
  for (int i = threadIdx.x; i < I; i += blockDim.x) {
    const unsigned long long key =
        (static_cast<unsigned long long>(counts[i] + 1) << 32) |
        static_cast<unsigned>(I - 1 - i);
    atomicMax(&best_key, key);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    best = I - 1 - static_cast<int>(best_key & 0xffffffffull);
    make_hyp(osl::sim3_load<float>(hyps + 8 * best), h);
  }
  __syncthreads();
  // the best hypothesis's inliers: the refit's weights
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    w_best[n] = is_inlier(h, cam, p1, p2, s2_1, s2_2, valid, n, th2);
  }
  __syncthreads();
  double m1[7] = {0, 0, 0, 0, 0, 0, 0};  // wsum, sum w src, sum w dst
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    if (!w_best[n]) continue;
    m1[0] += 1.0;
    for (int c = 0; c < 3; ++c) {
      m1[1 + c] += p2[3 * n + c];
      m1[4 + c] += p1[3 * n + c];
    }
  }
  block_sums(m1, scratch);
  const double wsum = fmax(m1[0], 1e-8);
  const double mu_s[3] = {m1[1] / wsum, m1[2] / wsum, m1[3] / wsum};
  const double mu_d[3] = {m1[4] / wsum, m1[5] / wsum, m1[6] / wsum};
  double m2[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};  // M (9), sum w |sc|^2
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    if (!w_best[n]) continue;
    double sc[3], dc[3];
    for (int c = 0; c < 3; ++c) {
      sc[c] = p2[3 * n + c] - mu_s[c];
      dc[c] = p1[3 * n + c] - mu_d[c];
    }
    for (int a = 0; a < 3; ++a) {
      for (int b = 0; b < 3; ++b) m2[3 * a + b] += sc[a] * dc[b];
    }
    m2[9] += sc[0] * sc[0] + sc[1] * sc[1] + sc[2] * sc[2];
  }
  block_sums(m2, scratch);
  __shared__ osl::Sim3<float> S_ref;
  if (threadIdx.x == 0) {
    double M[3][3];
    for (int a = 0; a < 3; ++a) {
      for (int b = 0; b < 3; ++b) M[a][b] = m2[3 * a + b] / wsum;
    }
    S_ref = horn_rotation(M);
  }
  __syncthreads();
  float s = 1.0f;
  if (!fix_scale) {
    float R[3][3];
    osl::quat_to_rotmat(S_ref.q, R);
    double num[1] = {0.0};
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      if (!w_best[n]) continue;
      double sc[3], dc[3];
      for (int c = 0; c < 3; ++c) {
        sc[c] = p2[3 * n + c] - mu_s[c];
        dc[c] = p1[3 * n + c] - mu_d[c];
      }
      for (int a = 0; a < 3; ++a) {
        num[0] += dc[a] * (R[a][0] * sc[0] + R[a][1] * sc[1] + R[a][2] * sc[2]);
      }
    }
    block_sums(num, scratch);
    s = static_cast<float>((num[0] / wsum) / fmax(m2[9] / wsum, 1e-8));
  }
  __shared__ Hyp hr;
  if (threadIdx.x == 0) {
    osl::Sim3<float> S = S_ref;
    horn_finish(S, s, mu_s, mu_d);
    make_hyp(S, hr);
  }
  __syncthreads();
  int n_ref = 0;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    n_ref += is_inlier(hr, cam, p1, p2, s2_1, s2_2, valid, n, th2) ? 1 : 0;
  }
  n_ref = block_count(n_ref);
  const bool use_ref = n_ref >= counts[best];
  const Hyp& hu = use_ref ? hr : h;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    out[10 + n] = is_inlier(hu, cam, p1, p2, s2_1, s2_2, valid, n, th2) ? 1.0f : 0.0f;
  }
  if (threadIdx.x == 0) {
    const int n_out = use_ref ? n_ref : counts[best];
    osl::sim3_store(hu.S, out);
    out[8] = static_cast<float>(n_out);
    out[9] = n_out >= min_inliers ? 1.0f : 0.0f;
  }
}

}  // namespace

OSL_EXPORT int osl_sim3_ransac(const float* p1, const float* p2,
                               const float* s2_1, const float* s2_2,
                               const uint8_t* valid, int N, const int* samples,
                               int I, float fx, float fy, float cx, float cy,
                               int fix_scale, float th2, int min_inliers,
                               float* hyps, int* counts, uint8_t* w_best,
                               float* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Cam cam{fx, fy, cx, cy};
  sim3_ransac_hyp<<<I, kThreads, 0, st>>>(p1, p2, s2_1, s2_2, valid, N, samples,
                                          cam, fix_scale, th2, hyps, counts);
  sim3_ransac_refine<<<1, kRefineThreads, 0, st>>>(
      p1, p2, s2_1, s2_2, valid, N, cam, fix_scale, th2, min_inliers, hyps,
      counts, I, w_best, out);
  return static_cast<int>(cudaGetLastError());
}
