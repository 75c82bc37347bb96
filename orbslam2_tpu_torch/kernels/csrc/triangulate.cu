// Kernel S: local mapping's triangulation against B neighbour keyframes,
// two launches.
//
// Replaces orbslam2_tpu/local_mapping.py: _triangulate_one_neighbor (vmapped
// over the neighbours by _triangulate_neighbors_kernel / _mirror):
// SearchForTriangulation (epipolar gate, TH_LOW, ratio 0.6, mutual best),
// the DLT of ops/geometry.triangulate_dlt, the choice between the DLT and a
// depth unprojection by parallax cosines, and the acceptance gates
// (cheirality, chi2 with the u_right residual, parallax, scale consistency).
//
// Bound on the H100: the pair gate. At B = 10 neighbours x N = 1024 x 1024
// keypoints the reference builds (B, N, N) epipolar distances, a pair mask
// and a Hamming matrix, and takes top-2 along both axes; the epipolar band
// admits a small share of the pairs, and the geometry runs per matched pair.
// Design. Launch 1 (match): a block per (neighbour, 32 current-keyframe
// keypoints), eight warps, a warp per keypoint i. The block stages the
// neighbour's keypoints as (x, y, 3.84 sigma^2 of their level; -1 where not
// available) in shared memory. A warp computes i's epipolar line
// (a, b, c) = F21 (x, y, 1) term by term and scans the neighbour's keypoints
// j = lane, lane + 32, ...: num = a x + b y + c, d2 = num^2 / max(a^2 + b^2,
// 1e-12), the same float32 operations as the plain version. An admitted pair
// costs eight __popc; the lanes keep best and second-best (distance << 32 |
// index) keys, and the pair posts (distance << 32 | i) to keypoint j's
// column by a 64-bit atomicMin, whose minimum is the column's best with the
// first index on ties: the mutual check needs no second pass over the
// pairs. A butterfly merge gives the row's best and second as masked_top2
// does. Launch 2 (geometry): a thread per (neighbour, i) applies TH_LOW, the
// 0.6 ratio and the mutual check (the column's key names i), then for a
// match the 4x4 Gram of the DLT rows, its diagonal equilibration and damping,
// three inverse iterations through the unrolled 4x4 Cholesky of
// ops/linalg_small.solve_spd_small, the parallax-cosine source choice, the
// unprojection and the gates, and writes X, good and the match index. The
// column keys are reset by a memset in the same entry point. F21, the
// projection matrices and K^-1 are small torch products made by the
// wrapper, on the host. Built without FMA contraction, with every sum in
// the order the plain version writes it: the match indices are bit-exact,
// and X and good too unless cosf / atan2f round apart from PyTorch's.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 32;  // current-keyframe keypoints per block
constexpr int kInvalid = 0x7fffffff / 2;  // matching.INVALID
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNone =
    (static_cast<unsigned long long>(kInvalid) << 32) | 0xffffffffull;

__device__ __forceinline__ void merge(unsigned long long& b,
                                      unsigned long long& s,
                                      unsigned long long ob,
                                      unsigned long long os) {
  if (ob < b) {
    s = (b < os) ? b : os;
    b = ob;
  } else {
    s = (s < ob) ? s : ob;
  }
}

using osl::clamp_min;
using osl::dlt;

__global__ void __launch_bounds__(kWarps * 32) triangulate_match_kernel(
    const uint8_t* __restrict__ desc1, const float* __restrict__ xy1,
    const uint8_t* __restrict__ avail1, const uint8_t* __restrict__ desc2,
    const float* __restrict__ xy2, const int* __restrict__ oct2,
    const uint8_t* __restrict__ avail2, const float* __restrict__ F21, int N,
    const float* __restrict__ sig2_table, int* __restrict__ row_best,
    int* __restrict__ row_second, int* __restrict__ row_idx,
    unsigned long long* __restrict__ col_key) {
  extern __shared__ float smem[];
  float* kx = smem;
  float* ky = smem + N;
  float* thr = smem + 2 * N;
  const int nb = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long base = (long long)N * nb;
  for (int j = tid; j < N; j += kWarps * 32) {
    kx[j] = xy2[2 * (base + j)];
    ky[j] = xy2[2 * (base + j) + 1];
    thr[j] = avail2[base + j] ? 3.84f * sig2_table[oct2[base + j]] : -1.0f;
  }
  __syncthreads();
  const float* F = F21 + 9 * nb;
  const uint8_t* d2_base = desc2 + 32 * base;
  for (int k = 0; k < kRows / kWarps; ++k) {
    const int i = blockIdx.x * kRows + warp + kWarps * k;
    if (i >= N) break;
    unsigned long long b = kNone;
    unsigned long long s = kNone;
    if (avail1[i]) {
      const float x = xy1[2 * i], y = xy1[2 * i + 1];
      const float la = x * F[0] + y * F[1] + F[2];
      const float lb = x * F[3] + y * F[4] + F[5];
      const float lc = x * F[6] + y * F[7] + F[8];
      const float den = clamp_min(la * la + lb * lb, 1e-12f);
      const uint4* rd = reinterpret_cast<const uint4*>(desc1 + 32 * i);
      const uint4 a0 = rd[0];
      const uint4 a1 = rd[1];
      for (int j = lane; j < N; j += 32) {
        const float num = la * kx[j] + lb * ky[j] + lc;
        if (!((num * num) / den < thr[j])) continue;
        const uint4* kd = reinterpret_cast<const uint4*>(d2_base + 32 * j);
        const uint4 b0 = kd[0];
        const uint4 b1 = kd[1];
        const int d = __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) +
                      __popc(a0.z ^ b0.z) + __popc(a0.w ^ b0.w) +
                      __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
                      __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
        const unsigned long long dk = static_cast<unsigned long long>(d) << 32;
        merge(b, s, dk | static_cast<unsigned int>(j), kNone);
        atomicMin(col_key + base + j, dk | static_cast<unsigned int>(i));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long ob = __shfl_xor_sync(kFull, b, o);
      const unsigned long long os = __shfl_xor_sync(kFull, s, o);
      merge(b, s, ob, os);
    }
    if (lane == 0) {
      const int bd = static_cast<int>(b >> 32);
      row_best[base + i] = bd;
      row_second[base + i] = static_cast<int>(s >> 32);
      row_idx[base + i] = (bd == kInvalid) ? 0 : static_cast<int>(b & 0xffffffffu);
    }
  }
}

struct Geo {
  float fx, fy, cx, cy;  // from K on the device
  float baseline, bf, sf;
  int n_levels;
};

// -R^T t of a row-major 4x4
__device__ __forceinline__ void centre(const float* T, float C[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    C[k] = -(T[k] * T[3] + T[4 + k] * T[7] + T[8 + k] * T[11]);
  }
}

// R^T (Kinv (x, y, 1)): the bearing of a pixel in the world frame
__device__ __forceinline__ void ray(const float* T, const float* Kinv, float x,
                                   float y, float r[3]) {
  float h[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) h[k] = x * Kinv[3 * k] + y * Kinv[3 * k + 1] + Kinv[3 * k + 2];
#pragma unroll
  for (int k = 0; k < 3; ++k) r[k] = h[0] * T[k] + h[1] * T[4 + k] + h[2] * T[8 + k];
}

__device__ __forceinline__ void unproject(const float* T, const Geo& g, float x,
                                          float y, float d, float X[3]) {
  const float pc[3] = {(x - g.cx) / g.fx * d, (y - g.cy) / g.fy * d, d};
  float C[3];
  centre(T, C);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    X[k] = pc[0] * T[k] + pc[1] * T[4 + k] + pc[2] * T[8 + k] + C[k];
  }
}

__device__ __forceinline__ float norm3(const float v[3]) {
  return sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
}

// chi2 gate of one view: 5.991 sigma^2 mono, 7.8 sigma^2 with u_right
__device__ __forceinline__ bool reproj_ok(const float* T, const float X[3],
                                          const Geo& g, float x, float y,
                                          float sig2, float ur) {
  float pc[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    pc[k] = T[4 * k] * X[0] + T[4 * k + 1] * X[1] + T[4 * k + 2] * X[2] + T[4 * k + 3];
  }
  const float z = clamp_min(pc[2], 1e-9f);
  const float u = g.fx * pc[0] / z + g.cx;
  const float v = g.fy * pc[1] / z + g.cy;
  const float e2 = (u - x) * (u - x) + (v - y) * (v - y);
  if (ur >= 0.0f) {
    const float er = u - g.bf / z - ur;
    return e2 + er * er <= 7.8f * sig2;
  }
  return e2 <= 5.991f * sig2;
}

__device__ __forceinline__ float depth_z(const float* T, const float X[3]) {
  return T[8] * X[0] + T[9] * X[1] + T[10] * X[2] + T[11];
}

__global__ void triangulate_geom_kernel(
    const int* __restrict__ row_best, const int* __restrict__ row_second,
    const int* __restrict__ row_idx,
    const unsigned long long* __restrict__ col_key,
    const uint8_t* __restrict__ avail1, const float* __restrict__ xy1,
    const int* __restrict__ oct1, const float* __restrict__ depth1,
    const float* __restrict__ ur1, const float* __restrict__ T1,
    const float* __restrict__ xy2, const int* __restrict__ oct2,
    const float* __restrict__ depth2, const float* __restrict__ ur2,
    const float* __restrict__ T2, const uint8_t* __restrict__ nb_ok,
    const float* __restrict__ P1, const float* __restrict__ P2,
    const float* __restrict__ Kinv, const float* __restrict__ K, int B, int N,
    Geo g,
    const float* __restrict__ sig2_table, const float* __restrict__ sf_pow,
    int max_dist, float nn_ratio, float* __restrict__ X_out,
    uint8_t* __restrict__ good_out, int* __restrict__ idx_out) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= (long long)B * N) return;
  g.fx = K[0];
  g.fy = K[4];
  g.cx = K[2];
  g.cy = K[5];
  const int nb = static_cast<int>(r / N);
  const int i = static_cast<int>(r - (long long)nb * N);
  const int best = row_best[r];
  const int j = row_idx[r];
  bool ok = best <= max_dist && avail1[i] &&
            static_cast<float>(best) < nn_ratio * static_cast<float>(row_second[r]);
  ok = ok && static_cast<unsigned int>(col_key[(long long)nb * N + j] & 0xffffffffull) ==
                 static_cast<unsigned int>(i);
  idx_out[r] = ok ? j : -1;
  bool good = false;
  float Xs[3] = {0.0f, 0.0f, 0.0f};
  if (ok) {
    const long long q = (long long)nb * N + j;
    const float* Tb = T2 + 16 * nb;
    const float x1 = xy1[2 * i], y1 = xy1[2 * i + 1];
    const float x2 = xy2[2 * q], y2 = xy2[2 * q + 1];
    const float dep1 = depth1[i], dep2 = depth2[q];
    const int o1 = oct1[i], o2 = oct2[q];

    float Xd[3];
    dlt(P1, P2 + 12 * nb, x1, y1, x2, y2, Xd);
    float r1[3], r2[3];
    ray(T1, Kinv, x1, y1, r1);
    ray(Tb, Kinv, x2, y2, r2);
    const float cos_rays = (r1[0] * r2[0] + r1[1] * r2[1] + r1[2] * r2[2]) /
                           clamp_min(norm3(r1) * norm3(r2), 1e-12f);
    const bool has1 = dep1 > 0.0f, has2 = dep2 > 0.0f;
    const float half_b = g.baseline * 0.5f;
    const float cosp1 = has1 ? cosf(2.0f * atan2f(half_b, dep1)) : 2.0f;
    const float cosp2 = has2 ? cosf(2.0f * atan2f(half_b, dep2)) : 2.0f;
    const float cosp_st = fminf(cosp1, cosp2);
    const bool use_dlt = cos_rays < cosp_st && cos_rays > 0.0f &&
                         (has1 || has2 || cos_rays < 0.9998f);
    float X[3] = {nanf(""), nanf(""), nanf("")};
    if (use_dlt) {
      X[0] = Xd[0]; X[1] = Xd[1]; X[2] = Xd[2];
    }
    const bool pick1 = !use_dlt && has1 && cosp1 <= cosp2;
    const bool pick2 = !use_dlt && has2 && !pick1;
    if (pick1) unproject(T1, g, x1, y1, dep1, X);
    if (pick2) unproject(Tb, g, x2, y2, dep2, X);
    const bool finite = isfinite(X[0]) && isfinite(X[1]) && isfinite(X[2]);
    if (finite) {
      Xs[0] = X[0]; Xs[1] = X[1]; Xs[2] = X[2];
    }
    const bool z_ok = depth_z(T1, Xs) > 0.05f && depth_z(Tb, Xs) > 0.05f;
    const bool r_ok = reproj_ok(T1, Xs, g, x1, y1, sig2_table[o1], ur1[i]) &&
                      reproj_ok(Tb, Xs, g, x2, y2, sig2_table[o2], ur2[q]);
    float C1[3], C2[3], n1[3], n2[3];
    centre(T1, C1);
    centre(Tb, C2);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      n1[k] = Xs[k] - C1[k];
      n2[k] = Xs[k] - C2[k];
    }
    const float d1 = norm3(n1), d2 = norm3(n2);
    const float cos_par = (n1[0] * n2[0] + n1[1] * n2[1] + n1[2] * n2[2]) /
                          clamp_min(d1 * d2, 1e-12f);
    const bool par_ok = cos_par < 0.9998f || !use_dlt;
    const float ratio_dist = d2 / clamp_min(d1, 1e-9f);
    const float ratio_oct = sf_pow[o2 - o1 + g.n_levels - 1];
    const bool sc_ok = ratio_dist < ratio_oct * g.sf * 1.5f &&
                       ratio_dist > ratio_oct / (g.sf * 1.5f);
    good = nb_ok[nb] && finite && z_ok && r_ok && par_ok && sc_ok;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) X_out[3 * r + k] = good ? Xs[k] : 0.0f;
  good_out[r] = good;
}

}  // namespace

OSL_EXPORT int osl_triangulate(
    const uint8_t* desc1, const float* xy1, const int* oct1,
    const uint8_t* avail1, const float* depth1, const float* ur1,
    const float* T1, const uint8_t* desc2, const float* xy2, const int* oct2,
    const uint8_t* avail2, const float* depth2, const float* ur2,
    const float* T2, const uint8_t* nb_ok, int B, int N, const float* F21,
    const float* P1, const float* P2, const float* Kinv, const float* K,
    float baseline, float bf, float sf, int n_levels,
    const float* sig2_table, const float* sf_pow, int max_dist, float nn_ratio,
    int* row_best, int* row_second, int* row_idx, unsigned long long* col_key,
    float* X, uint8_t* good, int* idx, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      col_key, 0xff, sizeof(unsigned long long) * B * N, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kRows - 1) / kRows, B);
  triangulate_match_kernel<<<grid, kWarps * 32, 3 * sizeof(float) * N, s>>>(
      desc1, xy1, avail1, desc2, xy2, oct2, avail2, F21, N, sig2_table,
      row_best, row_second, row_idx, col_key);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Geo g{0.0f, 0.0f, 0.0f, 0.0f, baseline, bf, sf, n_levels};
  const int threads = 128;
  const int blocks = static_cast<int>(((long long)B * N + threads - 1) / threads);
  triangulate_geom_kernel<<<blocks, threads, 0, s>>>(
      row_best, row_second, row_idx, col_key, avail1, xy1, oct1, depth1, ur1,
      T1, xy2, oct2, depth2, ur2, T2, nb_ok, P1, P2, Kinv, K, B, N, g,
      sig2_table,
      sf_pow, max_dist, nn_ratio, X, good, idx);
  return static_cast<int>(cudaGetLastError());
}
