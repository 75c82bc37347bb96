// The device code kernels P (pose_graph.cu, the dense solver) and P'
// (pose_graph_cg.cu, the conjugate-gradient solver) share: the graph and
// its workspace (struct PG), the edge residual
// log(S_ij exp(d_j) exp(x_j) M_ij exp(-x_i) exp(-d_i)) in float or dual
// numbers, the total cost, the one-block closed-form start
// (pose_graph_prepare), the one-block step and cost test
// (pose_graph_update) and the write-back of the poses (pose_graph_finish).
// The kernels live in an anonymous namespace: each source that includes
// this header compiles its own copy (the library links without relocatable
// device code).
#pragma once

#include "sim3.cuh"

namespace {

using osl::Dual;
using osl::Sim3;
using D7 = Dual<7>;

constexpr int kThreads = 256;
constexpr int kD = 7;

struct PG {
  const float* S_init;   // (K, 8)
  const uint8_t* fixed;  // (K,)
  const uint8_t* valid;  // (K,)
  const int* ei;         // (E,)
  const int* ej;
  const float* Sij;      // (E, 8)
  const uint8_t* ev;     // (E,)
  const int* order;      // (K,) temporal vertex order
  int K, E, fix_scale;
  float* S0;             // (K, 8) recentred base
  float* Winv;           // (8,)
  float* Me;             // (E, 8) base-relative edge transforms
  float* Rl;             // (K, 8) chain links, then prefix products
  float* xa;             // (K, 7) trial corrections
  float* x;              // (K, 7) corrections
  float* r0;             // (E, 7)
  float* cost;           // (1,)
  float* lam;            // (1,)
  float* H;              // (7K, 7K), kernel P only
  float* b;              // (K, 7): the gradient, then the solved step
  int* pos;              // (K,) chain position of each vertex
  uint8_t* freeze;       // (K,)
  int* failed;           // (1,) the solve's failure flag (a pivot of F' in P)
};

__device__ __forceinline__ float block_sum(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(osl::kFullMask, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) s += scratch[w];
  __syncthreads();
  return s;
}

__device__ __forceinline__ void store7(float* p, const float v[7]) {
  for (int i = 0; i < kD; ++i) p[i] = v[i];
}

template <class T>
__device__ __forceinline__ Sim3<T> exp_of(const float* x, float sign) {
  T v[7];
  for (int i = 0; i < kD; ++i) v[i] = T(sign * x[i]);
  return osl::sim3_exp(v);
}

// the residual of edge e at corrections x_i, x_j, perturbations d_i, d_j
template <class T>
__device__ void edge_res(const T di[7], const T dj[7], const float* xi,
                         const float* xj, const float* M, const float* Sij,
                         T r[7]) {
  T ndi[7];
  for (int k = 0; k < kD; ++k) ndi[k] = -di[k];
  Sim3<T> A = osl::sim3_compose(osl::sim3_load<T>(Sij), osl::sim3_exp(dj));
  A = osl::sim3_compose(A, exp_of<T>(xj, 1.0f));
  A = osl::sim3_compose(A, osl::sim3_load<T>(M));
  A = osl::sim3_compose(A, exp_of<T>(xi, -1.0f));
  A = osl::sim3_compose(A, osl::sim3_exp(ndi));
  osl::sim3_log(A, r);
}

__device__ float edge_cost(const PG& p, int e, const float* x) {
  if (!p.ev[e]) return 0.0f;
  const float z[7] = {0, 0, 0, 0, 0, 0, 0};
  float r[7];
  edge_res<float>(z, z, x + kD * p.ei[e], x + kD * p.ej[e], p.Me + 8 * e,
                  p.Sij + 8 * e, r);
  float s = 0.0f;
  for (int k = 0; k < kD; ++k) s += r[k] * r[k];
  return s;
}

// the total cost at corrections x (every thread of the block gets it)
__device__ float total_cost(const PG& p, const float* x, float* scratch) {
  float s = 0.0f;
  for (int e = threadIdx.x; e < p.E; e += blockDim.x) s += edge_cost(p, e, x);
  return block_sum(s, scratch);
}

__global__ void __launch_bounds__(kThreads) pose_graph_prepare(PG p) {
  __shared__ float scratch[32];
  __shared__ Sim3<float> W;
  __shared__ float gvec[7];
  __shared__ float pa, pb;
  __shared__ unsigned long long best_key;
  const int K = p.K, E = p.E, tid = threadIdx.x;
  // gauge recentring: camera centres of the live vertices
  float acc[4] = {0, 0, 0, 0};
  for (int k = tid; k < K; k += blockDim.x) {
    p.freeze[k] = p.fixed[k] || !p.valid[k];
    if (!p.valid[k]) continue;
    const Sim3<float> S = osl::sim3_load<float>(p.S_init + 8 * k);
    float R[3][3];
    osl::quat_to_rotmat(S.q, R);
    for (int i = 0; i < 3; ++i) {
      acc[i] += -(R[0][i] * S.t[0] + R[1][i] * S.t[1] + R[2][i] * S.t[2]) / S.s;
    }
    acc[3] += 1.0f;
  }
  for (int i = 0; i < 4; ++i) acc[i] = block_sum(acc[i], scratch);
  const float nv = osl::nan_max(acc[3], 1.0f);
  const float c0[3] = {acc[0] / nv, acc[1] / nv, acc[2] / nv};
  float spread = 0.0f;
  for (int k = tid; k < K; k += blockDim.x) {
    if (!p.valid[k]) continue;
    const Sim3<float> S = osl::sim3_load<float>(p.S_init + 8 * k);
    float R[3][3];
    osl::quat_to_rotmat(S.q, R);
    for (int i = 0; i < 3; ++i) {
      const float c =
          -(R[0][i] * S.t[0] + R[1][i] * S.t[1] + R[2][i] * S.t[2]) / S.s - c0[i];
      spread += c * c;
    }
  }
  spread = block_sum(spread, scratch);
  if (tid == 0) {
    const float L = osl::nan_max(sqrtf(spread / nv), 1.0f);
    const float I3[3][3] = {{1, 0, 0}, {0, 1, 0}, {0, 0, 1}};
    W = osl::sim3_make(L, I3, c0);
    osl::sim3_store(osl::sim3_inverse(W), p.Winv);
  }
  __syncthreads();
  for (int k = tid; k < K; k += blockDim.x) {
    osl::sim3_store(osl::sim3_compose(osl::sim3_load<float>(p.S_init + 8 * k), W),
                    p.S0 + 8 * k);
    p.pos[p.order[k]] = k;
  }
  __syncthreads();
  for (int e = tid; e < E; e += blockDim.x) {
    const Sim3<float> Si = osl::sim3_load<float>(p.S0 + 8 * p.ei[e]);
    const Sim3<float> Sj = osl::sim3_load<float>(p.S0 + 8 * p.ej[e]);
    osl::sim3_store(osl::sim3_compose(Sj, osl::sim3_inverse(Si)), p.Me + 8 * e);
  }
  // chain links: the measured edge (a, b) or (b, a) of consecutive vertices,
  // the first such edge in edge order, else the current relative
  for (int k = tid; k < K; k += blockDim.x) {
    const int a = p.order[k], bb = p.order[(k + K - 1) % K];
    int fwd = -1, rev = -1;
    for (int e = 0; e < E && (fwd < 0 || rev < 0); ++e) {
      if (!p.ev[e]) continue;
      if (fwd < 0 && p.ei[e] == a && p.ej[e] == bb) fwd = e;
      if (rev < 0 && p.ei[e] == bb && p.ej[e] == a) rev = e;
    }
    Sim3<float> R;
    if (k == 0) {
      R.s = 1.0f;
      R.q[0] = 1.0f;
      R.q[1] = R.q[2] = R.q[3] = 0.0f;
      R.t[0] = R.t[1] = R.t[2] = 0.0f;
    } else if (fwd >= 0) {
      R = osl::sim3_load<float>(p.Sij + 8 * fwd);
    } else if (rev >= 0) {
      R = osl::sim3_inverse(osl::sim3_load<float>(p.Sij + 8 * rev));
    } else {
      R = osl::sim3_compose(osl::sim3_load<float>(p.S0 + 8 * a),
                            osl::sim3_inverse(osl::sim3_load<float>(p.S0 + 8 * bb)));
    }
    osl::sim3_store(R, p.Rl + 8 * k);
  }
  __syncthreads();
  if (tid == 0) {  // Q_k = R_k Q_{k-1}, in place
    Sim3<float> Q = osl::sim3_load<float>(p.Rl);
    for (int k = 1; k < K; ++k) {
      Q = osl::sim3_compose(osl::sim3_load<float>(p.Rl + 8 * k), Q);
      osl::sim3_store(Q, p.Rl + 8 * k);
    }
  }
  __syncthreads();
  const Sim3<float> S0p0 = osl::sim3_load<float>(p.S0 + 8 * p.order[0]);
  for (int k = tid; k < K; k += blockDim.x) {
    const int v = p.order[k];
    float xv[7] = {0, 0, 0, 0, 0, 0, 0};
    if (!p.freeze[v]) {
      const Sim3<float> Sint = osl::sim3_compose(osl::sim3_load<float>(p.Rl + 8 * k), S0p0);
      osl::sim3_log(osl::sim3_compose(
                        Sint, osl::sim3_inverse(osl::sim3_load<float>(p.S0 + 8 * v))),
                    xv);
    }
    store7(p.xa + kD * v, xv);
    const float z[7] = {0, 0, 0, 0, 0, 0, 0};
    store7(p.x + kD * v, z);
  }
  __syncthreads();
  const float c_int = total_cost(p, p.xa, scratch);
  const float c_zero = total_cost(p, p.x, scratch);
  if (c_int < c_zero) {
    for (int t = tid; t < kD * K; t += blockDim.x) p.x[t] = p.xa[t];
  }
  __syncthreads();
  // the strongest long-range edge: residual norm x chain span
  if (tid == 0) best_key = 0ull;
  __syncthreads();
  float c_best = 0.0f;
  for (int e = tid; e < E; e += blockDim.x) {
    const float z[7] = {0, 0, 0, 0, 0, 0, 0};
    float r[7];
    edge_res<float>(z, z, p.x + kD * p.ei[e], p.x + kD * p.ej[e], p.Me + 8 * e,
                    p.Sij + 8 * e, r);
    store7(p.r0 + kD * e, r);
    float n2 = 0.0f;
    for (int k = 0; k < kD; ++k) n2 += r[k] * r[k];
    const float ew = p.ev[e] ? 1.0f : 0.0f;
    c_best += n2 * ew;
    const float span = fabsf(static_cast<float>(p.pos[p.ei[e]] - p.pos[p.ej[e]]));
    const float score = sqrtf(n2) * span * ew;
    const unsigned long long key =
        (static_cast<unsigned long long>(__float_as_uint(score)) << 32) |
        static_cast<unsigned>(E - 1 - e);
    atomicMax(&best_key, key);
  }
  c_best = block_sum(c_best, scratch);
  if (tid == 0) {
    const int e = E - 1 - static_cast<int>(best_key & 0xffffffffull);
    const int li = p.ei[e], lj = p.ej[e];
    float el[7];
    for (int k = 0; k < kD; ++k) el[k] = p.r0[kD * e + k];
    if (p.fix_scale) el[6] = 0.0f;
    const bool swap = p.pos[li] > p.pos[lj];
    pa = static_cast<float>(min(p.pos[li], p.pos[lj]));
    pb = static_cast<float>(max(p.pos[li], p.pos[lj]));
    const Sim3<float> Si = osl::sim3_compose(exp_of<float>(p.x + kD * li, 1.0f),
                                             osl::sim3_load<float>(p.S0 + 8 * li));
    const Sim3<float> G = osl::sim3_compose(
        osl::sim3_inverse(Si),
        osl::sim3_compose(exp_of<float>(el, swap ? 1.0f : -1.0f), Si));
    osl::sim3_log(G, gvec);
  }
  __syncthreads();
  for (int k = tid; k < K; k += blockDim.x) {
    float w = osl::nan_min(
        osl::nan_max((static_cast<float>(p.pos[k]) - pa) / osl::nan_max(pb - pa, 1.0f),
                     0.0f), 1.0f);
    if (p.freeze[k]) w = 0.0f;
    float wg[7];
    for (int i = 0; i < kD; ++i) wg[i] = w * gvec[i];
    const Sim3<float> S0k = osl::sim3_load<float>(p.S0 + 8 * k);
    const Sim3<float> inner = osl::sim3_compose(
        S0k, osl::sim3_compose(osl::sim3_exp(wg), osl::sim3_inverse(S0k)));
    float xr[7];
    osl::sim3_log(osl::sim3_compose(exp_of<float>(p.x + kD * k, 1.0f), inner), xr);
    store7(p.xa + kD * k, xr);
  }
  __syncthreads();
  const float c_ramp = total_cost(p, p.xa, scratch);
  if (c_ramp < c_best) {
    for (int t = tid; t < kD * K; t += blockDim.x) p.x[t] = p.xa[t];
  }
  if (tid == 0) {
    p.cost[0] = c_ramp < c_best ? c_ramp : c_best;
    p.lam[0] = 1e-8f;
  }
}

__global__ void __launch_bounds__(kThreads) pose_graph_update(PG p) {
  __shared__ float scratch[32];
  __shared__ bool accept;
  const float nan = __int_as_float(0x7fc00000);
  for (int k = threadIdx.x; k < p.K; k += blockDim.x) {
    float dx[7];
    for (int i = 0; i < kD; ++i) dx[i] = *p.failed ? nan : -p.b[kD * k + i];
    if (p.fix_scale) dx[6] = 0.0f;
    if (p.freeze[k]) {
      for (int i = 0; i < kD; ++i) dx[i] = 0.0f;
    }
    float xn[7];
    osl::sim3_log(osl::sim3_compose(osl::sim3_exp(dx), exp_of<float>(p.x + kD * k, 1.0f)),
                  xn);
    store7(p.xa + kD * k, xn);
  }
  __syncthreads();
  const float c_new = total_cost(p, p.xa, scratch);
  if (threadIdx.x == 0) {
    accept = c_new < p.cost[0];
    p.lam[0] = accept ? osl::nan_max(p.lam[0] * 0.2f, 1e-12f) : p.lam[0] * 4.0f;
    if (accept) p.cost[0] = c_new;
  }
  __syncthreads();
  if (accept) {
    for (int t = threadIdx.x; t < kD * p.K; t += blockDim.x) p.x[t] = p.xa[t];
  }
}

__global__ void pose_graph_finish(PG p, float* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k == 0) out[8 * p.K] = p.cost[0];
  if (k >= p.K) return;
  const Sim3<float> S = osl::sim3_compose(
      osl::sim3_compose(exp_of<float>(p.x + kD * k, 1.0f),
                        osl::sim3_load<float>(p.S0 + 8 * k)),
      osl::sim3_load<float>(p.Winv));
  osl::sim3_store(S, out + 8 * k);
}

// lays out the workspace both kernels share, in this order: S0, W^-1, M_e,
// the chain links, the trial and current corrections, r0, cost and lam
// (floats); the chain positions, the failure flag of the solve and the
// frozen flags (ints). Returns the first float after them.
inline float* layout_common(PG& p, float* ws, int* iws) {
  const size_t K = p.K, E = p.E;
  float* w = ws;
  p.S0 = w; w += 8 * K;
  p.Winv = w; w += 8;
  p.Me = w; w += 8 * E;
  p.Rl = w; w += 8 * K;
  p.xa = w; w += kD * K;
  p.x = w; w += kD * K;
  p.r0 = w; w += kD * E;
  p.cost = w; w += 1;
  p.lam = w; w += 1;
  p.pos = iws;
  p.failed = iws + K;
  p.freeze = reinterpret_cast<uint8_t*>(iws + K + 1);
  return w;
}

}  // namespace
