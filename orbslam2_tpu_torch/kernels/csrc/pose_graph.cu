// Kernel P: the 7-DoF Sim3 essential-graph optimization, dense path (K19).
//
// Replaces orbslam2_tpu/ops/pose_graph.py: optimize_pose_graph /
// pose_graph_impl for K <= 384 (the closed-form start of :158-301 and the
// dense LM step of :303-345 with the accept of :466-481), as the loop
// closer calls it (orbslam2_tpu/loop_closing.py:497-587).
//
//   pose_graph_prepare    one block: gauge recentring (S0 = S_init W with W
//                         the camera-centre centroid and spread), the
//                         base-relative edge transforms M_ij = S0_j S0_i^-1,
//                         the chain re-integration of the measured temporal
//                         links (a serial prefix product by one thread), the
//                         loop-aware ramp from the strongest long-range edge,
//                         each kept only if it lowers the total cost.
//   per LM iteration (iters of them):
//     pose_graph_linearize  a thread per edge: the residual
//                           log(S_ij exp(d_j) exp(x_j) M_ij exp(-x_i)
//                           exp(-d_i)) and its Jacobians with respect to d_i
//                           and d_j at d = 0 in dual numbers (7 tangents, two
//                           passes), the edge's four 7 x 7 blocks and two
//                           gradient blocks added to the dense (7K)^2 system
//                           (float atomics);
//     pose_graph_system     frozen (fixed or dead) vertices as identity rows,
//                           + lam I, the gradient of frozen rows zeroed;
//     kernel F' (cholesky.cu) factorises and solves it;
//     pose_graph_update     one block: dx = -solution (the scale component
//                           zeroed for fix_scale, frozen rows 0),
//                           x' = log(exp(dx) exp(x)), the total cost at x',
//                           accept if lower (lam x0.2, floor 1e-12) or not
//                           (lam x4).
//   pose_graph_finish     S_k = exp(x_k) S0_k W^-1.
// All state stays on the device: one LM iteration is 4 launches and a
// memset plus the 3 ceil(7K / 32) + 1 of F'. Sums over vertices and edges
// run in a fixed order; the system is accumulated with float atomics.
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
  float* H;              // (7K, 7K)
  float* b;              // (7K,)
  int* pos;              // (K,) chain position of each vertex
  uint8_t* freeze;       // (K,)
  int* failed;           // (1,) the pivot flag of F'
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
  const float nv = fmaxf(acc[3], 1.0f);
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
    const float L = fmaxf(sqrtf(spread / nv), 1.0f);
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
    float w = fminf(fmaxf((static_cast<float>(p.pos[k]) - pa) / fmaxf(pb - pa, 1.0f),
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

__global__ void __launch_bounds__(64) pose_graph_linearize(PG p) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= p.E || !p.ev[e]) return;
  const int i = p.ei[e], j = p.ej[e];
  const float* xi = p.x + kD * i;
  const float* xj = p.x + kD * j;
  D7 seed[7], zero[7], r[7];
  for (int k = 0; k < kD; ++k) {
    seed[k] = D7(0.0f);
    seed[k].d[k] = 1.0f;
    zero[k] = D7(0.0f);
  }
  float Ji[7][7], Jj[7][7], rv[7];
  edge_res<D7>(seed, zero, xi, xj, p.Me + 8 * e, p.Sij + 8 * e, r);
  for (int a = 0; a < kD; ++a) {
    rv[a] = r[a].v;
    for (int c = 0; c < kD; ++c) Ji[a][c] = r[a].d[c];
  }
  edge_res<D7>(zero, seed, xi, xj, p.Me + 8 * e, p.Sij + 8 * e, r);
  for (int a = 0; a < kD; ++a) {
    for (int c = 0; c < kD; ++c) Jj[a][c] = r[a].d[c];
  }
  const int n = kD * p.K;
  for (int a = 0; a < kD; ++a) {
    float gi = 0.0f, gj = 0.0f;
    for (int q = 0; q < kD; ++q) {
      gi += Ji[q][a] * rv[q];
      gj += Jj[q][a] * rv[q];
    }
    atomicAdd(p.b + kD * i + a, gi);
    atomicAdd(p.b + kD * j + a, gj);
    for (int c = 0; c < kD; ++c) {
      float hii = 0.0f, hjj = 0.0f, hij = 0.0f;
      for (int q = 0; q < kD; ++q) {
        hii += Ji[q][a] * Ji[q][c];
        hjj += Jj[q][a] * Jj[q][c];
        hij += Ji[q][a] * Jj[q][c];
      }
      atomicAdd(p.H + static_cast<size_t>(kD * i + a) * n + kD * i + c, hii);
      atomicAdd(p.H + static_cast<size_t>(kD * j + a) * n + kD * j + c, hjj);
      atomicAdd(p.H + static_cast<size_t>(kD * i + a) * n + kD * j + c, hij);
      atomicAdd(p.H + static_cast<size_t>(kD * j + c) * n + kD * i + a, hij);
    }
  }
}

__global__ void pose_graph_system(PG p) {
  const int n = kD * p.K;
  const size_t t = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t < static_cast<size_t>(n) && p.freeze[t / kD]) p.b[t] = 0.0f;
  if (t >= static_cast<size_t>(n) * n) return;
  const int r = static_cast<int>(t / n), c = static_cast<int>(t % n);
  if (c > r) return;
  const bool fr = p.freeze[r / kD], fc = p.freeze[c / kD];
  float h = (fr || fc) ? 0.0f : p.H[t];
  if (r == c) h = h + (fr ? 1.0f : 0.0f) + p.lam[0];
  p.H[t] = h;
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
    p.lam[0] = accept ? fmaxf(p.lam[0] * 0.2f, 1e-12f) : p.lam[0] * 4.0f;
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

}  // namespace

OSL_EXPORT int osl_cholesky_solve_blocked(float* A, int n, float* b, int* failed,
                                          void* stream);

OSL_EXPORT int osl_pose_graph(const float* S_init, const uint8_t* fixed,
                              const uint8_t* valid, const int* ei, const int* ej,
                              const float* Sij, const uint8_t* ev,
                              const int* order, int K, int E, int iters,
                              int fix_scale, float* ws, int* iws, float* out,
                              void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n = static_cast<size_t>(kD) * K;
  PG p;
  p.S_init = S_init; p.fixed = fixed; p.valid = valid; p.ei = ei; p.ej = ej;
  p.Sij = Sij; p.ev = ev; p.order = order; p.K = K; p.E = E;
  p.fix_scale = fix_scale;
  // the float workspace, in this order (pose_graph.workspace_sizes)
  float* w = ws;
  p.S0 = w; w += 8 * K;
  p.Winv = w; w += 8;
  p.Me = w; w += 8 * static_cast<size_t>(E);
  p.Rl = w; w += 8 * K;
  p.xa = w; w += kD * K;
  p.x = w; w += kD * K;
  p.r0 = w; w += kD * static_cast<size_t>(E);
  p.cost = w; w += 1;
  p.lam = w; w += 1;
  p.H = w; w += n * n;
  p.b = w;
  p.pos = iws;
  p.failed = iws + K;
  p.freeze = reinterpret_cast<uint8_t*>(iws + K + 1);
  pose_graph_prepare<<<1, kThreads, 0, st>>>(p);
  for (int it = 0; it < iters; ++it) {
    cudaMemsetAsync(p.H, 0, (n * n + n) * sizeof(float), st);
    if (E > 0) pose_graph_linearize<<<(E + 63) / 64, 64, 0, st>>>(p);
    pose_graph_system<<<static_cast<unsigned>((n * n + 255) / 256), 256, 0, st>>>(p);
    const int err = osl_cholesky_solve_blocked(p.H, static_cast<int>(n), p.b,
                                               p.failed, stream);
    if (err != 0) return err;
    pose_graph_update<<<1, kThreads, 0, st>>>(p);
  }
  pose_graph_finish<<<(K + 127) / 128, 128, 0, st>>>(p, out);
  return static_cast<int>(cudaGetLastError());
}
