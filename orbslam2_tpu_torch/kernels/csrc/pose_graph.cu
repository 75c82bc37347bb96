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
// pose_graph_prepare, pose_graph_update and pose_graph_finish are in
// pose_graph.cuh, shared with kernel P' (pose_graph_cg.cu). All state stays on the device: one LM iteration is 4 launches and a
// memset plus the 3 ceil(7K / 32) + 1 of F'. Sums over vertices and edges
// run in a fixed order; the system is accumulated with float atomics.
#include "pose_graph.cuh"

namespace {

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
  // the float workspace, in this order (pose_graph.workspace_floats): the
  // shared part, then H and b
  float* w = layout_common(p, ws, iws);
  p.H = w; w += n * n;
  p.b = w;
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
