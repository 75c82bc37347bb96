// Kernel P': the 7-DoF Sim3 essential-graph optimization with the matrix-
// free preconditioned conjugate-gradient solver (K19'), for K > 384.
//
// Replaces orbslam2_tpu/ops/pose_graph.py: optimize_pose_graph /
// pose_graph_impl past DENSE_MAX_K (the PCG step of :341-460 with the LM
// loop and accept of :466-481), as the loop closer calls it on a long map
// (orbslam2_tpu/loop_closing.py:497-587). The closed-form start, the step
// and its cost test and the write-back are kernel P's (pose_graph.cuh).
//
//   pose_graph_prepare      one block, as in P.
//   per LM iteration (iters of them):
//     pose_graph_cg_linearize  a thread per edge: the residual and its
//                              Jacobians in dual numbers (as P); the edge's
//                              blocks Hii, Hjj, Hij and its gradients b_i,
//                              b_j (3 x 49 + 14 floats) stored; the (7K)^2
//                              system is never formed.
//     pose_graph_cg_chain      a thread per chain position k (``order``):
//                              the pseudo-edge from k to k - 1 (position 0
//                              to the last) measured by the current
//                              relative pose, its Jacobians A and B in dual
//                              numbers, the anchoring (frozen vertex or
//                              position 0: A = I, B = 0; anchored
//                              predecessor: B = 0), A^-1 by Gauss-Jordan
//                              with partial pivoting.
//     pose_graph_cg_maps       a thread per position: M_fwd = -A^-1 B and
//                              M_bwd_k = -A_k^-T B_{k+1}^T (0 at the end),
//                              the doubling scans' level 0 (the backward
//                              scan runs in reversed chain order).
//     pose_graph_cg_level      one launch per further level d (about
//                              log2 K), a thread per (direction, k, row):
//                              L_d[k] = L_{d-1}[k] L_{d-1}[k - 2^(d-1)] for
//                              k >= 2^d. The products are fixed for the
//                              whole CG solve, so each application of the
//                              preconditioner is vector work only.
//     pose_graph_cg_solve      ONE block runs the whole CG solve: the
//                              gradient b, then at most min(K, 600)
//                              iterations (or the caller's cap, cg_cap > 0)
//                              while r.z > 1e-10 of its start,
//                              tested on the device. The matvec is
//                              (H + lam I) d with frozen rows mapped to
//                              themselves; the preconditioner is A^-T by
//                              the backward doubling scan, then A^-1 by the
//                              forward one (double-buffered levels, a
//                              barrier each). It writes the step into b and
//                              its iteration count into the workspace.
//     pose_graph_update        one block, as in P (dx = -b).
//   pose_graph_finish       as in P.
// Every sum is taken in a fixed order, so a call's result is the same from
// run to run: a thread per row of b and of the matvec adds the blocks of
// the vertex's incident edges in the order of the incidence list (the
// edge ends sorted by vertex, stably, in the wrapper), and the dot products
// are block reductions in a fixed order. Float atomics here would make each
// run's rounding differ, and where CG meets its 600-iteration cap that
// rounding decides the result (PERF.md section 7).
// One block and not a cooperative grid: a CG iteration is ~25 barriers
// (2 log2 K scan levels, the matvec, three dot products) over a few
// microseconds of work each, which one block's __syncthreads keeps cheap
// and its launch free of occupancy limits.
// Bound: operations (the dual-number linearization), then per CG
// iteration the two scans' level matrices (2 x log2 K x K x 49 floats)
// read from L2 by one SM. Launches per LM iteration: 5 + (levels - 1),
// whatever the number of CG iterations. Workspace O(E + K log K).
#include "pose_graph.cuh"

namespace {

constexpr int kSolveThreads = 512;
constexpr int kBlock = kD * kD;     // 49 floats of a 7x7 block
constexpr int kEdgeBlocks = 3 * kBlock;
constexpr int kEdgeFloats = kEdgeBlocks + 2 * kD;  // + the gradients b_i, b_j

struct CG {
  const int* inc_ptr;  // (K + 1,) each vertex's run of ``inc``
  const int* inc;      // (2E,) edge ends by vertex: e (as i) or E + e (as j)
  float* H;      // (E, 161) Hii, Hjj, Hij (7, 7) and b_i, b_j (7) of each edge
  float* Ainv;   // (K, 7, 7) A^-1 in chain order
  float* B;      // (K, 7, 7) B in chain order
  float* Lf;     // (L, K, 7, 7) forward scan levels, chain order
  float* Lb;     // (L, K, 7, 7) backward scan levels, reversed chain order
  float* v;      // (K, 7) the solution
  float* r;      // (K, 7) the residual
  float* z;      // (K, 7) the preconditioned residual
  float* d;      // (K, 7) the search direction
  float* y;      // (K, 7) the matvec of d
  float* s0;     // (K, 7) the scans' two buffers
  float* s1;
  int L;         // scan levels: 2^d < K for d < L
  int cg_max;    // CG iterations at most: min(K, 600), or the caller's cap
  int* iters;    // (iters,) CG iterations of each LM iteration
};

// the dual-number Jacobians of the residual of an edge with corrections xi,
// xj, base-relative transform M and measurement S: Ji, Jj (7 x 7) and r
__device__ void edge_jacobians(const float* xi, const float* xj, const float* M,
                               const float* S, float Ji[7][7], float Jj[7][7],
                               float rv[7]) {
  D7 seed[7], zero[7], r[7];
  for (int k = 0; k < kD; ++k) {
    seed[k] = D7(0.0f);
    seed[k].d[k] = 1.0f;
    zero[k] = D7(0.0f);
  }
  edge_res<D7>(seed, zero, xi, xj, M, S, r);
  for (int a = 0; a < kD; ++a) {
    rv[a] = r[a].v;
    for (int c = 0; c < kD; ++c) Ji[a][c] = r[a].d[c];
  }
  edge_res<D7>(zero, seed, xi, xj, M, S, r);
  for (int a = 0; a < kD; ++a) {
    for (int c = 0; c < kD; ++c) Jj[a][c] = r[a].d[c];
  }
}

__global__ void __launch_bounds__(64) pose_graph_cg_linearize(PG p, CG c) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= p.E || !p.ev[e]) return;
  float* H = c.H + static_cast<size_t>(kEdgeFloats) * e;
  const int i = p.ei[e], j = p.ej[e];
  float Ji[7][7], Jj[7][7], rv[7];
  edge_jacobians(p.x + kD * i, p.x + kD * j, p.Me + 8 * e, p.Sij + 8 * e, Ji, Jj,
                 rv);
  for (int a = 0; a < kD; ++a) {
    float gi = 0.0f, gj = 0.0f;
    for (int q = 0; q < kD; ++q) {
      gi += Ji[q][a] * rv[q];
      gj += Jj[q][a] * rv[q];
    }
    H[kEdgeBlocks + a] = gi;
    H[kEdgeBlocks + kD + a] = gj;
    for (int b = 0; b < kD; ++b) {
      float hii = 0.0f, hjj = 0.0f, hij = 0.0f;
      for (int q = 0; q < kD; ++q) {
        hii += Ji[q][a] * Ji[q][b];
        hjj += Jj[q][a] * Jj[q][b];
        hij += Ji[q][a] * Jj[q][b];
      }
      H[kD * a + b] = hii;
      H[kBlock + kD * a + b] = hjj;
      H[2 * kBlock + kD * a + b] = hij;
    }
  }
}

// inverse of a 7x7 matrix by Gauss-Jordan elimination with partial pivoting
__device__ void invert7(float a[7][7], float inv[7][7]) {
  for (int i = 0; i < kD; ++i) {
    for (int j = 0; j < kD; ++j) inv[i][j] = i == j ? 1.0f : 0.0f;
  }
  for (int col = 0; col < kD; ++col) {
    int piv = col;
    for (int rr = col + 1; rr < kD; ++rr) {
      if (fabsf(a[rr][col]) > fabsf(a[piv][col])) piv = rr;
    }
    if (piv != col) {
      for (int j = 0; j < kD; ++j) {
        const float t = a[col][j];
        a[col][j] = a[piv][j];
        a[piv][j] = t;
        const float u = inv[col][j];
        inv[col][j] = inv[piv][j];
        inv[piv][j] = u;
      }
    }
    const float dinv = 1.0f / a[col][col];
    for (int j = 0; j < kD; ++j) {
      a[col][j] *= dinv;
      inv[col][j] *= dinv;
    }
    for (int rr = 0; rr < kD; ++rr) {
      if (rr == col) continue;
      const float f = a[rr][col];
      for (int j = 0; j < kD; ++j) {
        a[rr][j] -= f * a[col][j];
        inv[rr][j] -= f * inv[col][j];
      }
    }
  }
}

__global__ void __launch_bounds__(64) pose_graph_cg_chain(PG p, CG c) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int K = p.K;
  if (k >= K) return;
  const int kp = (k + K - 1) % K;
  const int vk = p.order[k], vp = p.order[kp];
  const bool anchor = p.freeze[vk] || k == 0;
  const bool anchor_prev = p.freeze[vp] || kp == 0;
  // M_ch = S0p_k S0p_{k-1}^-1; the pseudo-edge's base-relative transform is
  // its inverse, its measurement exp(x_k) M_ch exp(-x_{k-1})
  const Sim3<float> Mch = osl::sim3_compose(
      osl::sim3_load<float>(p.S0 + 8 * vk),
      osl::sim3_inverse(osl::sim3_load<float>(p.S0 + 8 * vp)));
  float Mrev[8], Spe[8];
  osl::sim3_store(osl::sim3_inverse(Mch), Mrev);
  osl::sim3_store(osl::sim3_compose(exp_of<float>(p.x + kD * vk, 1.0f),
                                    osl::sim3_compose(Mch, exp_of<float>(p.x + kD * vp, -1.0f))),
                  Spe);
  float A[7][7], B[7][7], rv[7], Ai[7][7];
  edge_jacobians(p.x + kD * vk, p.x + kD * vp, Mrev, Spe, A, B, rv);
  for (int i = 0; i < kD; ++i) {
    for (int j = 0; j < kD; ++j) {
      if (anchor) A[i][j] = i == j ? 1.0f : 0.0f;
      if (anchor || anchor_prev) B[i][j] = 0.0f;
    }
  }
  invert7(A, Ai);
  float* ai = c.Ainv + static_cast<size_t>(kBlock) * k;
  float* bb = c.B + static_cast<size_t>(kBlock) * k;
  for (int i = 0; i < kD; ++i) {
    for (int j = 0; j < kD; ++j) {
      ai[kD * i + j] = Ai[i][j];
      bb[kD * i + j] = B[i][j];
    }
  }
}

__global__ void pose_graph_cg_maps(PG p, CG c) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int K = p.K;
  if (k >= K) return;
  const float* ai = c.Ainv + static_cast<size_t>(kBlock) * k;
  const float* bk = c.B + static_cast<size_t>(kBlock) * k;
  const float* bn = k + 1 < K ? c.B + static_cast<size_t>(kBlock) * (k + 1) : nullptr;
  float* mf = c.Lf + static_cast<size_t>(kBlock) * k;
  float* mb = c.Lb + static_cast<size_t>(kBlock) * (K - 1 - k);
  for (int i = 0; i < kD; ++i) {
    for (int l = 0; l < kD; ++l) {
      float f = 0.0f, g = 0.0f;
      for (int j = 0; j < kD; ++j) {
        f += ai[kD * i + j] * bk[kD * j + l];
        if (bn) g += ai[kD * j + i] * bn[kD * l + j];
      }
      mf[kD * i + l] = -f;
      mb[kD * i + l] = -g;
    }
  }
}

// level d of both scans: a thread per (direction, k, row)
__global__ void pose_graph_cg_level(CG c, int K, int d) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 2 * K * kD) return;
  const int dir = t / (K * kD), k = (t % (K * kD)) / kD, i = t % kD;
  const int s = 1 << (d - 1);
  if (k < 2 * s) return;
  const float* prev = (dir == 0 ? c.Lf : c.Lb) + static_cast<size_t>(d - 1) * K * kBlock;
  float* cur = (dir == 0 ? c.Lf : c.Lb) + static_cast<size_t>(d) * K * kBlock;
  const float* a = prev + static_cast<size_t>(kBlock) * k + kD * i;
  const float* b = prev + static_cast<size_t>(kBlock) * (k - s);
  for (int l = 0; l < kD; ++l) {
    float v = 0.0f;
    for (int m = 0; m < kD; ++m) v += a[m] * b[kD * m + l];
    cur[static_cast<size_t>(kBlock) * k + kD * i + l] = v;
  }
}

__device__ float block_dot(const float* a, const float* b, int n, float* scratch) {
  float s = 0.0f;
  for (int t = threadIdx.x; t < n; t += blockDim.x) s += a[t] * b[t];
  return block_sum(s, scratch);
}

// x_k = M_k x_{k-1} + c_k over k, in place of the buffer `cur` points to:
// at level d each x_k with k >= 2^d gains L_d[k] x_{k-2^d}; returns the
// buffer that holds the result
__device__ float* affine_scan(const float* levels, int L, int K, float* cur,
                              float* nxt) {
  const int n = kD * K;
  for (int d = 0; d < L; ++d) {
    const int s = 1 << d;
    const float* lev = levels + static_cast<size_t>(d) * K * kBlock;
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      const int k = t / kD, i = t % kD;
      float v = cur[t];
      if (k >= s) {
        const float* a = lev + static_cast<size_t>(kBlock) * k + kD * i;
        const float* x = cur + kD * (k - s);
        for (int m = 0; m < kD; ++m) v += a[m] * x[m];
      }
      nxt[t] = v;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  return cur;
}

// z = the chain preconditioner applied to r (frozen rows: z = r)
__device__ void precond(const PG& p, const CG& c, const float* r, float* z) {
  const int K = p.K, n = kD * K;
  // A^T y = r in chain order: c_k = A_k^-T r_k, into reversed order
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int k = t / kD, i = t % kD;
    const float* ai = c.Ainv + static_cast<size_t>(kBlock) * k;
    const float* rk = r + kD * p.order[k];
    float v = 0.0f;
    for (int m = 0; m < kD; ++m) v += ai[kD * m + i] * rk[m];
    c.s0[kD * (K - 1 - k) + i] = v;
  }
  __syncthreads();
  float* y = affine_scan(c.Lb, c.L, K, c.s0, c.s1);
  float* u = y == c.s0 ? c.s1 : c.s0;
  // A x = y: c_k = A_k^-1 y_k
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int k = t / kD, i = t % kD;
    const float* ai = c.Ainv + static_cast<size_t>(kBlock) * k + kD * i;
    const float* yk = y + kD * (K - 1 - k);
    float v = 0.0f;
    for (int m = 0; m < kD; ++m) v += ai[m] * yk[m];
    u[t] = v;
  }
  __syncthreads();
  const float* xs = affine_scan(c.Lf, c.L, K, u, y);
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int k = t / kD, i = t % kD;
    const int v = p.order[k];
    z[kD * v + i] = p.freeze[v] ? r[kD * v + i] : xs[t];
  }
  __syncthreads();
}

// row a of vertex v summed over its incident valid edges in the incidence
// list's order: the gradient b (d == nullptr) or the row of H d
__device__ float incident_row(const PG& p, const CG& c, int v, int a,
                              const float* d) {
  float s = 0.0f;
  for (int q = c.inc_ptr[v]; q < c.inc_ptr[v + 1]; ++q) {
    const bool as_j = c.inc[q] >= p.E;
    const int e = as_j ? c.inc[q] - p.E : c.inc[q];
    if (!p.ev[e]) continue;
    const float* H = c.H + static_cast<size_t>(kEdgeFloats) * e;
    if (d == nullptr) {
      s += H[kEdgeBlocks + (as_j ? kD : 0) + a];
      continue;
    }
    const float* di = d + kD * p.ei[e];
    const float* dj = d + kD * p.ej[e];
    float t = 0.0f;
    for (int m = 0; m < kD; ++m) {
      t += as_j ? H[2 * kBlock + kD * m + a] * di[m] + H[kBlock + kD * a + m] * dj[m]
                : H[kD * a + m] * di[m] + H[2 * kBlock + kD * a + m] * dj[m];
    }
    s += t;
  }
  return s;
}

// y = (H + lam I) d with frozen rows mapped to themselves
__device__ void matvec(const PG& p, const CG& c, const float* d, float* y) {
  const float lam = p.lam[0];
  for (int t = threadIdx.x; t < kD * p.K; t += blockDim.x) {
    const int v = t / kD;
    y[t] = p.freeze[v] ? d[t] : incident_row(p, c, v, t % kD, d) + lam * d[t];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kSolveThreads) pose_graph_cg_solve(PG p, CG c,
                                                                     int lm_iter) {
  __shared__ float scratch[32];
  const int K = p.K, n = kD * K;
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    c.r[t] = p.freeze[t / kD] ? 0.0f : incident_row(p, c, t / kD, t % kD, nullptr);
    c.v[t] = 0.0f;
  }
  __syncthreads();
  precond(p, c, c.r, c.z);
  for (int t = threadIdx.x; t < n; t += blockDim.x) c.d[t] = c.z[t];
  __syncthreads();
  float rz = block_dot(c.r, c.z, n, scratch);
  const float rz0 = rz;
  int it = 0;
  while (it < c.cg_max && rz > 1e-10f * rz0) {
    matvec(p, c, c.d, c.y);
    const float alpha = rz / osl::nan_max(block_dot(c.d, c.y, n, scratch), 1e-20f);
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      c.v[t] += alpha * c.d[t];
      c.r[t] -= alpha * c.y[t];
    }
    __syncthreads();
    precond(p, c, c.r, c.z);
    const float rz_new = block_dot(c.r, c.z, n, scratch);
    const float beta = rz_new / osl::nan_max(rz, 1e-20f);
    for (int t = threadIdx.x; t < n; t += blockDim.x) c.d[t] = c.z[t] + beta * c.d[t];
    __syncthreads();
    rz = rz_new;
    ++it;
  }
  for (int t = threadIdx.x; t < n; t += blockDim.x) p.b[t] = c.v[t];
  if (threadIdx.x == 0) c.iters[lm_iter] = it;
}

}  // namespace

OSL_EXPORT int osl_pose_graph_cg(const float* S_init, const uint8_t* fixed,
                                 const uint8_t* valid, const int* ei, const int* ej,
                                 const float* Sij, const uint8_t* ev,
                                 const int* order, const int* inc_ptr,
                                 const int* inc, int K, int E, int iters,
                                 int fix_scale, int cg_cap, float* ws, int* iws,
                                 float* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t Kz = K, n = static_cast<size_t>(kD) * K;
  PG p;
  p.S_init = S_init; p.fixed = fixed; p.valid = valid; p.ei = ei; p.ej = ej;
  p.Sij = Sij; p.ev = ev; p.order = order; p.K = K; p.E = E;
  p.fix_scale = fix_scale;
  CG c;
  c.inc_ptr = inc_ptr;
  c.inc = inc;
  c.cg_max = cg_cap > 0 ? cg_cap : min(K, 600);
  c.L = 1;
  while ((2 << (c.L - 1)) < K) ++c.L;
  // the float workspace, in this order (pose_graph_cg.workspace_floats):
  // the shared part, then the edge blocks and gradients, the step b, A^-1,
  // B, both scans' levels and seven (K, 7) vectors
  float* w = layout_common(p, ws, iws);
  c.H = w; w += static_cast<size_t>(kEdgeFloats) * E;
  p.H = nullptr;
  p.b = w; w += n;
  c.Ainv = w; w += kBlock * Kz;
  c.B = w; w += kBlock * Kz;
  c.Lf = w; w += static_cast<size_t>(c.L) * kBlock * Kz;
  c.Lb = w; w += static_cast<size_t>(c.L) * kBlock * Kz;
  c.v = w; w += n;
  c.r = w; w += n;
  c.z = w; w += n;
  c.d = w; w += n;
  c.y = w; w += n;
  c.s0 = w; w += n;
  c.s1 = w;
  c.iters = iws + K + 1 + (K + 3) / 4;
  cudaMemsetAsync(p.failed, 0, sizeof(int), st);
  pose_graph_prepare<<<1, kThreads, 0, st>>>(p);
  const unsigned kb = (K + 63) / 64;
  for (int it = 0; it < iters; ++it) {
    if (E > 0) pose_graph_cg_linearize<<<(E + 63) / 64, 64, 0, st>>>(p, c);
    pose_graph_cg_chain<<<kb, 64, 0, st>>>(p, c);
    pose_graph_cg_maps<<<kb, 64, 0, st>>>(p, c);
    for (int d = 1; d < c.L; ++d) {
      pose_graph_cg_level<<<static_cast<unsigned>((2 * n + 255) / 256), 256, 0, st>>>(
          c, K, d);
    }
    pose_graph_cg_solve<<<1, kSolveThreads, 0, st>>>(p, c, it);
    pose_graph_update<<<1, kThreads, 0, st>>>(p);
  }
  pose_graph_finish<<<(K + 127) / 128, 128, 0, st>>>(p, out);
  return static_cast<int>(cudaGetLastError());
}
