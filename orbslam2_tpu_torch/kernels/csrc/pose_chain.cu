// Kernel R': the tracking pose chain on the device.
//
// Replaces the pose algebra of orbslam2_tpu/tracking.py's
// track_frame_fused_chained (:407-411 and :417): both chain links
// re-projected onto SE(3) (ops/geometry.py se3_orthonormalize: Gram-Schmidt
// of columns 0 and 1, each norm floored at 1e-12, the third column their
// cross product), the velocity vel = T_prev inv(T_prev2) by the closed-form
// rigid inverse, the motion-model prediction vel T_prev, and after the
// cascade the orthonormalized output link read from kernel R's packed Tcw.
// With it the pipelined tracker dispatches frame k from frame k-1's pose
// while that pose is still on the device: no host round trip in the chain.
//
// Bound on the H100: launch latency. It reads at most two 4x4 float32
// matrices and writes one (192 bytes) and does ~420 operations, well under a
// microsecond of either.
// Design: one block of one thread runs the serial 4x4 chain in registers,
// term by term in the plain version's order (ops/geometry.py), so with
// -fmad=false it differs from the plain version only where the library
// sums a norm or a product in another order. One launch predicts (motion:
// vel T_prev, else T_prev alone orthonormalized); one launch after kernel R
// orthonormalizes the packed pose (motion = 0).
#include "common.cuh"

namespace {

// T (row-major 4x4) with its rotation re-projected onto SO(3), into O
__device__ void orthonormalize(const float* __restrict__ T, float O[16]) {
  float r0[3] = {T[0], T[4], T[8]};
  float r1[3] = {T[1], T[5], T[9]};
  const float n0 = fmaxf(sqrtf(r0[0] * r0[0] + r0[1] * r0[1] + r0[2] * r0[2]), 1e-12f);
  for (int i = 0; i < 3; ++i) r0[i] = r0[i] / n0;
  const float d = r1[0] * r0[0] + r1[1] * r0[1] + r1[2] * r0[2];
  for (int i = 0; i < 3; ++i) r1[i] = r1[i] - d * r0[i];
  const float n1 = fmaxf(sqrtf(r1[0] * r1[0] + r1[1] * r1[1] + r1[2] * r1[2]), 1e-12f);
  for (int i = 0; i < 3; ++i) r1[i] = r1[i] / n1;
  const float r2[3] = {r0[1] * r1[2] - r0[2] * r1[1], r0[2] * r1[0] - r0[0] * r1[2],
                       r0[0] * r1[1] - r0[1] * r1[0]};
  for (int i = 0; i < 3; ++i) {
    O[4 * i + 0] = r0[i];
    O[4 * i + 1] = r1[i];
    O[4 * i + 2] = r2[i];
    O[4 * i + 3] = T[4 * i + 3];
  }
  O[12] = O[13] = O[14] = 0.0f;
  O[15] = 1.0f;
}

__device__ void matmul4(const float A[16], const float B[16], float C[16]) {
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 4; ++j) {
      float s = A[4 * i] * B[j];
      for (int k = 1; k < 4; ++k) s = s + A[4 * i + k] * B[4 * k + j];
      C[4 * i + j] = s;
    }
  }
}

__global__ void __launch_bounds__(1) pose_chain_kernel(
    const float* __restrict__ T_a, const float* __restrict__ T_b, int motion,
    float* __restrict__ out) {
  float A[16];
  orthonormalize(T_a, A);
  if (!motion) {
    for (int i = 0; i < 16; ++i) out[i] = A[i];
    return;
  }
  float B[16], Bi[16], V[16], P[16];
  orthonormalize(T_b, B);
  // closed-form rigid inverse: [R^T, -R^T t]
  for (int i = 0; i < 3; ++i) {
    float s = B[i] * B[3];
    for (int k = 1; k < 3; ++k) s = s + B[4 * k + i] * B[4 * k + 3];
    for (int j = 0; j < 3; ++j) Bi[4 * i + j] = B[4 * j + i];
    Bi[4 * i + 3] = -s;
  }
  Bi[12] = Bi[13] = Bi[14] = 0.0f;
  Bi[15] = 1.0f;
  matmul4(A, Bi, V);
  matmul4(V, A, P);
  for (int i = 0; i < 16; ++i) out[i] = P[i];
}

}  // namespace

OSL_EXPORT int osl_pose_chain(const float* T_a, const float* T_b, int motion,
                              float* out, void* stream) {
  pose_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(T_a, T_b, motion, out);
  return static_cast<int>(cudaGetLastError());
}
