// Kernel O: projection, frustum test and PredictScale of the local map, one
// thread per point.
//
// Replaces the front half of orbslam2_tpu/tracking.py: _project_match_opt
// (R X + t, models/camera.py project, isInFrustum, PredictScale, the search
// radius and the predicted u_right), which feeds kernel C.
//
// Bound on the H100: bytes. Each point reads 33 bytes (position, normal,
// depth band, validity) and writes kernel C's 21 bytes of inputs; ~70
// float operations per point are far below the card's float32 rate. The
// reference's jitted program materialises each intermediate (camera-frame
// points, distances, ratios) as its own array; here they stay in registers.
// Design: one thread per point, the pose read from device memory (for the
// local-map and tight passes it is kernel D's output, so the host never
// sees it). Every expression is written in the order of the plain version
// (kernels/project_gate.py) and built without FMA contraction, so all five
// outputs are bit-exact against it, log() of the scale ratio aside: log(sf)
// and the sf^level table come from the host, computed once as the plain
// version computes them.
// A launch given a gate (the retry pass of the cascade) returns at once
// unless the first pass's inlier count is below the threshold.
#include "common.cuh"

namespace {

struct Cam {
  float fx, fy, cx, cy, bf;
  int width, height;
};

// torch.clamp_min: NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float m) {
  return x < m ? m : x;
}

__global__ void project_gate_kernel(
    const float* __restrict__ T, const float* __restrict__ pos,
    const uint8_t* __restrict__ valid, const float* __restrict__ normal,
    const float* __restrict__ dmin, const float* __restrict__ dmax, int P,
    Cam cam, float radius, float log_sf, const float* __restrict__ sf_pow,
    int n_levels, const int* gate_n, int gate_min, float* __restrict__ proj,
    float* __restrict__ r_px, int* __restrict__ pred_level,
    float* __restrict__ ur_pred, uint8_t* __restrict__ row_valid) {
  if (gate_n != nullptr && !(*gate_n < gate_min)) return;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const float X = pos[3 * p], Y = pos[3 * p + 1], Z = pos[3 * p + 2];
  float pc[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    pc[i] = T[4 * i] * X + T[4 * i + 1] * Y + T[4 * i + 2] * Z + T[4 * i + 3];
  }
  const float z = pc[2];
  const float inv_z = 1.0f / (fabsf(z) < 1e-8f ? 1e-8f : z);
  const float u = cam.fx * pc[0] * inv_z + cam.cx;
  const float v = cam.fy * pc[1] * inv_z + cam.cy;
  const bool in_img = u >= 0.0f && u < static_cast<float>(cam.width) &&
                      v >= 0.0f && v < static_cast<float>(cam.height);

  // camera centre -R^T t, the viewing vector and its angle to the normal
  const float t0 = T[3], t1 = T[7], t2 = T[11];
  float vec[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float c = -(T[j] * t0 + T[4 + j] * t1 + T[8 + j] * t2);
    vec[j] = pos[3 * p + j] - c;
  }
  const float dist = sqrtf(vec[0] * vec[0] + vec[1] * vec[1] + vec[2] * vec[2]);
  const float nv = vec[0] * normal[3 * p] + vec[1] * normal[3 * p + 1] +
                   vec[2] * normal[3 * p + 2];
  const float cos_view = nv / clamp_min(dist, 1e-9f);
  const bool frustum = z > 0.1f && in_img && dist >= 0.8f * dmin[p] &&
                       dist <= 1.2f * dmax[p] && cos_view > 0.5f;

  // PredictScale: ceil(log(dmax / dist) / log(sf)) in [0, L - 1]
  const float ratio = clamp_min(dmax[p] / clamp_min(dist, 1e-9f), 1e-6f);
  const int lvl = osl::clampi(static_cast<int>(ceilf(logf(ratio) / log_sf)), 0,
                              n_levels - 1);
  proj[2 * p] = u;
  proj[2 * p + 1] = v;
  r_px[p] = radius * sf_pow[lvl];
  pred_level[p] = lvl;
  ur_pred[p] = u - cam.bf / clamp_min(z, 1e-6f);
  row_valid[p] = valid[p] && frustum;
}

}  // namespace

OSL_EXPORT int osl_project_gate(
    const float* T, const float* pos, const uint8_t* valid, const float* normal,
    const float* dmin, const float* dmax, int P, float fx, float fy, float cx,
    float cy, float bf, int width, int height, float radius, float log_sf,
    const float* sf_pow, int n_levels, const int* gate_n, int gate_min,
    float* proj, float* r_px, int* pred_level, float* ur_pred,
    uint8_t* row_valid, void* stream) {
  if (P <= 0) return 0;
  const Cam cam{fx, fy, cx, cy, bf, width, height};
  const int threads = 256;
  project_gate_kernel<<<(P + threads - 1) / threads, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      T, pos, valid, normal, dmin, dmax, P, cam, radius, log_sf, sf_pow,
      n_levels, gate_n, gate_min, proj, r_px, pred_level, ur_pred, row_valid);
  return static_cast<int>(cudaGetLastError());
}
