// Kernel L: RGB-D virtual right coordinate of every keypoint, with the
// keypoints' undistortion, in one elementwise pass.
//
// Replaces orbslam2_tpu/tracking.py:436-449 (_rgbd_virtual_right_u16: the
// nearest millimetre depth at the rounded keypoint, u_r = u - bf / d) and
// orbslam2_tpu/models/camera.py:84-104 (undistort_points: eight fixed-point
// iterations) as _make_frame calls them once per frame: the extractor's
// epilogue.
//
// Bound on the H100: launch. The work is N = 1024 keypoints, ~20 KB read and
// written and ~300 float32 operations each with distortion; a launch costs
// more than the traffic. Design: one thread per keypoint, nothing staged; it
// reads the host-quantised depth map as uint16 (half the bytes of the int32
// upload it replaces) at rintf(x * inv), rintf(y * inv) clamped to the map
// (half-to-even, as torch.round and jnp.round). Every operation is the plain
// version's float32 operation in its order: the undistortion's iterations
// as models/camera.py writes them, IEEE divisions (the build has no fast
// math and no FMA contraction), so the outputs are bit-exact.
#include "common.cuh"

namespace {

struct Cam {
  float fx, fy, cx, cy, k1, k2, p1, p2, k3, p1x2, p2x2;  // p1x2 = 2 * p1
};

constexpr int kIters = 8;

__global__ void rgbd_depth_kernel(const uint16_t* __restrict__ depth, int Hd,
                                  int Wd, const float* __restrict__ xy,
                                  const bool* __restrict__ valid, int n,
                                  float inv, float depth_scale, float bf,
                                  int distort, Cam cam,
                                  float* __restrict__ xy_undist,
                                  float* __restrict__ ur_out,
                                  float* __restrict__ depth_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float u = xy[2 * i];
  const float v = xy[2 * i + 1];
  float uu = u;
  if (distort) {
    const float xd = (u - cam.cx) / cam.fx;
    const float yd = (v - cam.cy) / cam.fy;
    float x = xd, y = yd;
    for (int it = 0; it < kIters; ++it) {
      const float r2 = x * x + y * y;
      const float radial = 1.0f + cam.k1 * r2 + cam.k2 * r2 * r2 +
                           cam.k3 * r2 * r2 * r2;
      const float dx = x * radial + cam.p1x2 * x * y + cam.p2 * (r2 + 2.0f * x * x);
      const float dy = y * radial + cam.p1 * (r2 + 2.0f * y * y) + cam.p2x2 * x * y;
      const float xn = xd - (dx - x);
      const float yn = yd - (dy - y);
      x = xn;
      y = yn;
    }
    uu = x * cam.fx + cam.cx;
    xy_undist[2 * i] = uu;
    xy_undist[2 * i + 1] = y * cam.fy + cam.cy;
  }
  const int xi = osl::clampi(static_cast<int>(rintf(u * inv)), 0, Wd - 1);
  const int yi = osl::clampi(static_cast<int>(rintf(v * inv)), 0, Hd - 1);
  const float d = static_cast<float>(depth[yi * Wd + xi]) * depth_scale;
  const bool ok = valid[i] && d > 0.0f;
  depth_out[i] = ok ? d : -1.0f;
  ur_out[i] = ok ? uu - bf / fmaxf(d, 1e-6f) : -1.0f;
}

}  // namespace

// cam: fx, fy, cx, cy, k1, k2, p1, p2, k3 (float32); xy_undist is written
// only when distort != 0.
OSL_EXPORT int osl_rgbd_depth(const uint16_t* depth, int Hd, int Wd,
                              const float* xy, const bool* valid, int n,
                              float inv, float depth_scale, float bf,
                              int distort, float fx, float fy, float cx,
                              float cy, float k1, float k2, float p1, float p2,
                              float k3, float* xy_undist, float* ur_out,
                              float* depth_out, void* stream) {
  if (n <= 0) return 0;
  const Cam cam = {fx, fy, cx, cy, k1, k2, p1, p2, k3, 2.0f * p1, 2.0f * p2};
  const int threads = 256;
  rgbd_depth_kernel<<<(n + threads - 1) / threads, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      depth, Hd, Wd, xy, valid, n, inv, depth_scale, bf, distort, cam,
      xy_undist, ur_out, depth_out);
  return static_cast<int>(cudaGetLastError());
}
