// Kernel B: intensity-centroid angle + steered BRIEF, one warp per keypoint.
//
// Replaces orbslam2_tpu/ops/orb.py: ic_angles_conv (with its whole-image
// prefix-sum moment maps) and brief_descriptors_flat.
//
// Bound on the H100: latency of scattered loads. A keypoint reads ~700
// pixels for its moments and 512 blurred pixels for its descriptor, at
// data-dependent addresses; the level images stay in L2, and there are at
// most a few hundred keypoints per level, so the kernel is short and bound by
// load latency rather than bandwidth.
// Design: one warp per keypoint, nothing staged. For the moments, lane l
// owns column dx = l - 15 of the radius-15 circle and walks its 31 rows, then
// a butterfly shuffle sums the lanes; the moments are a direct sum over the
// circle, not the reference's prefix-sum maps (a TPU workaround whose large
// prefix sums round on their own). The angle is atan2f(m01, m10). For the
// descriptor, lane l computes byte l: its eight test pairs are rotated by the
// angle, rounded half-to-even (rintf, as jnp.round), clamped to the level,
// compared a < b on the blurred level, and packed LSB-first. Built without
// fast math and without FMA contraction, so cosf/sinf/atan2f are the IEEE
// library versions and the rotation rounds like the plain version's
// separate multiplies.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kIcR = 15;
constexpr unsigned kFull = 0xffffffffu;

__global__ void orb_describe_kernel(const float* __restrict__ img,
                                    const float* __restrict__ blurred,
                                    const int* __restrict__ xy, int n,
                                    const int* __restrict__ pattern, int H,
                                    int W, int upright,
                                    float* __restrict__ angle_out,
                                    uint8_t* __restrict__ desc_out) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n) return;  // whole warps exit together
  const int kx = xy[2 * warp];
  const int ky = xy[2 * warp + 1];

  float m10 = 0.0f;
  float m01 = 0.0f;
  const int dx = lane - kIcR;
  if (lane < 2 * kIcR + 1) {
    const int xx = osl::clampi(kx + dx, 0, W - 1);
    const int adx = dx < 0 ? -dx : dx;
    for (int dy = -kIcR; dy <= kIcR; ++dy) {
      const int umax = static_cast<int>(
          rintf(sqrtf(static_cast<float>(kIcR * kIcR - dy * dy))));
      if (adx <= umax) {
        const float v = img[osl::clampi(ky + dy, 0, H - 1) * W + xx];
        m10 += static_cast<float>(dx) * v;
        m01 += static_cast<float>(dy) * v;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    m10 += __shfl_xor_sync(kFull, m10, o);
    m01 += __shfl_xor_sync(kFull, m01, o);
  }
  const float ang = atan2f(m01, m10);
  if (lane == 0) angle_out[warp] = ang;

  const float a = upright ? 0.0f : ang;
  const float c = cosf(a);
  const float s = sinf(a);
  unsigned byte = 0;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const int k = lane * 8 + b;
    float v[2];
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const int p = k + 256 * side;  // rows 0..255: first points, 256..511: second
      const float px = static_cast<float>(pattern[2 * p]);
      const float py = static_cast<float>(pattern[2 * p + 1]);
      const int rc = static_cast<int>(rintf(px * c - py * s));
      const int rr = static_cast<int>(rintf(px * s + py * c));
      const int yy = osl::clampi(ky + rr, 0, H - 1);
      const int xx = osl::clampi(kx + rc, 0, W - 1);
      v[side] = blurred[yy * W + xx];
    }
    byte |= (v[0] < v[1] ? 1u : 0u) << b;
  }
  desc_out[warp * 32 + lane] = static_cast<uint8_t>(byte);
}

}  // namespace

OSL_EXPORT int osl_orb_describe(const float* img, const float* blurred,
                                const int* xy, int n, const int* pattern,
                                int H, int W, int upright, float* angle_out,
                                uint8_t* desc_out, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;  // 8 keypoints per block
  const int blocks = (n * 32 + threads - 1) / threads;
  orb_describe_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      img, blurred, xy, n, pattern, H, W, upright, angle_out, desc_out);
  return static_cast<int>(cudaGetLastError());
}
