// Kernel W: the stereo matcher's subpixel half, one launch.
//
// Replaces orbslam2_tpu/ops/stereo.py: subpixel_refine (ComputeStereoMatches'
// sliding window): per matched left keypoint, the 11x11 left patch at the
// rounded keypoint and the 11x21 right strip at the rounded u_right, both
// clamped at the image border; the SAD of the patch against the strip at the
// 11 shifts -5..+5; the first minimum; a parabola through the minimum and
// its neighbours (the minimum clamped into 1..9), its offset clamped to
// [-1, 1]; u_right, and depth = bf / max(disparity, 0.05) where the
// disparity exceeds 0.05.
//
// Bound on the H100: the pixel reads, 121 + 231 floats a keypoint (the
// distinct pixels of this run's keypoints, counted in chip_smoke.py); the
// 11 x 121 absolute differences are little work beside them.
// Design: a warp per keypoint. Lane l takes patch positions p = l, l + 32,
// ... < 121, reads its left pixel once and the 11 right pixels of its row
// that the shifts need, and keeps 11 partial sums; a butterfly adds them
// across the warp. The pixels are integer grey levels, so every SAD is an
// integer below 2^24 and exact in float32 in any order. Rounding is rintf
// (jnp.round: half to even); the parabola's quotient and the depth are
// IEEE divisions, so u_right and depth are bit-exact against the plain
// version. Rows the descriptor half left unmatched write -1 at once.
#include "common.cuh"

namespace {

constexpr int kW = 5;  // half window: 11 x 11 (SAD_W)
constexpr int kL = 5;  // shifts -5..+5 (SAD_L)
constexpr int kShifts = 2 * kL + 1;
constexpr unsigned kFull = 0xffffffffu;

__global__ void stereo_sad_kernel(const float* __restrict__ left,
                                  const float* __restrict__ right, int H,
                                  int W, const float* __restrict__ xy_l,
                                  const float* __restrict__ ur0,
                                  const float* __restrict__ depth0, int N,
                                  float bf, float* __restrict__ ur_out,
                                  float* __restrict__ depth_out) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= N) return;  // whole warps exit together
  if (!(depth0[i] > 0.0f)) {
    if (lane == 0) {
      ur_out[i] = -1.0f;
      depth_out[i] = -1.0f;
    }
    return;
  }
  const float xlf = xy_l[2 * i];
  const int xl = static_cast<int>(rintf(xlf));
  const int yl = static_cast<int>(rintf(xy_l[2 * i + 1]));
  const int xr = static_cast<int>(rintf(ur0[i]));
  float sad[kShifts];
#pragma unroll
  for (int d = 0; d < kShifts; ++d) sad[d] = 0.0f;
  for (int p = lane; p < (2 * kW + 1) * (2 * kW + 1); p += 32) {
    const int r = p / (2 * kW + 1) - kW;
    const int c = p % (2 * kW + 1) - kW;
    const int row = osl::clampi(yl + r, 0, H - 1) * W;
    const float lv = left[row + osl::clampi(xl + c, 0, W - 1)];
#pragma unroll
    for (int d = 0; d < kShifts; ++d) {
      const float rv = right[row + osl::clampi(xr + c + d - kL, 0, W - 1)];
      sad[d] = sad[d] + fabsf(lv - rv);
    }
  }
#pragma unroll
  for (int d = 0; d < kShifts; ++d) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sad[d] = sad[d] + __shfl_xor_sync(kFull, sad[d], o);
  }
  if (lane != 0) return;
  int best = 0;
#pragma unroll
  for (int d = 1; d < kShifts; ++d) best = sad[d] < sad[best] ? d : best;
  const int b = osl::clampi(best, 1, 2 * kL - 1);
  float s0 = 0.0f, sm = 0.0f, sp = 0.0f;
#pragma unroll
  for (int d = 0; d < kShifts; ++d) {
    s0 = d == b ? sad[d] : s0;
    sm = d == b - 1 ? sad[d] : sm;
    sp = d == b + 1 ? sad[d] : sp;
  }
  const float denom = sm - 2.0f * s0 + sp;
  float delta = fabsf(denom) > 1e-6f ? (0.5f * (sm - sp)) / denom : 0.0f;
  delta = fminf(fmaxf(delta, -1.0f), 1.0f);
  const float ur = (static_cast<float>(xr) + static_cast<float>(b - kL)) + delta;
  const float disp = xlf - ur;
  const bool ok = disp > 0.05f;
  ur_out[i] = ok ? ur : -1.0f;
  depth_out[i] = ok ? bf / fmaxf(disp, 0.05f) : -1.0f;
}

}  // namespace

OSL_EXPORT int osl_stereo_sad(const float* left, const float* right, int H,
                              int W, const float* xy_l, const float* ur0,
                              const float* depth0, int N, float bf, float* ur,
                              float* depth, void* stream) {
  if (N <= 0) return 0;
  const int threads = 256;  // 8 keypoints per block
  stereo_sad_kernel<<<(N * 32 + threads - 1) / threads, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      left, right, H, W, xy_l, ur0, depth0, N, bf, ur, depth);
  return static_cast<int>(cudaGetLastError());
}
