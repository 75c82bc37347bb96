// Kernel V: the stereo matcher's descriptor half, one launch.
//
// Replaces orbslam2_tpu/ops/stereo.py: stereo_match (ComputeStereoMatches'
// search): for each left keypoint the right keypoints on nearby rows
// (|v_l - v_r| <= 2 scale(octave_l)), inside the disparity band
// (0.1 < u_l - u_r <= bf / max(min_depth, 1e-6)) and within one octave,
// matched by Hamming distance under TH_HIGH and the 0.9 ratio test (no
// mutual check); then u_right and depth = bf / max(d, 0.1).
//
// Bound on the H100: the pair gates. The reference evaluates an (N, N) row
// mask, disparity mask and octave mask and a full Hamming matrix (4.2 M
// pairs at N = 2048); the row band admits a few per cent of them.
// Design: a warp per left keypoint, lane l scanning right keypoints
// j = l, l + 32, ... . Each gate is the plain version's float32 operation;
// only an admitted pair loads the right descriptor for eight __popc. The
// lanes keep best and second-best (distance << 32 | j) keys, merged across
// the warp (masked_top2's first index on ties). Lane 0 applies the gates and
// writes u_right and depth; the disparity limit and the depth are IEEE
// divisions (no reciprocal), so both are bit-exact against the plain
// version.
#include "common.cuh"

namespace {

constexpr int kInvalid = 0x7fffffff / 2;  // matching.INVALID
constexpr int kThHigh = 100;             // matching.TH_HIGH
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

__global__ void stereo_match_kernel(
    const float* __restrict__ l_xy, const int* __restrict__ l_oct,
    const uint8_t* __restrict__ l_desc, const uint8_t* __restrict__ l_valid,
    int Nl, const float* __restrict__ r_xy, const int* __restrict__ r_oct,
    const uint8_t* __restrict__ r_desc, const uint8_t* __restrict__ r_valid,
    int Nr, const float* __restrict__ scale_factors, float bf,
    float min_depth, float* __restrict__ ur_out,
    float* __restrict__ depth_out) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= Nl) return;  // whole warps exit together
  unsigned long long b = kNone;
  unsigned long long s = kNone;
  const float ul = l_xy[2 * i];
  if (l_valid[i]) {
    const float vl = l_xy[2 * i + 1];
    const int ol = l_oct[i];
    const float row_tol = 2.0f * scale_factors[ol];
    const float max_disp = bf / fmaxf(min_depth, 1e-6f);
    const uint4* rd = reinterpret_cast<const uint4*>(l_desc + 32 * i);
    const uint4 a0 = rd[0];
    const uint4 a1 = rd[1];
    for (int j = lane; j < Nr; j += 32) {
      if (!r_valid[j]) continue;
      if (!(fabsf(vl - r_xy[2 * j + 1]) <= row_tol)) continue;
      const float disp = ul - r_xy[2 * j];
      if (!(disp > 0.1f && disp <= max_disp)) continue;
      const int od = r_oct[j] - ol;
      if (od < -1 || od > 1) continue;
      const uint4* kd = reinterpret_cast<const uint4*>(r_desc + 32 * j);
      const uint4 b0 = kd[0];
      const uint4 b1 = kd[1];
      const int d = __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) +
                    __popc(a0.z ^ b0.z) + __popc(a0.w ^ b0.w) +
                    __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
                    __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
      merge(b, s, (static_cast<unsigned long long>(d) << 32) |
                      static_cast<unsigned int>(j), kNone);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long ob = __shfl_xor_sync(kFull, b, o);
    const unsigned long long os = __shfl_xor_sync(kFull, s, o);
    merge(b, s, ob, os);
  }
  if (lane == 0) {
    const int best = static_cast<int>(b >> 32);
    const int second = static_cast<int>(s >> 32);
    const bool ok = l_valid[i] && best <= kThHigh &&
                    static_cast<float>(best) < 0.9f * static_cast<float>(second);
    float ur = -1.0f;
    float depth = -1.0f;
    if (ok) {
      const float u = r_xy[2 * static_cast<int>(b & 0xffffffffu)];
      const float d = ul - u;
      if (d > 0.1f) {
        depth = bf / fmaxf(d, 0.1f);
        ur = depth > 0.0f ? u : -1.0f;
      }
    }
    ur_out[i] = ur;
    depth_out[i] = depth;
  }
}

}  // namespace

OSL_EXPORT int osl_stereo_match(
    const float* l_xy, const int* l_oct, const uint8_t* l_desc,
    const uint8_t* l_valid, int Nl, const float* r_xy, const int* r_oct,
    const uint8_t* r_desc, const uint8_t* r_valid, int Nr,
    const float* scale_factors, float bf, float min_depth, float* ur,
    float* depth, void* stream) {
  if (Nl <= 0) return 0;
  const int threads = 256;  // 8 left keypoints per block
  stereo_match_kernel<<<(Nl * 32 + threads - 1) / threads, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      l_xy, l_oct, l_desc, l_valid, Nl, r_xy, r_oct, r_desc, r_valid, Nr,
      scale_factors, bf, min_depth, ur, depth);
  return static_cast<int>(cudaGetLastError());
}
