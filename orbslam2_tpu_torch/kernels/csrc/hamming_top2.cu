// Kernel C: gated Hamming best / second-best per map point, one warp per row.
//
// Replaces orbslam2_tpu/ops/matching.py: hamming_matrix + masked_top2, and
// the pair mask the projection tracker builds from radius_gate, octave_gate
// and the u_right window (orbslam2_tpu/tracking.py, _project_match_opt).
//
// Bound on the H100: the reference materialises a (P, N) distance matrix and
// a (P, N) mask (12288 x 1024 = 12.6 M entries each, four times a frame).
// Here neither reaches memory: the bound becomes the gate evaluation and the
// 256-bit popcount per admitted pair, with the N keypoints' 49 KB of data
// read from L1/L2 by every warp.
// Design: one warp per map point. Rows that are not valid (padding, or
// outside the frustum) exit at once, which is most of a padded local map.
// Lane l scans keypoints j = l, l + 32, ...; the gate (squared radius,
// octave in [pred - 1, pred], u_right window) is evaluated with the same
// single float32 operations as the plain version, and only an admitted pair
// loads the keypoint's descriptor (two 16-byte loads) for eight __popc. Each
// lane keeps its best and second-best as 64-bit (distance, index) keys, and a
// butterfly merge across the warp picks the lexicographic two smallest, which
// is jnp.argmin's first-index-on-ties rule and masked_top2's "exclude only
// best_idx" rule. Rows with no admitted pair, or no second, report index 0
// and distance INVALID as masked_top2 does, so all four outputs are
// bit-exact integers against the plain version.
// A launch given a gate (the retry pass of the tracking cascade) returns at
// once unless the first pass's inlier count is below the threshold.
#include "common.cuh"

namespace {

constexpr int kInvalid = 0x7fffffff / 2;  // matching.INVALID
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNone =
    (static_cast<unsigned long long>(kInvalid) << 32) | 0xffffffffull;

__device__ __forceinline__ unsigned long long key(int d, int j) {
  return (static_cast<unsigned long long>(d) << 32) |
         static_cast<unsigned int>(j);
}

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

__global__ void hamming_top2_kernel(
    const uint8_t* __restrict__ mp_desc, const float* __restrict__ proj,
    const float* __restrict__ r_px, const int* __restrict__ pred_level,
    const float* __restrict__ ur_pred, const uint8_t* __restrict__ row_valid,
    int P, const uint8_t* __restrict__ kp_desc,
    const float* __restrict__ kp_xy, const int* __restrict__ kp_octave,
    const uint8_t* __restrict__ kp_valid, const float* __restrict__ kp_ur,
    int N, const int* gate_n, int gate_min, int* __restrict__ best_idx,
    int* __restrict__ best, int* __restrict__ second,
    int* __restrict__ second_idx) {
  if (gate_n != nullptr && !(*gate_n < gate_min)) return;
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= P) return;  // whole warps exit together

  unsigned long long b = kNone;
  unsigned long long s = kNone;
  if (row_valid[row]) {
    const uint4* rd = reinterpret_cast<const uint4*>(mp_desc + 32 * row);
    const uint4 a0 = rd[0];
    const uint4 a1 = rd[1];
    const float px = proj[2 * row];
    const float py = proj[2 * row + 1];
    const float r = r_px[row];
    const float r2 = r * r;
    const int pl = pred_level[row];
    const float urp = ur_pred[row];
    for (int j = lane; j < N; j += 32) {
      if (!kp_valid[j]) continue;
      const float dx = px - kp_xy[2 * j];
      const float dy = py - kp_xy[2 * j + 1];
      if (!(dx * dx + dy * dy <= r2)) continue;
      const int diff = kp_octave[j] - pl;
      if (diff < -1 || diff > 0) continue;
      const float kur = kp_ur[j];
      if (!(kur <= 0.0f || fabsf(urp - kur) <= r)) continue;
      const uint4* kd = reinterpret_cast<const uint4*>(kp_desc + 32 * j);
      const uint4 b0 = kd[0];
      const uint4 b1 = kd[1];
      const int d = __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) +
                    __popc(a0.z ^ b0.z) + __popc(a0.w ^ b0.w) +
                    __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
                    __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
      merge(b, s, key(d, j), kNone);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long ob = __shfl_xor_sync(kFull, b, o);
    const unsigned long long os = __shfl_xor_sync(kFull, s, o);
    merge(b, s, ob, os);
  }
  if (lane == 0) {
    const int bd = static_cast<int>(b >> 32);
    const int sd = static_cast<int>(s >> 32);
    best[row] = bd;
    best_idx[row] = (bd == kInvalid) ? 0 : static_cast<int>(b & 0xffffffffu);
    second[row] = sd;
    second_idx[row] = (sd == kInvalid) ? 0 : static_cast<int>(s & 0xffffffffu);
  }
}

}  // namespace

OSL_EXPORT int osl_hamming_top2_gated(
    const uint8_t* mp_desc, const float* proj, const float* r_px,
    const int* pred_level, const float* ur_pred, const uint8_t* row_valid,
    int P, const uint8_t* kp_desc, const float* kp_xy, const int* kp_octave,
    const uint8_t* kp_valid, const float* kp_ur, int N, const int* gate_n,
    int gate_min, int* best_idx, int* best, int* second, int* second_idx,
    void* stream) {
  if (P <= 0) return 0;
  const int threads = 256;  // 8 rows per block
  const int blocks = (P * 32 + threads - 1) / threads;
  hamming_top2_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      mp_desc, proj, r_px, pred_level, ur_pred, row_valid, P, kp_desc, kp_xy,
      kp_octave, kp_valid, kp_ur, N, gate_n, gate_min, best_idx, best, second,
      second_idx);
  return static_cast<int>(cudaGetLastError());
}
