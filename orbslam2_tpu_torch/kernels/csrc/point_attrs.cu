// Kernel N: per map point, the distinctive descriptor, the mean viewing
// normal and the scale-invariance band, over its observation slots.
//
// Replaces orbslam2_tpu/ops/point_attrs.py:29 (point_attributes:
// MapPoint::ComputeDistinctiveDescriptors and UpdateNormalAndDepth as one
// program over a batch of points), which the mapper runs on batches of at
// least 128 points, with the slot axis bucketed 8, 16, 32, ... up to the
// observation table's width (512).
//
// Bound on the H100: latency of the scattered gathers. A point reads its
// live slots' descriptors (32 bytes each) and camera poses at keyframe ids
// from the device mirror; the arithmetic (n_obs^2 Hamming distances of 8
// words and an n_obs-way median per slot) is small for the few observations
// most points have, and at P = 512 points the whole batch is a few hundred
// KB. Design: one block per point, one thread per slot (O <= 1024, the
// block's limit), the slots' descriptors staged in shared memory. Distances
// are __popc of the XOR over 8 u32 words (integers, exact; the reference's
// float Gram product is exact too). A pair with an empty slot counts 10000.
// The median of a live slot's row is its (n_obs - 1) / 2-th smallest, which
// lies among the live slots (0..256): a binary search over that range
// counting the distances <= mid finds it exactly in 9 passes over the live
// slots, with no row kept per thread, so O is bounded by the block alone.
// The argmin takes the first slot on ties. The normal sums each live slot's
// vec / |vec| by a butterfly in each warp, then over the warps in order
// (another order than the plain sum: float32 rounding). The band reads the
// first slot of the reference keyframe, else the first live slot: dmax =
// |vec| * sf^level, dmin = dmax / sf^(levels - 1). One packed (P, 38)
// float32 row per point, as the reference returns it.
#include "common.cuh"

#include <limits.h>

namespace {

constexpr int kBig = 10000;
constexpr int kMaxDist = 256;  // bits in a descriptor
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRow = 38;

__device__ __forceinline__ int first_set(const unsigned* masks, int n_words) {
  for (int i = 0; i < n_words; ++i) {
    if (masks[i]) return 32 * i + __ffs(masks[i]) - 1;
  }
  return -1;
}

__global__ void point_attrs_kernel(
    const uint8_t* __restrict__ kf_desc, const int* __restrict__ kf_octave,
    const float* __restrict__ kf_pose, int n_feat,
    const int16_t* __restrict__ obs_kf, const int16_t* __restrict__ obs_ft,
    const float* __restrict__ mp_pos, const int* __restrict__ mp_ref_kf,
    int P, int O, float sf, float n_levels_m1, float* __restrict__ out) {
  extern __shared__ uint32_t s_desc[];  // O x 8 words, the slots' descriptors
  __shared__ unsigned s_live[32];       // each warp's ballot of live slots
  __shared__ unsigned s_ref[32];        // ... of reference-keyframe slots
  __shared__ int s_med[32], s_slot[32];  // each warp's (median, slot) argmin
  __shared__ float s_n[32][3];          // each warp's normal sum
  const int p = blockIdx.x;
  const int a = threadIdx.x;  // this thread's slot
  const int lane = a & 31;
  const int warp = a >> 5;
  const int n_warps = blockDim.x >> 5;
  const int okf = a < O ? obs_kf[static_cast<size_t>(p) * O + a] : -1;
  const int oft = a < O ? obs_ft[static_cast<size_t>(p) * O + a] : -1;
  const bool sel = okf >= 0;
  const int kf = max(okf, 0);
  const int ft = max(oft, 0);

  const uint32_t* dw = reinterpret_cast<const uint32_t*>(
      kf_desc + (static_cast<size_t>(kf) * n_feat + ft) * 32);
  uint32_t w[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) w[j] = dw[j];
  if (a < O) {
#pragma unroll
    for (int j = 0; j < 8; ++j) s_desc[a * 8 + j] = w[j];
  }
  const unsigned live = __ballot_sync(kFull, sel);
  const unsigned is_ref = __ballot_sync(kFull, sel && okf == mp_ref_kf[p]);
  if (lane == 0) {
    s_live[warp] = live;
    s_ref[warp] = is_ref;
  }
  __syncthreads();
  int n_obs = 0;
  for (int i = 0; i < n_warps; ++i) n_obs += __popc(s_live[i]);

  // --- distinctive descriptor: the lowest median pairwise Hamming distance
  int med = kBig;
  if (sel) {
    const int need = (n_obs - 1) / 2 + 1;  // distances <= the median
    int lo = 0, hi = kMaxDist;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      int le = 0;
      for (int i = 0; i < n_warps; ++i) {
        for (unsigned m = s_live[i]; m; m &= m - 1) {
          const uint32_t* v = s_desc + (32 * i + __ffs(m) - 1) * 8;
          int d = 0;
#pragma unroll
          for (int j = 0; j < 8; ++j) d += __popc(w[j] ^ v[j]);
          le += d <= mid;
        }
      }
      if (le >= need) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    med = lo;
  }
  int best = a < O ? med : INT_MAX;
  int best_slot = a;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int ob = __shfl_xor_sync(kFull, best, o);
    const int os = __shfl_xor_sync(kFull, best_slot, o);
    if (ob < best || (ob == best && os < best_slot)) {
      best = ob;
      best_slot = os;
    }
  }

  // --- mean viewing normal: camera centre -R^T t of the slot's keyframe
  const float* T = kf_pose + static_cast<size_t>(kf) * 16;
  float vec[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float c = -(T[i] * T[3] + T[4 + i] * T[7] + T[8 + i] * T[11]);
    vec[i] = mp_pos[p * 3 + i] - c;
  }
  const float vlen = sqrtf(fmaxf(vec[0] * vec[0] + vec[1] * vec[1] + vec[2] * vec[2],
                                 1e-18f));
  const float selw = sel ? 1.0f / vlen : 0.0f;
  float n[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    n[i] = vec[i] * selw;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) n[i] += __shfl_xor_sync(kFull, n[i], o);
  }
  if (lane == 0) {
    s_med[warp] = best;
    s_slot[warp] = best_slot;
    s_n[warp][0] = n[0];
    s_n[warp][1] = n[1];
    s_n[warp][2] = n[2];
  }
  __syncthreads();

  float* o_row = out + static_cast<size_t>(p) * kRow;
  if (a < 32) {
    best = s_med[0];
    best_slot = s_slot[0];
    for (int i = 1; i < n_warps; ++i) {
      if (s_med[i] < best) {  // warps in slot order: the first wins ties
        best = s_med[i];
        best_slot = s_slot[i];
      }
    }
    const uint32_t word = s_desc[best_slot * 8 + (a >> 2)];
    o_row[a] = static_cast<float>((word >> (8 * (a & 3))) & 0xffu);
  }
  if (a == 0) {
    float t[3] = {s_n[0][0], s_n[0][1], s_n[0][2]};
    for (int i = 1; i < n_warps; ++i) {
      t[0] += s_n[i][0];
      t[1] += s_n[i][1];
      t[2] += s_n[i][2];
    }
    const float cnt = static_cast<float>(max(n_obs, 1));
#pragma unroll
    for (int i = 0; i < 3; ++i) t[i] = t[i] / cnt;
    const float nn = fmaxf(sqrtf(t[0] * t[0] + t[1] * t[1] + t[2] * t[2]), 1e-9f);
    o_row[32] = t[0] / nn;
    o_row[33] = t[1] / nn;
    o_row[34] = t[2] / nn;
  }

  // --- scale band from the reference keyframe's slot, else the first live
  // (slot 0 for a point without observations, whose row the caller masks)
  int j = first_set(s_ref, n_warps);
  if (j < 0) j = max(first_set(s_live, n_warps), 0);
  if (a == j) {
    const float level = static_cast<float>(kf_octave[static_cast<size_t>(kf) * n_feat + ft]);
    const float dmax = vlen * powf(sf, level);
    o_row[35] = dmax / powf(sf, n_levels_m1);
    o_row[36] = dmax;
    o_row[37] = static_cast<float>(okf);
  }
}

}  // namespace

// kf_desc (K, n_feat, 32) u8, kf_octave (K, n_feat) i32, kf_pose (K, 4, 4)
// f32, obs_kf / obs_ft (P, O) i16 (-1 = empty), mp_pos (P, 3), mp_ref_kf
// (P,) i32; out (P, 38) f32. 1 <= O <= 1024; O x 32 bytes of dynamic shared
// memory a block.
OSL_EXPORT int osl_point_attrs(const uint8_t* kf_desc, const int* kf_octave,
                               const float* kf_pose, int n_feat,
                               const int16_t* obs_kf, const int16_t* obs_ft,
                               const float* mp_pos, const int* mp_ref_kf, int P,
                               int O, float sf, float n_levels_m1, float* out,
                               void* stream) {
  if (P <= 0) return 0;
  const int threads = 32 * ((O + 31) / 32);
  point_attrs_kernel<<<P, threads, O * 32, static_cast<cudaStream_t>(stream)>>>(
      kf_desc, kf_octave, kf_pose, n_feat, obs_kf, obs_ft, mp_pos, mp_ref_kf, P,
      O, sf, n_levels_m1, out);
  return static_cast<int>(cudaGetLastError());
}
