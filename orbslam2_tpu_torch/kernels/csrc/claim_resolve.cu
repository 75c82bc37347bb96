// Kernel Q: the match gates after kernel C and the resolution of several map
// points claiming one keypoint, then kernel D's inputs.
//
// Replaces the back half of orbslam2_tpu/tracking.py: _project_match_opt
// (match_descriptors' TH_HIGH and same-octave ratio gates, the two
// scatter-min passes that keep the lowest distance and then the lowest point
// index per keypoint, and the gather of the observations and their sigma^2).
//
// Bound on the H100: bytes and launch latency. Per point it reads kernel C's
// four outputs and writes kernel D's inputs (~17 bytes): about 0.5 MB a pass
// at P = 12288, under a microsecond of memory time, so the two launches'
// latency is most of its cost. The reference scatters twice into (N,)
// arrays, gathers, and concatenates the observation columns.
// Design: launch 1, a thread per point, applies the gates and posts a claim
// as one 64-bit atomicMin of (distance << 32 | point index) per keypoint: the
// smallest key is the lowest distance, then the lowest point index, which is
// what the two scatter-min passes select. Launch 2, a thread per point, keeps
// the points whose key won and writes the observation (x, y, u_right or -1)
// and sigma^2 (from the host's sf^(2 level) table) straight into kernel D's
// buffers. The keys are reset by a memset in the same entry point. Claims,
// keep, observations and sigma^2 are bit-exact against the plain version.
// A launch given a gate (the retry pass of the cascade) returns at once
// unless the first pass's inlier count is below the threshold.
#include "common.cuh"

namespace {

__global__ void claim_resolve_min_kernel(
    const int* gate_n, int gate_min, const int* __restrict__ best_idx,
    const int* __restrict__ best, const int* __restrict__ second,
    const int* __restrict__ second_idx, const uint8_t* __restrict__ row_valid,
    const int* __restrict__ kp_octave, int P, int max_dist, float nn_ratio,
    unsigned long long* __restrict__ keys, uint8_t* __restrict__ ok_out) {
  if (gate_n != nullptr && !(*gate_n < gate_min)) return;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int b = best[p];
  const int j = best_idx[p];
  bool ok = b <= max_dist && row_valid[p];
  const bool ratio_ok =
      static_cast<float>(b) < nn_ratio * static_cast<float>(second[p]);
  const bool same_lvl = kp_octave[j] == kp_octave[second_idx[p]];
  ok = ok && (ratio_ok || !same_lvl);
  if (ok) {
    atomicMin(keys + j, (static_cast<unsigned long long>(b) << 32) |
                            static_cast<unsigned int>(p));
  }
  ok_out[p] = ok;
}

__global__ void claim_resolve_keep_kernel(
    const int* gate_n, int gate_min, const uint8_t* __restrict__ ok,
    const int* __restrict__ best_idx,
    const unsigned long long* __restrict__ keys,
    const float* __restrict__ kp_xy, const float* __restrict__ kp_ur,
    const int* __restrict__ kp_octave, const float* __restrict__ sig2_table,
    int P, int* __restrict__ kp_of_mp, uint8_t* __restrict__ keep,
    float* __restrict__ obs, float* __restrict__ sigma2) {
  if (gate_n != nullptr && !(*gate_n < gate_min)) return;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int j = best_idx[p];
  const bool k =
      ok[p] && static_cast<unsigned int>(keys[j] & 0xffffffffull) ==
                   static_cast<unsigned int>(p);
  const int idx = k ? j : 0;
  kp_of_mp[p] = k ? j : -1;
  keep[p] = k;
  obs[3 * p] = kp_xy[2 * idx];
  obs[3 * p + 1] = kp_xy[2 * idx + 1];
  obs[3 * p + 2] = k ? kp_ur[idx] : -1.0f;
  sigma2[p] = sig2_table[kp_octave[idx]];
}

}  // namespace

OSL_EXPORT int osl_claim_resolve(
    const int* best_idx, const int* best, const int* second,
    const int* second_idx, const uint8_t* row_valid, int P, const float* kp_xy,
    const float* kp_ur, const int* kp_octave, int N, const float* sig2_table,
    int max_dist, float nn_ratio, const int* gate_n, int gate_min,
    unsigned long long* keys, uint8_t* ok, int* kp_of_mp, uint8_t* keep,
    float* obs, float* sigma2, void* stream) {
  if (P <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(keys, 0xff, sizeof(unsigned long long) * N, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  const int blocks = (P + threads - 1) / threads;
  claim_resolve_min_kernel<<<blocks, threads, 0, s>>>(
      gate_n, gate_min, best_idx, best, second, second_idx, row_valid,
      kp_octave, P, max_dist, nn_ratio, keys, ok);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  claim_resolve_keep_kernel<<<blocks, threads, 0, s>>>(
      gate_n, gate_min, ok, best_idx, keys, kp_xy, kp_ur, kp_octave,
      sig2_table, P, kp_of_mp, keep, obs, sigma2);
  return static_cast<int>(cudaGetLastError());
}
