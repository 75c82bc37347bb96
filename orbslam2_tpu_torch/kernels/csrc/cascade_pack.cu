// Kernel R: the tracking cascade's packed result, in one block.
//
// Replaces the tail of orbslam2_tpu/tracking.py: _fused_cascade (the choice
// between the local-map and the tight pass, the close-point census for the
// keyframe decision and the per-point code), whose concatenated vector is
// the frame's only device-to-host copy.
//
// Bound on the H100: launch latency. It reads ~14 bytes a point and writes
// 4, about 0.2 MB at P = 12288 (well under a microsecond of memory time).
// Design: one block of 1024 threads, so the census needs no second launch:
// the pass is chosen on the device (use3 = n3 >= n2), every thread writes
// the codes (kp + 1) * 4 + inlier * 2 + frustum of its points and marks the
// keypoints they track in a shared byte array, and after a barrier the block
// counts the close keypoints (valid, 0 < depth < th_depth) tracked and not
// tracked. Thread 0..15 write the chosen pose, thread 0 the four counts.
// The packed vector is bit-exact against the plain version.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads) cascade_pack_kernel(
    const float* __restrict__ T2, const int* __restrict__ n2,
    const uint8_t* __restrict__ inl2, const int* __restrict__ kp2,
    const float* __restrict__ T3, const int* __restrict__ n3,
    const uint8_t* __restrict__ inl3, const int* __restrict__ kp3,
    const int* __restrict__ n_motion, const uint8_t* __restrict__ frustum,
    int P, const uint8_t* __restrict__ kp_valid,
    const float* __restrict__ kp_depth, int N, float th_depth,
    float* __restrict__ packed) {
  extern __shared__ uint8_t tracked[];  // N bytes
  __shared__ int counts[2];
  const int tid = threadIdx.x;
  const bool use3 = *n3 >= *n2;
  const int* kp = use3 ? kp3 : kp2;
  const uint8_t* inl = use3 ? inl3 : inl2;
  for (int j = tid; j < N; j += kThreads) tracked[j] = 0;
  if (tid < 2) counts[tid] = 0;
  __syncthreads();
  for (int p = tid; p < P; p += kThreads) {
    const int k = kp[p];
    const int in = inl[p] ? 1 : 0;
    if (in && k >= 0) tracked[k] = 1;
    packed[20 + p] = static_cast<float>((k + 1) * 4 + in * 2 + (frustum[p] ? 1 : 0));
  }
  __syncthreads();
  int tc = 0, uc = 0;
  for (int j = tid; j < N; j += kThreads) {
    const float d = kp_depth[j];
    if (kp_valid[j] && d > 0.0f && d < th_depth) {
      if (tracked[j]) ++tc; else ++uc;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    tc += __shfl_xor_sync(kFull, tc, o);
    uc += __shfl_xor_sync(kFull, uc, o);
  }
  if ((tid & 31) == 0) {
    atomicAdd(&counts[0], tc);
    atomicAdd(&counts[1], uc);
  }
  __syncthreads();
  if (tid < 16) packed[tid] = use3 ? T3[tid] : T2[tid];
  if (tid == 0) {
    packed[16] = static_cast<float>(*n_motion);
    packed[17] = static_cast<float>(use3 ? *n3 : *n2);
    packed[18] = static_cast<float>(counts[0]);
    packed[19] = static_cast<float>(counts[1]);
  }
}

}  // namespace

OSL_EXPORT int osl_cascade_pack(
    const float* T2, const int* n2, const uint8_t* inl2, const int* kp2,
    const float* T3, const int* n3, const uint8_t* inl3, const int* kp3,
    const int* n_motion, const uint8_t* frustum, int P, const uint8_t* kp_valid,
    const float* kp_depth, int N, float th_depth, float* packed, void* stream) {
  cascade_pack_kernel<<<1, kThreads, N, static_cast<cudaStream_t>(stream)>>>(
      T2, n2, inl2, kp2, T3, n3, inl3, kp3, n_motion, frustum, P, kp_valid,
      kp_depth, N, th_depth, packed);
  return static_cast<int>(cudaGetLastError());
}
