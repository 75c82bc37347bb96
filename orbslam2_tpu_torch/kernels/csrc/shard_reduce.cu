// Kernel shard_reduce: the landmark shards' partial sums added into one, in
// shard order.
//
// Replaces the psum of the sharded bundle adjustment inside one process:
// orbslam2_tpu/ops/ba.py:345-347 (S and b_S, once an LM iteration) and
// :219-220 (the robust cost), where XLA's all-reduce over the "landmarks"
// mesh axis adds the devices' partials. Here the shards' partials are the
// rows of one (n, L) float32 buffer on one card (kernels E and G write
// their rows directly; rows from other cards are peer-copied in), and
// out[j] = ((x[0][j] + x[1][j]) + x[2][j]) + ... in float32, shards 0..n-1
// in that order, so every run and every shard count gives one rounding.
//
// Bound on the H100: bytes. It reads n L floats and writes L (at K = 256
// cameras, n = 4: 37.8 MB and 9.4 MB, ~0.014 ms at 3.35 TB/s) and does
// (n - 1) L additions. Design: a grid-stride loop, each thread a float4 of
// the row (when L is a multiple of 4) and the n shards' values of it summed
// in a register, so each byte moves once, coalesced.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
shard_reduce4_kernel(const float4* __restrict__ x, int n, long long L4,
                     float4* __restrict__ out) {
  for (long long j = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
       j < L4; j += static_cast<long long>(gridDim.x) * kThreads) {
    float4 s = x[j];
    for (int i = 1; i < n; ++i) {
      const float4 v = x[i * L4 + j];
      s.x = s.x + v.x;
      s.y = s.y + v.y;
      s.z = s.z + v.z;
      s.w = s.w + v.w;
    }
    out[j] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
shard_reduce1_kernel(const float* __restrict__ x, int n, long long L,
                     float* __restrict__ out) {
  for (long long j = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
       j < L; j += static_cast<long long>(gridDim.x) * kThreads) {
    float s = x[j];
    for (int i = 1; i < n; ++i) s = s + x[i * L + j];
    out[j] = s;
  }
}

int grid_for(long long items) {
  const long long blocks = (items + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 132 * 16 ? (blocks > 0 ? blocks : 1) : 132 * 16);
}

}  // namespace

OSL_EXPORT int osl_shard_reduce(const float* x, int n, long long L, float* out,
                                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = L % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (aligned) {
    shard_reduce4_kernel<<<grid_for(L / 4), kThreads, 0, st>>>(
        reinterpret_cast<const float4*>(x), n, L / 4,
        reinterpret_cast<float4*>(out));
  } else {
    shard_reduce1_kernel<<<grid_for(L), kThreads, 0, st>>>(x, n, L, out);
  }
  return static_cast<int>(cudaGetLastError());
}
