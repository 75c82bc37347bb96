// Kernel U: the mutual, rotation-checked descriptor matcher, two launches.
//
// Replaces orbslam2_tpu/ops/matching.py: match_descriptors with mutual=True
// and check_rotation=True, the pair mask either absent or the radius window
// of orbslam2_tpu/tracking.py: match_frames_windowed (SearchForInitialization),
// as the reference-keyframe fallback and the monocular initialisation call it;
// with check_rotation = 0, match_descriptors(mutual=True) with no rotation
// check, as relocalization calls it (orbslam2_tpu/tracking.py:1315).
//
// Bound on the H100: the pair work. The reference builds the (Na, Nb)
// distance matrix, the pair mask and top-2 along both axes; at Na = Nb =
// 2048 that is 4.2 M pairs, each a 256-bit popcount, against 2 x 67 KB of
// descriptors, so the pairs and not the bytes set the bound.
// Design. Launch 1 (match): a warp per A row, lane l scanning B columns
// j = l, l + 32, ...; the window gate (dx^2 + dy^2 <= r^2, the plain
// version's float32 operations) and B's validity decide a pair, whose
// distance is eight __popc. The lanes keep best and second-best
// (distance << 32 | j) keys, merged across the warp by a butterfly, which
// is masked_top2's first-index-on-ties rule; each admitted pair also posts
// (distance << 32 | i) to column j by a 64-bit atomicMin, so the column's
// best A row (argmin of the transposed matrix, first on ties) is known
// without a second scan. The column keys start at all ones (a memset in the
// same entry point). Launch 2 (gates): one block applies TH_LOW, the ratio
// test best < ratio * second in float32 and the mutual check (the column's
// key names the row), bins the angle difference into 30 bins with
// jnp.mod's floor-mod (fmodf, then + 2 pi where negative), builds the
// histogram in shared memory, keeps the top 3 bins (lax.top_k: the lower
// bin first on equal counts) by the 10% rule, and writes idx, dist, valid;
// without the rotation check it writes the rows the other gates passed.
// All outputs are integers and bit-exact against the plain version.
#include "common.cuh"

namespace {

constexpr int kInvalid = 0x7fffffff / 2;  // matching.INVALID
constexpr int kHisto = 30;
constexpr int kMaxA = 8192;               // rows launch 2 keeps in shared memory
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

__global__ void match_rot_kernel(
    const uint8_t* __restrict__ desc_a, const uint8_t* __restrict__ valid_a,
    const float* __restrict__ xy_a, int Na, const uint8_t* __restrict__ desc_b,
    const uint8_t* __restrict__ valid_b, const float* __restrict__ xy_b,
    int Nb, float window, int use_window, int* __restrict__ row_best,
    int* __restrict__ row_second, int* __restrict__ row_idx,
    unsigned long long* __restrict__ col_key) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= Na) return;  // whole warps exit together
  unsigned long long b = kNone;
  unsigned long long s = kNone;
  if (valid_a[i]) {
    const uint4* rd = reinterpret_cast<const uint4*>(desc_a + 32 * i);
    const uint4 a0 = rd[0];
    const uint4 a1 = rd[1];
    const float ax = use_window ? xy_a[2 * i] : 0.0f;
    const float ay = use_window ? xy_a[2 * i + 1] : 0.0f;
    const float r2 = window * window;
    for (int j = lane; j < Nb; j += 32) {
      if (!valid_b[j]) continue;
      if (use_window) {
        const float dx = ax - xy_b[2 * j];
        const float dy = ay - xy_b[2 * j + 1];
        if (!(dx * dx + dy * dy <= r2)) continue;
      }
      const uint4* kd = reinterpret_cast<const uint4*>(desc_b + 32 * j);
      const uint4 b0 = kd[0];
      const uint4 b1 = kd[1];
      const int d = __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) +
                    __popc(a0.z ^ b0.z) + __popc(a0.w ^ b0.w) +
                    __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
                    __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
      const unsigned long long dk = static_cast<unsigned long long>(d) << 32;
      merge(b, s, dk | static_cast<unsigned int>(j), kNone);
      atomicMin(col_key + j, dk | static_cast<unsigned int>(i));
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
    row_best[i] = bd;
    row_second[i] = static_cast<int>(s >> 32);
    row_idx[i] = (bd == kInvalid) ? 0 : static_cast<int>(b & 0xffffffffu);
  }
}

__global__ void match_rot_gates_kernel(
    const uint8_t* __restrict__ valid_a, const float* __restrict__ angle_a,
    int Na, const float* __restrict__ angle_b, const int* __restrict__ row_best,
    const int* __restrict__ row_second, const int* __restrict__ row_idx,
    const unsigned long long* __restrict__ col_key, int max_dist,
    float nn_ratio, int use_ratio, int check_rotation, float two_pi,
    float bin_scale, int* __restrict__ out_idx, int* __restrict__ out_dist,
    uint8_t* __restrict__ out_valid) {
  __shared__ short row_bin[kMaxA];  // the row's bin where it passed, else -1
  __shared__ int counts[kHisto];
  __shared__ int keep_bin[kHisto];
  for (int k = threadIdx.x; k < kHisto; k += blockDim.x) counts[k] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < Na; i += blockDim.x) {
    const int best = row_best[i];
    const int j = row_idx[i];
    bool ok = valid_a[i] && best <= max_dist;
    if (use_ratio) {
      ok = ok && static_cast<float>(best) <
                     nn_ratio * static_cast<float>(row_second[i]);
    }
    ok = ok && static_cast<int>(col_key[j] & 0xffffffffull) == i;
    int bin = -1;
    if (ok && !check_rotation) {
      bin = 0;
    } else if (ok) {
      float m = fmodf(angle_a[i] - angle_b[j], two_pi);
      if (m != 0.0f && m < 0.0f) m = m + two_pi;
      bin = osl::clampi(static_cast<int>(m * bin_scale), 0, kHisto - 1);
      atomicAdd(&counts[bin], 1);
    }
    row_bin[i] = static_cast<short>(bin);
  }
  __syncthreads();
  if (threadIdx.x == 0 && !check_rotation) {
    keep_bin[0] = 1;
  } else if (threadIdx.x == 0) {
    int top[3];
    for (int k = 0; k < 3; ++k) {
      int arg = -1;
      for (int q = 0; q < kHisto; ++q) {
        const bool taken = (k > 0 && top[0] == q) || (k > 1 && top[1] == q);
        if (!taken && (arg < 0 || counts[q] > counts[arg])) arg = q;
      }
      top[k] = arg;
    }
    for (int q = 0; q < kHisto; ++q) keep_bin[q] = 0;
    int th = static_cast<int>(0.1f * static_cast<float>(counts[top[0]]));
    th = th < 1 ? 1 : th;
    for (int k = 0; k < 3; ++k) keep_bin[top[k]] = counts[top[k]] >= th;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < Na; i += blockDim.x) {
    const int bin = row_bin[i];
    const bool ok = bin >= 0 && keep_bin[bin];
    out_idx[i] = ok ? row_idx[i] : -1;
    out_dist[i] = ok ? row_best[i] : kInvalid;
    out_valid[i] = ok ? 1 : 0;
  }
}

}  // namespace

OSL_EXPORT int osl_match_rot(
    const uint8_t* desc_a, const uint8_t* valid_a, const float* xy_a,
    const float* angle_a, int Na, const uint8_t* desc_b,
    const uint8_t* valid_b, const float* xy_b, const float* angle_b, int Nb,
    float window, int use_window, int max_dist, float nn_ratio, int use_ratio,
    int check_rotation, float two_pi, float bin_scale, int* row_best,
    int* row_second,
    int* row_idx, unsigned long long* col_key, int* out_idx, int* out_dist,
    uint8_t* out_valid, void* stream) {
  if (Na <= 0) return 0;
  if (Na > kMaxA) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(col_key, 0xff,
                                    sizeof(unsigned long long) * (Nb > 0 ? Nb : 1),
                                    st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;  // 8 rows per block
  match_rot_kernel<<<(Na * 32 + threads - 1) / threads, threads, 0, st>>>(
      desc_a, valid_a, xy_a, Na, desc_b, valid_b, xy_b, Nb, window, use_window,
      row_best, row_second, row_idx, col_key);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  match_rot_gates_kernel<<<1, 1024, 0, st>>>(
      valid_a, angle_a, Na, angle_b, row_best, row_second, row_idx, col_key,
      max_dist, nn_ratio, use_ratio, check_rotation, two_pi, bin_scale, out_idx,
      out_dist, out_valid);
  return static_cast<int>(cudaGetLastError());
}
