// Kernel T: the fuse projection search of local mapping, every direction in
// one launch.
//
// Replaces orbslam2_tpu/local_mapping.py: _fuse_match_body (vmapped over the
// 2N SearchInNeighbors directions by _fuse_match_batch / _fuse_match_mirror):
// project a window of points into a keyframe (z > 0.05, in image), the
// radius gate 3 sf^octave(kp) around the projection, Hamming best under the
// gate, TH_LOW, no ratio test.
//
// Bound on the H100: the gate. At D = 20 directions x P = 1024 points x
// N = 1024 keypoints the reference builds a (D, P, N) distance matrix, a
// pair mask and a Hamming matrix (21 M entries each); the gate admits a few
// keypoints per point, so the pairs that need a descriptor are a small share.
// Design: a block per (direction, 64 points), eight warps, a warp per point.
// The block stages the destination keyframe's keypoints as (x, y, r^2) in
// shared memory (r from the host's radius-per-octave table; r^2 = -1 for an
// invalid keypoint, which no distance passes). Every lane projects the point
// as the plain version does (R X + t term by term, 1 / z, fx x inv_z + cx),
// then scans keypoints j = lane, lane + 32, ...; an admitted pair loads the
// keypoint's descriptor (two 16-byte loads) for eight __popc. The lanes keep
// their best (distance << 32 | index) key and a butterfly min gives the
// first index on ties, as masked_top2's argmin. Only the best is kept: with
// no ratio test the second never decides. Built without FMA contraction;
// idx, dist and valid are bit-exact against the plain version.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kPoints = 64;  // per block, eight per warp
constexpr int kInvalid = 0x7fffffff / 2;  // matching.INVALID
constexpr unsigned kFull = 0xffffffffu;

struct Cam {
  float fx, fy, cx, cy;
  int width, height;
};

__global__ void __launch_bounds__(kWarps * 32) fuse_match_kernel(
    const float* __restrict__ mp_pos, const uint8_t* __restrict__ mp_desc,
    const uint8_t* __restrict__ mp_valid, const float* __restrict__ Tcw,
    const float* __restrict__ kp_xy, const uint8_t* __restrict__ kp_desc,
    const int* __restrict__ kp_octave, const uint8_t* __restrict__ kp_valid,
    int P, int N, Cam cam, const float* __restrict__ r_table, int max_dist,
    int* __restrict__ idx_out, int* __restrict__ dist_out,
    uint8_t* __restrict__ valid_out) {
  extern __shared__ float smem[];
  float* kx = smem;
  float* ky = smem + N;
  float* kr2 = smem + 2 * N;
  const int d = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* xy = kp_xy + 2LL * N * d;
  for (int j = tid; j < N; j += kWarps * 32) {
    kx[j] = xy[2 * j];
    ky[j] = xy[2 * j + 1];
    float r2 = -1.0f;
    if (kp_valid[(long long)N * d + j]) {
      const float r = r_table[kp_octave[(long long)N * d + j]];
      r2 = r * r;
    }
    kr2[j] = r2;
  }
  __syncthreads();
  const float* T = Tcw + 16 * d;
  const uint8_t* kd_base = kp_desc + 32LL * N * d;
  for (int k = 0; k < kPoints / kWarps; ++k) {
    const int p = blockIdx.x * kPoints + warp + kWarps * k;
    if (p >= P) break;
    const long long row = (long long)P * d + p;
    const float X = mp_pos[3 * row], Y = mp_pos[3 * row + 1],
                Z = mp_pos[3 * row + 2];
    float pc[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      pc[i] = T[4 * i] * X + T[4 * i + 1] * Y + T[4 * i + 2] * Z + T[4 * i + 3];
    }
    const float z = pc[2];
    const float inv_z = 1.0f / (fabsf(z) < 1e-8f ? 1e-8f : z);
    const float u = cam.fx * pc[0] * inv_z + cam.cx;
    const float v = cam.fy * pc[1] * inv_z + cam.cy;
    const bool ok_row = mp_valid[row] && z > 0.05f && u >= 0.0f &&
                        u < static_cast<float>(cam.width) && v >= 0.0f &&
                        v < static_cast<float>(cam.height);
    unsigned long long b = ~0ull;
    if (ok_row) {
      const uint4* rd = reinterpret_cast<const uint4*>(mp_desc + 32 * row);
      const uint4 a0 = rd[0];
      const uint4 a1 = rd[1];
      for (int j = lane; j < N; j += 32) {
        const float dx = u - kx[j];
        const float dy = v - ky[j];
        if (!(dx * dx + dy * dy <= kr2[j])) continue;
        const uint4* kd = reinterpret_cast<const uint4*>(kd_base + 32 * j);
        const uint4 b0 = kd[0];
        const uint4 b1 = kd[1];
        const int dist = __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) +
                         __popc(a0.z ^ b0.z) + __popc(a0.w ^ b0.w) +
                         __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
                         __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
        const unsigned long long key =
            (static_cast<unsigned long long>(dist) << 32) |
            static_cast<unsigned int>(j);
        b = key < b ? key : b;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long ob = __shfl_xor_sync(kFull, b, o);
      b = ob < b ? ob : b;
    }
    if (lane == 0) {
      const int bd = static_cast<int>(b >> 32);
      const bool ok = b != ~0ull && bd <= max_dist;
      idx_out[row] = ok ? static_cast<int>(b & 0xffffffffull) : -1;
      dist_out[row] = ok ? bd : kInvalid;
      valid_out[row] = ok;
    }
  }
}

}  // namespace

OSL_EXPORT int osl_fuse_match(
    const float* mp_pos, const uint8_t* mp_desc, const uint8_t* mp_valid,
    const float* Tcw, const float* kp_xy, const uint8_t* kp_desc,
    const int* kp_octave, const uint8_t* kp_valid, int D, int P, int N,
    float fx, float fy, float cx, float cy, int width, int height,
    const float* r_table, int max_dist, int* idx, int* dist, uint8_t* valid,
    void* stream) {
  if (D <= 0 || P <= 0) return 0;
  const Cam cam{fx, fy, cx, cy, width, height};
  const dim3 grid((P + kPoints - 1) / kPoints, D);
  fuse_match_kernel<<<grid, kWarps * 32, 3 * sizeof(float) * N,
                      static_cast<cudaStream_t>(stream)>>>(
      mp_pos, mp_desc, mp_valid, Tcw, kp_xy, kp_desc, kp_octave, kp_valid, P,
      N, cam, r_table, max_dist, idx, dist, valid);
  return static_cast<int>(cudaGetLastError());
}
