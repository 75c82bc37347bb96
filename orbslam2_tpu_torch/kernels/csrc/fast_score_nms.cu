// Kernel A: FAST-9/16 corner score + border mask + 3x3 non-max suppression.
//
// Replaces orbslam2_tpu/ops/orb.py: fast_score_map (the 16 rolled ring
// differences and the doubling arc-min) and the border mask + 3x3 NMS at
// the top of detect_level.
//
// Bound on the H100: memory. Per pixel the work is 17 loads and ~300
// single-precision min/max/sub ops; the image (1.2 MB at 640x480 f32) sits
// in L2, so the limit is the two 4-byte stores per pixel and the launch.
// Design: one thread per pixel in 32x8 tiles. The border-masked scores of
// the tile plus a one-pixel halo go to shared memory, so the NMS reads its
// nine neighbours there instead of recomputing them or making a second
// pass over device memory. Every operation is one float32 subtract, min or
// max, so both outputs are bit-exact against the plain PyTorch version. Ring
// reads wrap around the image edges as the reference's jnp.roll does, so the
// raw score is exact even inside the masked border band.
#include "common.cuh"

#include <math.h>

namespace {

__constant__ int kRingDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kRingDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

constexpr int kTx = 32;
constexpr int kTy = 8;

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// max over polarity of (max over the 16 nine-long arcs of the min ring
// difference): the largest threshold at which the segment test passes.
__device__ float fast_score(const float* __restrict__ img, int H, int W, int y,
                            int x) {
  const float c = img[y * W + x];
  float d[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    d[k] = img[wrap(y + kRingDy[k], H) * W + wrap(x + kRingDx[k], W)] - c;
  }
  float bright = -INFINITY;
  float dark = -INFINITY;
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    float mn = d[s];
    float mx = d[s];
#pragma unroll
    for (int j = 1; j < 9; ++j) {
      const float v = d[(s + j) & 15];
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
    }
    bright = fmaxf(bright, mn);
    dark = fmaxf(dark, -mx);  // min over the arc of -d
  }
  return fmaxf(bright, dark);
}

__global__ void __launch_bounds__(kTx * kTy)
fast_score_nms_kernel(const float* __restrict__ img, float* __restrict__ s_raw,
                      float* __restrict__ s_nms, int H, int W, int border) {
  __shared__ float tile[kTy + 2][kTx + 2];
  const int x0 = blockIdx.x * kTx - 1;
  const int y0 = blockIdx.y * kTy - 1;
  const int tid = threadIdx.y * kTx + threadIdx.x;
  for (int i = tid; i < (kTy + 2) * (kTx + 2); i += kTx * kTy) {
    const int ty = i / (kTx + 2);
    const int tx = i % (kTx + 2);
    const int y = y0 + ty;
    const int x = x0 + tx;
    float v = -INFINITY;  // the max-pool's padding outside the image
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const bool inside = y >= border && y < H - border && x >= border &&
                          x < W - border;
      v = inside ? fast_score(img, H, W, y, x) : -1.0f;
    }
    tile[ty][tx] = v;
  }
  __syncthreads();

  const int x = blockIdx.x * kTx + threadIdx.x;
  const int y = blockIdx.y * kTy + threadIdx.y;
  if (x >= W || y >= H) return;
  const float s = tile[threadIdx.y + 1][threadIdx.x + 1];
  const bool inside = y >= border && y < H - border && x >= border &&
                      x < W - border;
  s_raw[y * W + x] = inside ? s : fast_score(img, H, W, y, x);
  float m = -INFINITY;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      m = fmaxf(m, tile[threadIdx.y + dy][threadIdx.x + dx]);
    }
  }
  s_nms[y * W + x] = (s >= m) ? s : -1.0f;
}

}  // namespace

OSL_EXPORT int osl_fast_score_nms(const float* img, float* s_raw, float* s_nms,
                                  int H, int W, int border, void* stream) {
  const dim3 block(kTx, kTy);
  const dim3 grid((W + kTx - 1) / kTx, (H + kTy - 1) / kTy);
  fast_score_nms_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, s_raw, s_nms, H, W, border);
  return static_cast<int>(cudaGetLastError());
}

OSL_EXPORT const char* osl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
