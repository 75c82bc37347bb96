// Kernel I: one pyramid level, the bilinear resize from the previous level
// and the level's 7-tap separable Gaussian blur, in one launch.
//
// Replaces orbslam2_tpu/ops/image.py: resize_bilinear (two dense static
// interpolation matrices, Ry @ img @ Cx^T, a TPU layout that feeds the MXU)
// and gaussian_blur (reflect-padded shifted adds), as build_pyramid and the
// extractor call them once per level.
//
// Bound on the H100: memory and launch. Per output pixel the work is ~25
// float32 operations against one pixel read from the previous level and two
// written (the level and its blur); at 640x480 a level is ~1.2 MB, so the
// kernel is a few microseconds of traffic and the launch dominates.
// Design: one block per 32x16 output tile, everything between the read and
// the two writes kept in shared memory. The block stages the rectangle of
// source pixels its tile and the blur's 3-pixel halo read, applies the rows
// pass (two taps per output row, the intermediate rounded to float32 as the
// plain version's first gather-and-add), then the columns pass into the
// resized tile with its halo, writes the level's own pixels, and runs the
// vertical then the horizontal blur pass from shared memory. The two taps
// and their float32 weights come from tables built once per shape from the
// reference's interpolation matrix (where both taps name one pixel, the
// matrix's summed weight and 0), so every output is the same two products
// and one add as the plain version: bit-exact. Reflect padding excludes the
// edge (index -1 reads 1). Level 0 has no resize: the tile with its halo is
// read from the input and only the blur runs.
#include "common.cuh"

namespace {

constexpr int kTw = 32;             // output tile width
constexpr int kTh = 16;             // output tile height
constexpr int kR = 3;               // blur radius (7 taps)
constexpr int kLw = kTw + 2 * kR;   // resized tile with its halo
constexpr int kLh = kTh + 2 * kR;
constexpr int kThreads = 256;

struct Taps {
  float k[2 * kR + 1];
};

// numpy / torch "reflect": the edge pixel is not repeated
__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return osl::clampi(i, 0, n - 1);
}

__global__ void __launch_bounds__(kThreads)
pyramid_level_kernel(const float* __restrict__ src, int Ws,
                     const int* __restrict__ ry, const float* __restrict__ wy,
                     const int* __restrict__ rx, const float* __restrict__ wx,
                     int span_c, Taps taps, float* __restrict__ level,
                     float* __restrict__ blurred, int H, int W) {
  extern __shared__ float dyn[];  // staged source rectangle, then rows pass
  __shared__ float lvl_s[kLh][kLw];
  __shared__ float ver_s[kTh][kLw];
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kTw;
  const int r0 = blockIdx.y * kTh;
  // resized rows / columns the tile and its halo need (reflected at edges)
  const int nr = min(r0 + kTh, H) - r0 + 2 * kR;
  const int nc = min(c0 + kTw, W) - c0 + 2 * kR;

  if (ry != nullptr) {
    // the reflected indices of the halo stay within [rmin, rmax]
    const int rmin = max(r0 - kR, 0), rmax = min(r0 + kTh + kR - 1, H - 1);
    const int cmin = max(c0 - kR, 0), cmax = min(c0 + kTw + kR - 1, W - 1);
    const int sr0 = ry[2 * rmin], sr = ry[2 * rmax + 1] - sr0 + 1;
    const int sc0 = rx[2 * cmin], sc = rx[2 * cmax + 1] - sc0 + 1;
    float* src_s = dyn;                  // sr x span_c
    float* row_s = dyn + sr * span_c;    // kLh x span_c
    for (int i = tid; i < sr * sc; i += kThreads) {
      const int y = i / sc, x = i % sc;
      src_s[y * span_c + x] = src[(sr0 + y) * Ws + sc0 + x];
    }
    __syncthreads();
    for (int i = tid; i < nr * sc; i += kThreads) {
      const int lr = i / sc, k = i % sc;
      const int r = reflect(r0 - kR + lr, H);
      const float a = src_s[(ry[2 * r] - sr0) * span_c + k];
      const float b = src_s[(ry[2 * r + 1] - sr0) * span_c + k];
      row_s[lr * span_c + k] = wy[2 * r] * a + wy[2 * r + 1] * b;
    }
    __syncthreads();
    for (int i = tid; i < nr * nc; i += kThreads) {
      const int lr = i / nc, lc = i % nc;
      const int c = reflect(c0 - kR + lc, W);
      const float a = row_s[lr * span_c + rx[2 * c] - sc0];
      const float b = row_s[lr * span_c + rx[2 * c + 1] - sc0];
      lvl_s[lr][lc] = wx[2 * c] * a + wx[2 * c + 1] * b;
    }
  } else {
    for (int i = tid; i < nr * nc; i += kThreads) {
      const int lr = i / nc, lc = i % nc;
      lvl_s[lr][lc] =
          src[reflect(r0 - kR + lr, H) * W + reflect(c0 - kR + lc, W)];
    }
  }
  __syncthreads();

  // the level's own pixels, then the vertical pass over every halo column
  for (int i = tid; i < kTh * kLw; i += kThreads) {
    const int y = i / kLw, lc = i % kLw;
    if (r0 + y >= H || lc >= nc) continue;
    if (level != nullptr && lc >= kR && lc < nc - kR) {
      level[(r0 + y) * W + c0 + lc - kR] = lvl_s[y + kR][lc];
    }
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < 2 * kR + 1; ++t) acc = acc + taps.k[t] * lvl_s[y + t][lc];
    ver_s[y][lc] = acc;
  }
  __syncthreads();
  for (int i = tid; i < kTh * kTw; i += kThreads) {
    const int y = i / kTw, x = i % kTw;
    if (r0 + y >= H || c0 + x >= W) continue;
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < 2 * kR + 1; ++t) acc = acc + taps.k[t] * ver_s[y][x + t];
    blurred[(r0 + y) * W + c0 + x] = acc;
  }
}

}  // namespace

// ry/wy (H, 2) and rx/wx (W, 2): the two source taps of every output row and
// column and their weights; ry == nullptr means no resize (src is H x W and
// level is not written). span_r / span_c: the largest source rectangle a
// tile stages (from the tables, checked by the wrapper); k0..k6 the blur
// taps.
OSL_EXPORT int osl_pyramid_level(const float* src, int Ws, const int* ry,
                                 const float* wy, const int* rx,
                                 const float* wx, int span_r, int span_c,
                                 float k0, float k1, float k2, float k3,
                                 float k4, float k5, float k6, float* level,
                                 float* blurred, int H, int W, void* stream) {
  const Taps t = {{k0, k1, k2, k3, k4, k5, k6}};
  const size_t smem =
      ry == nullptr ? 0 : sizeof(float) * (size_t)(span_r + kLh) * span_c;
  const dim3 grid((W + kTw - 1) / kTw, (H + kTh - 1) / kTh);
  pyramid_level_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      src, Ws, ry, wy, rx, wx, span_c, t, level, blurred, H, W);
  return static_cast<int>(cudaGetLastError());
}
