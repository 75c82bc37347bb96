// Kernel J: the FAST keypoint selection of one pyramid level.
//
// Replaces orbslam2_tpu/ops/orb.py:138-197 (detect_level after the score
// and the NMS): the per-32x32-cell dual threshold, the per-cell top-8 as
// eight rounds of (argmax, mask), the round-robin selection of the level's
// budget by a stable argsort over rank * 4096 - score, and the parabola
// subpixel offsets.
//
// Bound on the H100: latency, not bytes or operations. The inputs are two
// score maps (2.4 MB at 640x480, read once) and the work is ~80 compares a
// pixel; what limits a level is that the selection is global over the
// level's cells (a sort of up to cells * 8 keys), so one block does it with
// a chain of barriers.
// Design: one block per level. Each warp takes cells in turn; lane l holds
// column l of its cell in registers (32 rows), the warp reduces the cell
// max, applies the threshold (scores not > it, and the padding beyond the
// image, become -1), then runs the eight rounds: each lane its best unpicked
// row (strict >, so the first row wins), the warp the best (value, index)
// with the first row-major index on ties. A cell with fewer than 8 positive
// scores fills its slots with its first unpicked -1 entries, as the
// reference does. Each slot's key is the float32 rank * 4096 - v (inf where
// v <= 0), stored as (order-preserving key bits << 32 | flat slot index) in
// shared memory, so a bitonic sort of the u64s gives exactly the stable
// argsort's order, ties between keys that round to one float32 included.
// The first n_out entries are decoded; the parabola reads the raw score map
// at the clamped position; the outputs go straight into the frame's
// feature buffers (level coordinates xy_int for kernel B; xy_sub scaled to
// level 0, response, octave and validity). Every float operation is the
// plain version's single float32 op: bit-exact, invalid slots included.
#include "common.cuh"

namespace {

constexpr int kCell = 32;
constexpr int kTopK = 8;
constexpr int kThreads = 512;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned orderable(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float parabola(float l, float c, float r) {
  const float den = 2.0f * c - l - r;
  const float off = den > 1e-6f ? 0.5f * (r - l) / fmaxf(den, 1e-6f) : 0.0f;
  return fminf(fmaxf(off, -0.5f), 0.5f);
}

__global__ void __launch_bounds__(kThreads)
orb_select_kernel(const float* __restrict__ s_raw,
                  const float* __restrict__ s_nms, int H, int W, int n_out,
                  float ini_th, float min_th, float scale, int level,
                  int sort_n, int* __restrict__ xy_int,
                  float* __restrict__ xy_out, float* __restrict__ resp_out,
                  int* __restrict__ octave_out, bool* __restrict__ valid_out) {
  const int Hc = (H + kCell - 1) / kCell;
  const int Wc = (W + kCell - 1) / kCell;
  const int n_cells = Hc * Wc;
  const int n_keys = n_cells * kTopK;
  extern __shared__ unsigned long long keys[];                 // sort_n
  float* vals = reinterpret_cast<float*>(keys + sort_n);       // n_keys
  unsigned short* within = reinterpret_cast<unsigned short*>(vals + n_keys);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int cell = warp; cell < n_cells; cell += kThreads / 32) {
    const int cy0 = (cell / Wc) * kCell;
    const int x = (cell % Wc) * kCell + lane;
    float v[kCell];
    float m = -INFINITY;
#pragma unroll
    for (int r = 0; r < kCell; ++r) {
      const int y = cy0 + r;
      v[r] = (y < H && x < W) ? s_nms[y * W + x] : -1.0f;
      m = fmaxf(m, v[r]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    const float th = m > ini_th ? ini_th : min_th;
#pragma unroll
    for (int r = 0; r < kCell; ++r) v[r] = v[r] > th ? v[r] : -1.0f;

    unsigned picked = 0;  // rows of this lane's column already taken
    for (int k = 0; k < kTopK; ++k) {
      float best = -INFINITY;
      int row = 0;
#pragma unroll
      for (int r = 0; r < kCell; ++r) {
        if (!((picked >> r) & 1u) && v[r] > best) {
          best = v[r];
          row = r;
        }
      }
      int idx = row * kCell + lane;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ob = __shfl_xor_sync(kFull, best, o);
        const int oi = __shfl_xor_sync(kFull, idx, o);
        if (ob > best || (ob == best && oi < idx)) {
          best = ob;
          idx = oi;
        }
      }
      if (lane == (idx & (kCell - 1))) picked |= 1u << (idx / kCell);
      if (lane == 0) {
        const int slot = cell * kTopK + k;
        const float key = best > 0.0f ? static_cast<float>(k) * 4096.0f - best
                                       : INFINITY;
        vals[slot] = best;
        within[slot] = static_cast<unsigned short>(idx);
        keys[slot] = (static_cast<unsigned long long>(orderable(key)) << 32) |
                     static_cast<unsigned>(slot);
      }
    }
  }
  for (int i = n_keys + threadIdx.x; i < sort_n; i += kThreads) keys[i] = ~0ull;
  __syncthreads();

  // bitonic sort, ascending; the keys are distinct (slot in the low bits)
  for (int k = 2; k <= sort_n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < sort_n; i += kThreads) {
        const int p = i ^ j;
        if (p > i) {
          const unsigned long long a = keys[i], b = keys[p];
          if ((a > b) == ((i & k) == 0)) {
            keys[i] = b;
            keys[p] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  for (int s = threadIdx.x; s < n_out; s += kThreads) {
    const unsigned long long e = keys[s];
    const int slot = static_cast<int>(e & 0xffffffffull);
    const unsigned kb = static_cast<unsigned>(e >> 32);
    const float key = __uint_as_float((kb & 0x80000000u) ? (kb & 0x7fffffffu) : ~kb);
    const bool ok = key < 1e9f;
    const int cell = slot / kTopK;
    const int w = within[slot];
    const int cy = (cell / Wc) * kCell + w / kCell;
    const int cx = (cell % Wc) * kCell + w % kCell;
    const int yc = osl::clampi(cy, 1, H - 2);
    const int xc = osl::clampi(cx, 1, W - 2);
    const float c0 = s_raw[yc * W + xc];
    const float dx = parabola(s_raw[yc * W + xc - 1], c0, s_raw[yc * W + xc + 1]);
    const float dy = parabola(s_raw[(yc - 1) * W + xc], c0, s_raw[(yc + 1) * W + xc]);
    xy_int[2 * s] = cx;
    xy_int[2 * s + 1] = cy;
    xy_out[2 * s] = (static_cast<float>(cx) + dx) * scale;
    xy_out[2 * s + 1] = (static_cast<float>(cy) + dy) * scale;
    resp_out[s] = ok ? vals[slot] : 0.0f;
    valid_out[s] = ok;
    if (octave_out != nullptr) octave_out[s] = level;
  }
}

}  // namespace

// Shared memory: sort_n u64 keys (the next power of two of cells * 8), then
// cells * 8 float32 scores and u16 within-cell indices. The wrapper checks
// the size against the card's opt-in limit.
OSL_EXPORT int osl_orb_select(const float* s_raw, const float* s_nms, int H,
                              int W, int n_out, float ini_th, float min_th,
                              float scale, int level, int* xy_int,
                              float* xy_out, float* resp_out, int* octave_out,
                              bool* valid_out, void* stream) {
  const int n_keys = ((H + kCell - 1) / kCell) * ((W + kCell - 1) / kCell) * kTopK;
  int sort_n = 1;
  while (sort_n < n_keys) sort_n <<= 1;
  const size_t smem = sizeof(unsigned long long) * sort_n +
                      (sizeof(float) + sizeof(unsigned short)) * n_keys;
  static size_t smem_set = 48 * 1024;  // the default limit
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        orb_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  orb_select_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      s_raw, s_nms, H, W, n_out, ini_th, min_th, scale, level, sort_n, xy_int,
      xy_out, resp_out, octave_out, valid_out);
  return static_cast<int>(cudaGetLastError());
}
