// Kernel Y: BoW word assignment and the L1-normalized TF-IDF vector, two
// launches.
//
// Replaces orbslam2_tpu/ops/bow.py: bow_vector, which builds the (N, W)
// Hamming distance matrix of N packed descriptors against W = 65536 words
// as a float matmul of unpacked bits, takes its argmin per row, scatters
// the counts into a (W,) histogram, weights it by IDF and L1-normalizes it.
//
// Bound on the H100: the popcounts, for this design. N = 1000 descriptors
// against 65536 words are 5.2e8 256-bit distances of 8 __popc each, against
// 2 MB of vocabulary, so the integer pipe (16 popcounts a clock per SM on
// compute capability 9.0) and not the bytes limits it. The distances are
// also a {0,1} product of depth 256, exact on the int8 tensor cores at
// about 7x that rate; chip_smoke.py bounds Y there, a route not taken yet.
// Design. Launch 1 (assign): grid (descriptor tiles of 256, word tiles of
// 1024). A block copies its 1024 words (32 KB) into shared memory, then
// each thread takes one descriptor in registers (two uint4) and scans the
// tile: XOR and eight __popc a word, the words read as shared-memory
// broadcasts. A thread keeps its first best (strict <), so ties go to the
// lower word, and posts (distance << 32 | word) to its descriptor by a
// 64-bit atomicMin, which keeps the lowest word among equal distances
// across tiles: jnp.argmin's first index on ties. The (N, W) matrix never
// reaches memory. Rows outside `valid` post nothing. Launch 2 (vector): one
// block writes the words (-1 outside `valid`), adds 1.0f per word into the
// zeroed vector by atomicAdd (exact for counts), then multiplies by IDF and
// divides by the L1 sum, max(sum, 1e-9), taken in a fixed order (strided
// per thread, then the warp butterfly, then the warps in order), so the
// vector is the same in every run. Words are bit-exact against the plain
// version; the vector differs only by the order of its sum.
// Words only (want_vector = 0, vocabulary training and its corpus
// assignment, N up to 2^19 rows a call): launch 2 is a grid of blocks that
// writes the words and nothing else; the vector is not touched.
#include "common.cuh"

namespace {

constexpr int kRows = 256;    // descriptors a block, one a thread
constexpr int kTile = 1024;   // words a block scans
constexpr unsigned kFull = 0xffffffffu;

__global__ void bow_words_assign_kernel(const uint8_t* __restrict__ desc,
                                        const uint8_t* __restrict__ valid,
                                        int N,
                                        const uint8_t* __restrict__ vocab,
                                        int W,
                                        unsigned long long* __restrict__ key) {
  __shared__ uint4 tile[2 * kTile];
  const int w0 = blockIdx.y * kTile;
  const int nw = min(kTile, W - w0);
  const uint4* src = reinterpret_cast<const uint4*>(vocab) + 2ll * w0;
  for (int k = threadIdx.x; k < 2 * nw; k += blockDim.x) tile[k] = src[k];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N || !valid[i]) return;
  const uint4* rd = reinterpret_cast<const uint4*>(desc) + 2ll * i;
  const uint4 a0 = rd[0];
  const uint4 a1 = rd[1];
  int best = 1 << 30;
  int arg = 0;
  for (int j = 0; j < nw; ++j) {
    const uint4 b0 = tile[2 * j];
    const uint4 b1 = tile[2 * j + 1];
    const int d = __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) +
                  __popc(a0.z ^ b0.z) + __popc(a0.w ^ b0.w) +
                  __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
                  __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
    if (d < best) {
      best = d;
      arg = j;
    }
  }
  atomicMin(key + i, (static_cast<unsigned long long>(best) << 32) |
                         static_cast<unsigned int>(w0 + arg));
}

__global__ void bow_words_only_kernel(const uint8_t* __restrict__ valid,
                                      const unsigned long long* __restrict__ key,
                                      int N, int* __restrict__ words) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < N) words[i] = valid[i] ? static_cast<int>(key[i] & 0xffffffffull) : -1;
}

__global__ void bow_words_vector_kernel(const uint8_t* __restrict__ valid,
                                        const unsigned long long* __restrict__ key,
                                        int N, const float* __restrict__ idf,
                                        int use_idf, int W,
                                        int* __restrict__ words,
                                        float* __restrict__ vec) {
  __shared__ float warp_sum[32];
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    int w = -1;
    if (valid[i]) {
      w = static_cast<int>(key[i] & 0xffffffffull);
      atomicAdd(vec + w, 1.0f);
    }
    words[i] = w;
  }
  __syncthreads();
  float s = 0.0f;
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    const float t = __ldcg(vec + w);
    s = s + (use_idf ? t * idf[w] : t);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s = s + __shfl_xor_sync(kFull, s, o);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = s;
  __syncthreads();
  float total = 0.0f;
  for (int k = 0; k < static_cast<int>(blockDim.x >> 5); ++k) total = total + warp_sum[k];
  const float denom = total < 1e-9f ? 1e-9f : total;
  __syncthreads();
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    const float t = __ldcg(vec + w);
    vec[w] = (use_idf ? t * idf[w] : t) / denom;
  }
}

}  // namespace

OSL_EXPORT int osl_bow_words(const uint8_t* desc, const uint8_t* valid, int N,
                             const uint8_t* vocab, int W, const float* idf,
                             int use_idf, int want_vector,
                             unsigned long long* key, int* words, float* vec,
                             void* stream) {
  if (W <= 0 || N < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (want_vector) {
    err = cudaMemsetAsync(vec, 0, sizeof(float) * W, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (N > 0) {
    err = cudaMemsetAsync(key, 0xff, sizeof(unsigned long long) * N, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((N + kRows - 1) / kRows, (W + kTile - 1) / kTile);
    bow_words_assign_kernel<<<grid, kRows, 0, st>>>(desc, valid, N, vocab, W, key);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (want_vector) {
    bow_words_vector_kernel<<<1, 1024, 0, st>>>(valid, key, N, idf, use_idf, W,
                                                words, vec);
  } else if (N > 0) {
    bow_words_only_kernel<<<(N + 1023) / 1024, 1024, 0, st>>>(valid, key, N, words);
  }
  return static_cast<int>(cudaGetLastError());
}
