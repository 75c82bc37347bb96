// Kernel Y': the majority-vote centre update of binary k-means (vocabulary
// training), two launches.
//
// Replaces orbslam2_tpu/ops/bow.py: train_vocabulary_jax's _update
// (:147-156), which scatter-adds the unpacked float32 bits of every
// descriptor into (W+1, 256) sums and (W+1,) counts by its word, then sets
// each bit of a word's centre to sums / max(counts, 1) > 0.5, an empty word
// keeping its old centre (the numpy train_vocabulary at :70 does the same in
// float64).
//
// Bound on the H100: the bytes. Per call the packed descriptors (N x 32
// bytes) and their words (N x 4) are read once, the counts (W x 4) and the
// per-bit sums (W x 256 x 4) written, the old centres read and the new ones
// written (W x 32 each); at N ~ 444k, W = 65536 that is ~97 MB, against a
// few integer operations a bit.
// Design. Counts and sums are integers added by atomicAdd, so their order
// does not matter and every run gives the same result. Launch 1
// (accumulate): one warp a descriptor, one lane a byte, so a warp reads its
// descriptor's 32 bytes at once; a lane adds 1 to the sum of each of its 8
// bits that is set (bit k of byte j is bit 8j + k, LSB-first, the order in
// which ops/orb.py packs and kernel Y reads), and lane 0 adds 1 to the
// word's count. A word outside [0, W) adds nothing. Launch 2 (vote): one
// thread a (word, byte) writes the byte of the new packed centre, bit k set
// where 2 * sum > count. That is the reference's float32 rule exactly while
// count < 2^23 (sum / count then rounds above 0.5 only when it is), and at
// 2 * sum == count both give 0. A word with count 0 keeps its old byte.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void vocab_accumulate_kernel(const uint8_t* __restrict__ desc,
                                        const int* __restrict__ words, int N,
                                        int W, int* __restrict__ counts,
                                        int* __restrict__ sums) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long i = t >> 5;
  const int j = static_cast<int>(t & 31);
  if (i >= N) return;
  const int w = words[i];
  if (w < 0 || w >= W) return;
  const unsigned byte = desc[32 * i + j];
  int* s = sums + 256ll * w + 8 * j;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if ((byte >> k) & 1u) atomicAdd(s + k, 1);
  }
  if (j == 0) atomicAdd(counts + w, 1);
}

__global__ void vocab_vote_kernel(const int* __restrict__ counts,
                                  const int* __restrict__ sums,
                                  const uint8_t* __restrict__ old_centres, int W,
                                  uint8_t* __restrict__ centres) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= 32ll * W) return;
  const long long w = t >> 5;
  const int j = static_cast<int>(t & 31);
  const long long c = counts[w];
  if (c == 0) {
    centres[t] = old_centres[t];
    return;
  }
  const int* s = sums + 256ll * w + 8 * j;
  unsigned byte = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (2ll * s[k] > c) byte |= 1u << k;
  }
  centres[t] = static_cast<uint8_t>(byte);
}

}  // namespace

OSL_EXPORT int osl_vocab_update(const uint8_t* desc, const int* words, int N,
                                const uint8_t* old_centres, int W, int* counts,
                                int* sums, uint8_t* centres, void* stream) {
  if (W <= 0 || N < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * W, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(sums, 0, sizeof(int) * 256ll * W, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (N > 0) {
    const long long threads = 32ll * N;
    vocab_accumulate_kernel<<<static_cast<unsigned>((threads + kThreads - 1) / kThreads),
                              kThreads, 0, st>>>(desc, words, N, W, counts, sums);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long threads = 32ll * W;
  vocab_vote_kernel<<<static_cast<unsigned>((threads + kThreads - 1) / kThreads),
                      kThreads, 0, st>>>(counts, sums, old_centres, W, centres);
  return static_cast<int>(cudaGetLastError());
}
