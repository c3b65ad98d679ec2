// K6 expand_blocks: compressed roaring payloads -> packed words on the device.
//
// Replaces pilosa_tpu/ops/pallas_kernels.py expand_runs_pallas (RLE runs
// only, a Pallas kernel) and its XLA twin pilosa_tpu/ops/packed.py
// expand_blocks (array positions, runs and bitmap containers), which the
// tiered stager calls for a compressed upload. Inputs, all int32 views of
// the u32 coordinates of one flat bit space:
//   positions   global bit offsets of array-container bits; 0xFFFFFFFF
//               (or any offset past the words) is padding and is dropped;
//   starts/ends inclusive global endpoints of RLE runs; start > end
//               (unsigned) is padding;
//   dense       [D, 2048] bitmap-container words at word offsets dense_word;
//               a word outside [0, num_words) is dropped.
// Every input is ORed into the zeroed output. On roaring-valid inputs
// (disjoint containers, disjoint runs) this equals the XLA twin's .add.
//
// Bound: bytes. The output (num_words words, 16 MiB for a 128-row chunk) is
// written once and every input read once; the work is the memset.
//
// Design: the Pallas kernel loops over every run for every word tile, which
// is O(words x runs). Here each input scatters itself instead: the output is
// zeroed with cudaMemsetAsync, then one launch whose blocks take, in order,
// one dense container each (atomicOr of its non-zero words), 256 positions
// each (one atomicOr per bit), and 8 runs each, a warp per run: lane 0 ORs
// the head and tail masks, the lanes store the interior words as all ones
// (an all-ones store absorbs any OR, so its order against the atomics does
// not matter). A run of a 2^16-bit container spans up to 2048 words.

#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kContainerWords = 2048;

__global__ void __launch_bounds__(kThreads)
expand_blocks_kernel(const unsigned* __restrict__ positions, long long np,
                     const unsigned* __restrict__ starts, const unsigned* __restrict__ ends,
                     long long nr, const unsigned* __restrict__ dense,
                     const int* __restrict__ dense_word, long long nd,
                     unsigned* __restrict__ out, long long num_words, long long pos_blocks) {
  long long b = blockIdx.x;
  if (b < nd) {
    const long long base = dense_word[b];
    const unsigned* src = dense + b * kContainerWords;
    for (int j = threadIdx.x; j < kContainerWords; j += kThreads) {
      const long long w = base + j;
      const unsigned v = src[j];
      if (v != 0u && w >= 0 && w < num_words) atomicOr(out + w, v);
    }
    return;
  }
  b -= nd;
  if (b < pos_blocks) {
    const long long i = b * kThreads + threadIdx.x;
    if (i < np) {
      const unsigned p = positions[i];
      const long long w = (long long)(p >> 5);
      if (w < num_words) atomicOr(out + w, 1u << (p & 31u));
    }
    return;
  }
  b -= pos_blocks;
  const long long r = b * kWarps + (threadIdx.x >> 5);
  if (r >= nr) return;
  const unsigned s = starts[r];
  const unsigned e = ends[r];
  if (s > e) return;
  const long long ws = (long long)(s >> 5);
  const long long we = (long long)(e >> 5);
  // shifts stay below 32: (31 - eb) and sb are in [0, 31]
  const unsigned head = ~0u << (s & 31u);
  const unsigned tail = ~0u >> (31u - (e & 31u));
  const unsigned lane = threadIdx.x & 31u;
  if (lane == 0) {
    if (ws == we) {
      if (ws < num_words) atomicOr(out + ws, head & tail);
    } else {
      if (ws < num_words) atomicOr(out + ws, head);
      if (we < num_words) atomicOr(out + we, tail);
    }
  }
  const long long hi = we < num_words ? we : num_words;
  for (long long w = ws + 1 + lane; w < hi; w += 32) out[w] = ~0u;
}

// positions [np], starts/ends [nr], dense [nd, 2048], dense_word [nd], out
// [num_words]: device int32. Zeroes out, then expands. Returns
// cudaGetLastError().
extern "C" int pilosa_expand_blocks(const void* positions, long long np, const void* starts,
                                    const void* ends, long long nr, const void* dense,
                                    const void* dense_word, long long nd, void* out,
                                    long long num_words, int device, void* stream) {
  if (np < 0 || nr < 0 || nd < 0 || num_words < 0 || num_words >= (1LL << 27))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = cudaMemsetAsync(out, 0, (size_t)num_words * 4, st);
  if (e != cudaSuccess) return (int)e;
  const long long pos_blocks = (np + kThreads - 1) / kThreads;
  const long long run_blocks = (nr + kWarps - 1) / kWarps;
  const long long blocks = nd + pos_blocks + run_blocks;
  if (blocks == 0 || num_words == 0) return (int)cudaGetLastError();
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  expand_blocks_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const unsigned*>(positions), np, static_cast<const unsigned*>(starts),
      static_cast<const unsigned*>(ends), nr, static_cast<const unsigned*>(dense),
      static_cast<const int*>(dense_word), nd, static_cast<unsigned*>(out), num_words,
      pos_blocks);
  return (int)cudaGetLastError();
}
