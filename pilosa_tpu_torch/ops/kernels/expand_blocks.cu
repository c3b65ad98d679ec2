// K6 expand_blocks: compressed roaring payloads -> packed words on the device.
//
// Replaces pilosa_tpu/ops/pallas_kernels.py expand_runs_pallas (RLE runs
// only, a Pallas kernel) and its XLA twin pilosa_tpu/ops/packed.py
// expand_blocks (array positions, runs and bitmap containers), which the
// tiered stager calls for a compressed upload. Inputs, all int32 views of
// the u32 coordinates of one flat bit space, binned by span (a span is one
// 2^16-bit container: 2048 output words, 8 KiB):
//   positions   global bit offsets of array-container bits;
//   starts/ends inclusive global endpoints of RLE runs, each run inside one
//               span;
//   dense       [D, 2048] bitmap-container words at word offsets dense_word,
//               each the first word of its span;
//   offsets     [3, spans + 1]: span c's positions, runs and dense blocks are
//               [offsets[k][c], offsets[k][c + 1]) of their arrays (k = 0, 1,
//               2), non-decreasing in c.
// Every input is ORed into zeros. An element that does not lie in the span
// its offsets give it (padding among them) is dropped, so wrong offsets give
// wrong words but never an access out of bounds. ops/packed.py
// bin_expand_inputs bins the contract's unbinned inputs (any order, runs and
// dense blocks at any offset); the stager ships the offsets of its payloads,
// which roaring already keeps in span order.
//
// Bound: bytes. The output (16 MiB for a 128-row chunk) is written once and
// every input read once; the work is the stores.
//
// Design: one CTA owns one span, so every output word has one writer and
// the output needs no memset and no global atomics. A span without input
// stores zeros; a span that is one whole bitmap container copies it straight
// through. Any other span is built in shared memory (zeroed, dense words ORed
// in, then shared-memory atomicOr for positions and runs, a warp per run)
// and stored once. Every global store is a 16-byte vector, consecutive
// threads on consecutive addresses. The work per span is small, so the
// time is the stores and one round trip for the offsets: the design keeps
// every CTA of a launch resident at once.

#include "common.cuh"

// 64 threads: up to 27 CTAs (8 KiB of shared memory each) fit on an SM, so
// the 2048 spans of a 128-row chunk run as one wave (kernel_ab_probe.py on
// an H100: 256 threads, two waves, 0.0117 ms; 128 or 64 threads 0.0105).
constexpr int kThreads = 64;
constexpr int kWarps = kThreads / 32;
constexpr int kSpanWords = 2048;
constexpr int kSpanVecs = kSpanWords / 4;

// [lo, hi) of span c in an array of n elements, clamped into [0, n].
__device__ __forceinline__ void span_range(const int* __restrict__ off, long long c, long long n,
                                           long long& lo, long long& hi) {
  lo = off[c];
  hi = off[c + 1];
  lo = lo < 0 ? 0 : (lo > n ? n : lo);
  hi = hi < lo ? lo : (hi > n ? n : hi);
}

__global__ void __launch_bounds__(kThreads)
expand_blocks_kernel(const unsigned* __restrict__ positions, long long np,
                     const unsigned* __restrict__ starts, const unsigned* __restrict__ ends,
                     long long nr, const uint4* __restrict__ dense,
                     const int* __restrict__ dense_word, long long nd,
                     const int* __restrict__ offsets, long long spans,
                     unsigned* __restrict__ out, long long num_words) {
  __shared__ __align__(16) unsigned acc[kSpanWords];
  uint4* acc4 = reinterpret_cast<uint4*>(acc);
  const long long c = blockIdx.x;
  const long long base = c * kSpanWords;
  const int nw = (int)(num_words - base < kSpanWords ? num_words - base : kSpanWords);
  long long p0, p1, r0, r1, d0, d1;
  span_range(offsets, c, np, p0, p1);
  span_range(offsets + (spans + 1), c, nr, r0, r1);
  span_range(offsets + 2 * (spans + 1), c, nd, d0, d1);
  uint4* out4 = reinterpret_cast<uint4*>(out + base);

  if (p0 == p1 && r0 == r1 && d1 - d0 <= 1 && nw == kSpanWords) {
    // zeros, or one bitmap container straight through
    if (d1 > d0 && dense_word[d0] == base) {
      const uint4* src = dense + d0 * kSpanVecs;
      for (int v = threadIdx.x; v < kSpanVecs; v += kThreads) out4[v] = src[v];
    } else {
      for (int v = threadIdx.x; v < kSpanVecs; v += kThreads) out4[v] = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  for (int v = threadIdx.x; v < kSpanVecs; v += kThreads) acc4[v] = make_uint4(0u, 0u, 0u, 0u);
  // dense blocks: each thread ORs the same vectors of every block, so no
  // two threads touch one word before the barrier
  for (long long b = d0; b < d1; ++b) {
    if (dense_word[b] != base) continue;
    const uint4* src = dense + b * kSpanVecs;
    for (int v = threadIdx.x; v < kSpanVecs; v += kThreads) {
      const uint4 x = src[v];
      uint4 a = acc4[v];
      a.x |= x.x;
      a.y |= x.y;
      a.z |= x.z;
      a.w |= x.w;
      acc4[v] = a;
    }
  }
  __syncthreads();
  for (long long i = p0 + threadIdx.x; i < p1; i += kThreads) {
    const unsigned p = positions[i];
    const int w = (int)(p >> 5) - (int)(c << 11);
    if ((long long)(p >> 16) == c && w < nw) atomicOr(acc + w, 1u << (p & 31u));
  }
  const int lane = threadIdx.x & 31;
  for (long long r = r0 + (threadIdx.x >> 5); r < r1; r += kWarps) {
    const unsigned s = starts[r];
    const unsigned e = ends[r];
    if (s > e || (long long)(s >> 16) != c || (long long)(e >> 16) != c) continue;
    const int ws = (int)(s >> 5) - (int)(c << 11);
    const int we = (int)(e >> 5) - (int)(c << 11);
    // shifts stay below 32: (s & 31) and 31 - (e & 31) are in [0, 31]
    const unsigned head = ~0u << (s & 31u);
    const unsigned tail = ~0u >> (31u - (e & 31u));
    const int hi = we < nw ? we : nw - 1;
    for (int w = ws + lane; w <= hi; w += 32) {
      unsigned m = ~0u;
      if (w == ws) m &= head;
      if (w == we) m &= tail;
      atomicOr(acc + w, m);
    }
  }
  __syncthreads();
  if (nw == kSpanWords) {
    for (int v = threadIdx.x; v < kSpanVecs; v += kThreads) out4[v] = acc4[v];
  } else {
    // the last span of an output that is not a whole number of containers
    for (int j = threadIdx.x; j < nw; j += kThreads) out[base + j] = acc[j];
  }
}

// positions [np], starts/ends [nr], dense [nd, 2048] (16-byte aligned),
// dense_word [nd], offsets [3, spans + 1] with spans = ceil(num_words /
// 2048), out [num_words] (16-byte aligned): device int32. Writes every word
// of out. Returns cudaGetLastError().
extern "C" int pilosa_expand_blocks(const void* positions, long long np, const void* starts,
                                    const void* ends, long long nr, const void* dense,
                                    const void* dense_word, long long nd, const void* offsets,
                                    void* out, long long num_words, int device, void* stream) {
  if (np < 0 || nr < 0 || nd < 0 || num_words < 0 || num_words >= (1LL << 27))
    return (int)cudaErrorInvalidValue;
  if (num_words == 0) return (int)cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long spans = (num_words + kSpanWords - 1) / kSpanWords;
  expand_blocks_kernel<<<(unsigned)spans, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(positions), np, static_cast<const unsigned*>(starts),
      static_cast<const unsigned*>(ends), nr, static_cast<const uint4*>(dense),
      static_cast<const int*>(dense_word), nd, static_cast<const int*>(offsets), spans,
      static_cast<unsigned*>(out), num_words);
  return (int)cudaGetLastError();
}
