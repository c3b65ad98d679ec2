// K9 distinct_presence: which values of a BSI field occur among the
// (filtered) columns of a shard batch, as a presence bitmap over the
// value domain [0, 2^depth).
//
// Replaces pilosa_tpu/ops/bsi.py bsi_distinct_presence (XLA: per shard,
// every column's value reassembled from unpacked plane bits and scattered
// into a 2^depth bool vector, shards OR-reduced in a fori_loop). Eager
// PyTorch needs an unpack per plane and a boolean-mask index, which
// waits for the host.
//
// Bound: the larger of bytes (the not-null plane and the filter read
// whole, a plane word only where its column word holds a considered
// column, 2^depth output bits) and operations (a bit extract and an OR per
// plane per considered column): operations on ssb's 6-bit field, whose
// columns are all set.
//
// Design: a thread owns one word of one shard. It loads not-null & filter
// and skips the word when that is 0; otherwise it loads the depth plane
// words once into registers and, for each set bit, assembles the value
// and marks it. Marking is where threads collide (a 6-bit field puts tens
// of millions of columns on 64 values), so the mark goes to the nearest
// place that fits the domain:
//   depth <= 6   a per-thread 64-bit mask, ORed across the warp
//                (__reduce_or_sync on each half), one shared atomic per
//                warp and one global atomic per non-zero word per block;
//   depth <= 20  a presence bitmap in shared memory (up to 128 KiB),
//                then each block ORs its non-zero words into the output;
//   depth <= 24  global atomicOr on the output.
// The plane loop is unrolled to a compile-time bound per route (6, 12, 20
// or 24 planes) and stops at the field's depth, so a shallow field does
// not pay for the deepest one. The output is ORed into zeros (the wrapper
// allocates it zeroed). An OR gives the same bits in any order.

#include "common.cuh"

#define DP_MAX_DEPTH 24
#define DP_REGISTER_DEPTH 6
#define DP_SHARED_DEPTH 20

constexpr int kThreads = 256;

enum { kRegister = 0, kShared = 1, kGlobal = 2 };

template <int MODE, int MAXD>
__global__ void __launch_bounds__(kThreads)
distinct_presence_kernel(const unsigned* __restrict__ planes, long long plane_stride,
                         long long shard_stride, const unsigned* __restrict__ filt,
                         long long filt_stride, long long w, long long n, int depth,
                         unsigned* __restrict__ out, int nwords) {
  extern __shared__ unsigned pres[];
  __shared__ unsigned block_mask[2];
  if (MODE == kShared) {
    for (int i = threadIdx.x; i < nwords; i += kThreads) pres[i] = 0u;
    __syncthreads();
  }
  unsigned long long mask = 0ull;
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x; t < n;
       t += (long long)gridDim.x * kThreads) {
    const long long s = t / w;
    const long long j = t - s * w;
    const unsigned* base = planes + s * shard_stride + j;
    unsigned ex = __ldcs(base + (long long)depth * plane_stride);
    if (filt != nullptr) ex &= __ldcs(filt + s * filt_stride + j);
    if (ex == 0u) continue;
    unsigned pw[MAXD];
#pragma unroll
    for (int i = 0; i < MAXD; ++i)
      pw[i] = i < depth ? __ldcs(base + (long long)i * plane_stride) : 0u;
    while (ex) {
      const int p = __ffs(ex) - 1;
      ex &= ex - 1u;
      unsigned v = 0u;
#pragma unroll
      for (int i = 0; i < MAXD; ++i) {
        if (i >= depth) break;
        v |= ((pw[i] >> p) & 1u) << i;
      }
      if (MODE == kRegister) {
        mask |= 1ull << v;
      } else if (MODE == kShared) {
        atomicOr(&pres[v >> 5], 1u << (v & 31));
      } else {
        atomicOr(&out[v >> 5], 1u << (v & 31));
      }
    }
  }
  if (MODE == kRegister) {
    if (threadIdx.x < 2) block_mask[threadIdx.x] = 0u;
    __syncthreads();
    const unsigned lo = __reduce_or_sync(0xffffffffu, (unsigned)mask);
    const unsigned hi = __reduce_or_sync(0xffffffffu, (unsigned)(mask >> 32));
    if ((threadIdx.x & 31) == 0) {
      if (lo) atomicOr(&block_mask[0], lo);
      if (hi) atomicOr(&block_mask[1], hi);
    }
    __syncthreads();
    if (threadIdx.x < nwords && block_mask[threadIdx.x]) atomicOr(&out[threadIdx.x], block_mask[threadIdx.x]);
  } else if (MODE == kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < nwords; i += kThreads) {
      const unsigned m = pres[i];
      if (m) atomicOr(&out[i], m);
    }
  }
}

// planes: device int32 [s, depth+1, w] viewed through plane_stride and
// shard_stride (in words; the word axis dense); filt: device int32 [s, w]
// through filt_stride, or null; out: device int32 [nwords], zeroed, nwords
// = max(ceil(2^depth / 32), 1). Returns cudaGetLastError(), or
// cudaErrorInvalidValue past the limits.
extern "C" int pilosa_distinct_presence(const void* planes, long long plane_stride,
                                        long long shard_stride, const void* filt,
                                        long long filt_stride, long long s, long long w, int depth,
                                        void* out, int nwords, int device, void* stream) {
  if (depth < 0 || depth > DP_MAX_DEPTH || s < 1 || w < 1 ||
      nwords != (depth <= 5 ? 1 : (1 << (depth - 5))))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const long long n = s * w;
  const long long need = (n + kThreads - 1) / kThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned* p = static_cast<const unsigned*>(planes);
  const unsigned* f = static_cast<const unsigned*>(filt);
  unsigned* o = static_cast<unsigned*>(out);
  long long blocks;
  if (depth <= DP_REGISTER_DEPTH) {
    blocks = need < (long long)sms * 8 ? need : (long long)sms * 8;
    distinct_presence_kernel<kRegister, DP_REGISTER_DEPTH><<<(unsigned)blocks, kThreads, 0, st>>>(
        p, plane_stride, shard_stride, f, filt_stride, w, n, depth, o, nwords);
  } else if (depth <= DP_SHARED_DEPTH) {
    const int smem = nwords * 4;
    auto kernel = depth <= 12 ? distinct_presence_kernel<kShared, 12>
                              : distinct_presence_kernel<kShared, DP_SHARED_DEPTH>;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    // as many blocks an SM as the bitmaps allow (228 KiB a SM, 1 KiB of
    // it reserved a block), at most 8
    long long per_sm = (228 * 1024) / (smem + 1024 + 8);
    if (per_sm > 8) per_sm = 8;
    if (per_sm < 1) per_sm = 1;
    blocks = need < (long long)sms * per_sm ? need : (long long)sms * per_sm;
    kernel<<<(unsigned)blocks, kThreads, smem, st>>>(p, plane_stride, shard_stride, f, filt_stride, w,
                                                     n, depth, o, nwords);
  } else {
    blocks = need < (long long)sms * 8 ? need : (long long)sms * 8;
    distinct_presence_kernel<kGlobal, DP_MAX_DEPTH><<<(unsigned)blocks, kThreads, 0, st>>>(
        p, plane_stride, shard_stride, f, filt_stride, w, n, depth, o, nwords);
  }
  return (int)cudaGetLastError();
}
