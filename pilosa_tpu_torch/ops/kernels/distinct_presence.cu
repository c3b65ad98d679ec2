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
// column, 2^depth output bits) and operations (on the register route,
// 2^(depth+1) - 2 logical operations per considered word): bytes on ssb's
// fields.
//
// Design. Depth <= 6 (every ssb Distinct), the register route: a thread
// owns a 16-byte vector of one shard (one word where the strides are not
// 16-byte multiples) at a time. It loads not-null & filter and skips the
// vector when that is 0; otherwise it loads the depth plane vectors and
// splits each word bit-sliced: from the highest plane down, each node (a
// mask of the word's columns whose high bits spell a value prefix) becomes
// node & plane and node & ~plane, so after depth levels node v holds the
// columns whose value is v, and is ORed into the thread's accumulator
// acc[v]. That is 2^(depth+1) - 2 AND/ANDN/OR operations per word (126 at
// depth 6; the last level's AND folds into the OR as one LOP3), against
// about 30 per column for extracting each set column's value bit by bit.
// The depth is a template parameter (0-6), so every index into acc is
// fixed at compile time and acc stays in registers. After the thread's
// last word, bit v of its mask is acc[v] != 0; the warp ORs the masks
// (__reduce_or_sync on each half), one shared atomic per warp, one global
// atomic per non-zero word per block.
//   depth <= 20  a thread owns one word; for each set bit it assembles the
//                value and marks a presence bitmap in shared memory (up to
//                128 KiB), then each block ORs its non-zero words into the
//                output;
//   depth <= 24  the same, marking the output with global atomicOr.
// Those loops are unrolled to a compile-time bound per route (12, 20 or
// 24 planes) and stop at the field's depth. The output is ORed into zeros
// (the wrapper allocates it zeroed). An OR gives the same bits in any
// order.

#include <atomic>

#include "common.cuh"

#define DP_MAX_DEPTH 24
#define DP_REGISTER_DEPTH 6
#define DP_SHARED_DEPTH 20

constexpr int kThreads = 256;

enum { kShared = 1, kGlobal = 2 };

// The bit-sliced split of one word's considered columns ``node`` over
// planes L-1 .. 0 (``pw``), depth first: leaf V (the value the splits
// spell, high bit first) is ORed into acc[V].
template <int L, int V, int D>
struct Split {
  static __device__ __forceinline__ void run(unsigned node, const unsigned* pw,
                                             unsigned (&acc)[1 << D]) {
    Split<L - 1, 2 * V + 1, D>::run(node & pw[L - 1], pw, acc);
    Split<L - 1, 2 * V, D>::run(node & ~pw[L - 1], pw, acc);
  }
};

template <int V, int D>
struct Split<0, V, D> {
  static __device__ __forceinline__ void run(unsigned node, const unsigned*, unsigned (&acc)[1 << D]) {
    acc[V] |= node;
  }
};

template <int VEC>
__device__ __forceinline__ void load_words(unsigned (&dst)[VEC], const unsigned* src) {
  if constexpr (VEC == 4) {
    const uint4 v = __ldcs(reinterpret_cast<const uint4*>(src));
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  } else {
    dst[0] = __ldcs(src);
  }
}

// The register route: depth D <= 6, VEC words a thread at a time (4 where
// every stride is a multiple of 4 words and the pointers 16-byte aligned).
// Strides in words; ``wu`` units of VEC words a shard, ``n`` units in all.
template <int D, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
distinct_register_kernel(const unsigned* __restrict__ planes, long long plane_stride,
                         long long shard_stride, const unsigned* __restrict__ filt,
                         long long filt_stride, long long wu, long long n,
                         unsigned* __restrict__ out) {
  constexpr int kValues = 1 << D;
  constexpr int kPlanes = D > 0 ? D : 1;
  __shared__ unsigned block_mask[2];
  unsigned acc[kValues];
#pragma unroll
  for (int v = 0; v < kValues; ++v) acc[v] = 0u;
  for (long long u = (long long)blockIdx.x * kThreads + threadIdx.x; u < n;
       u += (long long)gridDim.x * kThreads) {
    const long long s = u / wu;
    const long long j = (u - s * wu) * VEC;
    const unsigned* base = planes + s * shard_stride + j;
    unsigned ex[VEC];
    load_words<VEC>(ex, base + (long long)D * plane_stride);
    if (filt != nullptr) {
      unsigned f[VEC];
      load_words<VEC>(f, filt + s * filt_stride + j);
#pragma unroll
      for (int e = 0; e < VEC; ++e) ex[e] &= f[e];
    }
    unsigned any = 0u;
#pragma unroll
    for (int e = 0; e < VEC; ++e) any |= ex[e];
    if (any == 0u) continue;
    unsigned pw[kPlanes][VEC];
#pragma unroll
    for (int i = 0; i < D; ++i) load_words<VEC>(pw[i], base + (long long)i * plane_stride);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      unsigned pl[kPlanes];
#pragma unroll
      for (int i = 0; i < kPlanes; ++i) pl[i] = i < D ? pw[i][e] : 0u;
      Split<D, 0, D>::run(ex[e], pl, acc);
    }
  }
  unsigned lo = 0u, hi = 0u;
#pragma unroll
  for (int v = 0; v < kValues; ++v) {
    const unsigned seen = (acc[v] != 0u ? 1u : 0u) << (v & 31);
    if (v < 32) {
      lo |= seen;
    } else {
      hi |= seen;
    }
  }
  if (threadIdx.x < 2) block_mask[threadIdx.x] = 0u;
  __syncthreads();
  lo = __reduce_or_sync(0xffffffffu, lo);
  hi = __reduce_or_sync(0xffffffffu, hi);
  if ((threadIdx.x & 31) == 0) {
    if (lo) atomicOr(&block_mask[0], lo);
    if (hi) atomicOr(&block_mask[1], hi);
  }
  __syncthreads();
  constexpr int kWords = D <= 5 ? 1 : 2;
  if (threadIdx.x < kWords && block_mask[threadIdx.x]) atomicOr(&out[threadIdx.x], block_mask[threadIdx.x]);
}

template <int MODE, int MAXD>
__global__ void __launch_bounds__(kThreads)
distinct_presence_kernel(const unsigned* __restrict__ planes, long long plane_stride,
                         long long shard_stride, const unsigned* __restrict__ filt,
                         long long filt_stride, long long w, long long n, int depth,
                         unsigned* __restrict__ out, int nwords) {
  extern __shared__ unsigned pres[];
  if (MODE == kShared) {
    for (int i = threadIdx.x; i < nwords; i += kThreads) pres[i] = 0u;
    __syncthreads();
  }
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
      if (MODE == kShared) {
        atomicOr(&pres[v >> 5], 1u << (v & 31));
      } else {
        atomicOr(&out[v >> 5], 1u << (v & 31));
      }
    }
  }
  if (MODE == kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < nwords; i += kThreads) {
      const unsigned m = pres[i];
      if (m) atomicOr(&out[i], m);
    }
  }
}

// Blocks an SM holds of each register-route kernel (by depth and vector
// width) per device, 0 until first asked; racing callers store one value.
static std::atomic<int> g_per_sm[64][DP_REGISTER_DEPTH + 1][2];
// whether a shared-route instance's dynamic shared memory limit is raised
// on a device: [depth <= 12][device]
static std::atomic<bool> g_shared_ready[2][64];

template <int D, int VEC>
static cudaError_t launch_register(const unsigned* p, long long plane_stride, long long shard_stride,
                                   const unsigned* f, long long filt_stride, long long s,
                                   long long w, unsigned* o, int device, int sms,
                                   cudaStream_t st) {
  auto kernel = distinct_register_kernel<D, VEC>;
  std::atomic<int>& cached = g_per_sm[device][D][VEC == 4];
  int per_sm = cached.load(std::memory_order_relaxed);
  if (per_sm == 0) {
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) per_sm = 1;
    cached.store(per_sm, std::memory_order_relaxed);
  }
  const long long wu = w / VEC;
  const long long n = s * wu;
  const long long need = (n + kThreads - 1) / kThreads;
  const long long full = (long long)sms * per_sm;
  const long long blocks = need < full ? need : full;
  kernel<<<(unsigned)blocks, kThreads, 0, st>>>(p, plane_stride, shard_stride, f, filt_stride, wu, n, o);
  return cudaGetLastError();
}

template <int VEC>
static cudaError_t dispatch_register(int depth, const unsigned* p, long long plane_stride,
                                     long long shard_stride, const unsigned* f,
                                     long long filt_stride, long long s, long long w, unsigned* o,
                                     int device, int sms, cudaStream_t st) {
  switch (depth) {
#define DP_CASE(D)                                                                            \
  case D:                                                                                     \
    return launch_register<D, VEC>(p, plane_stride, shard_stride, f, filt_stride, s, w, o, \
                                   device, sms, st);
    DP_CASE(0)
    DP_CASE(1)
    DP_CASE(2)
    DP_CASE(3)
    DP_CASE(4)
    DP_CASE(5)
    DP_CASE(6)
#undef DP_CASE
  }
  return cudaErrorInvalidValue;
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
  if (depth < 0 || depth > DP_MAX_DEPTH || s < 1 || w < 1 || device < 0 || device >= 64 ||
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
  if (depth <= DP_REGISTER_DEPTH) {
    const bool vec = w % 4 == 0 && plane_stride % 4 == 0 && shard_stride % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
                     (f == nullptr || (filt_stride % 4 == 0 && reinterpret_cast<uintptr_t>(f) % 16 == 0));
    e = vec ? dispatch_register<4>(depth, p, plane_stride, shard_stride, f, filt_stride, s, w, o, device, sms, st)
            : dispatch_register<1>(depth, p, plane_stride, shard_stride, f, filt_stride, s, w, o, device, sms, st);
    return (int)e;
  }
  long long blocks;
  if (depth <= DP_SHARED_DEPTH) {
    const int smem = nwords * 4;
    const bool low = depth <= 12;
    auto kernel = low ? distinct_presence_kernel<kShared, 12>
                      : distinct_presence_kernel<kShared, DP_SHARED_DEPTH>;
    // the instance's limit is raised once a device to the most any of its
    // launches asks for (the bitmap at its deepest depth): set to this
    // launch's size, a concurrent launch could lower it before another's
    // launch, which would then fail
    if (!g_shared_ready[low][device].load(std::memory_order_acquire)) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               4 << ((low ? 12 : DP_SHARED_DEPTH) - 5));
      if (e != cudaSuccess) return (int)e;
      g_shared_ready[low][device].store(true, std::memory_order_release);
    }
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
