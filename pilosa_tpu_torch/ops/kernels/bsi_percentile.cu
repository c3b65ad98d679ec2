// K10 bsi_percentile: the nearest-rank Percentile of a BSI field over a
// staged [S, D+1, W] plane stack, as one bit-sliced search in one launch
// -> bits u8[D] (bit i of the k-th smallest considered value) and count
// i32 (the considered columns; 0 means no value).
//
// Replaces pilosa_tpu/ops/bsi.py bsi_percentile_batched (:222), one XLA
// program: consider = not-null & filter, k = ceil(nth * count / 10000)
// clamped to [1, max(count, 1)], then for each plane i from high to low
// zeros = consider & ~plane_i, c = popcount(zeros) over every shard; if
// k <= c bit i is clear and consider = zeros, else bit i is set,
// consider &= plane_i and k -= c. Eager PyTorch made each step a tree-count
// launch and about eight elementwise launches (1.9 ms at ssb's largest
// call, 3 % of the bytes bound).
//
// Bound: bytes. The not-null plane and the filter are needed whole, and
// a step's plane only in the 32-byte sectors where that step's consider
// is set (this kernel still loads every plane word); one popcount per
// word for the count and one per considered word a step.
//
// Design: each step's branch needs a count over every shard, which no
// cluster can hold (58 shards on ssb), so the search is one persistent
// grid launched with cudaLaunchCooperativeKernel (every CTA resident) and
// sized to the card's occupancy (queried once per device). CTA b owns
// a fixed slice of the S x W words (ceil(S W / grid) of them, crossing
// shard boundaries); thread t of it owns words j * 1024 + t of the slice.
// A step:
//   read the thread's plane words (already in registers), zeros = c & ~p,
//     keep both c & p and zeros, popcount zeros, and issue the loads of
//     the next plane's words into the registers just freed, so the bytes
//     stream while the grid waits;
//   reduce the block (shuffles) and add (1 << 48) + its sum into the
//     step's u64 word in global memory: one relaxed atomic is both the
//     count and the arrival, so the grid barrier is a spin until the top
//     16 bits reach the grid size, and no fence waits for the plane loads
//     in flight (cooperative groups' grid.sync() is not used, so no
//     relocatable device code);
//   every CTA reads the same total and takes the same branch: consider
//     becomes whichever of the two sets it kept (a pointer swap, no pass
//     over the words); CTA 0 writes the bit.
// Two routes hold ``consider``:
//   on chip  both sets in shared memory (192 KiB a CTA: 6 16-byte vectors
//            a thread), the plane words in registers; ssb's [58, 25,
//            32768] uses 3.5 vectors a thread on 132 CTAs;
//   global   past that, both sets in a [2, S W] scratch in device memory,
//            each word read and written once a step by its own thread.
// k, the counts and the total are 64-bit (the reference sums in i32), the
// total below 2^48 bits. The entry point zeroes the step words with an
// async memset before the launch.

#include <atomic>

#include "common.cuh"

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 6;  // 16-byte vectors a thread holds on the on-chip route
constexpr int kOnChipSmem = 2 * kVec * kThreads * 16;
#define BP_MAX_DEPTH 63

static_assert(kWarps == 32, "the block reduction sums one warp's worth of warp sums");

struct PctParams {
  const uint4* planes;
  long long plane_stride;  // in 16-byte vectors
  long long shard_stride;
  const uint4* filt;       // null: no filter
  long long filt_stride;
  long long wv;            // vectors per shard
  long long nv;            // S x wv
  long long per_cta;       // vectors a CTA owns
  uint4* state;            // global route: [2, nv]
  unsigned long long* counters;  // [depth + 1] step words: arrivals << 48 | sum
  unsigned char* bits;
  int32_t* count;
  int depth;
  int nth;
  int vpt;                 // vectors a thread owns: ceil(per_cta / kThreads)
};

__device__ __forceinline__ uint4 and4(const uint4 a, const uint4 b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}

__device__ __forceinline__ uint4 andnot4(const uint4 a, const uint4 b) {
  return make_uint4(a.x & ~b.x, a.y & ~b.y, a.z & ~b.z, a.w & ~b.w);
}

__device__ __forceinline__ unsigned long long warp_sum64(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

constexpr int kArrivalShift = 48;

__device__ __forceinline__ void red_relaxed_gpu(unsigned long long* p, unsigned long long v) {
  asm volatile("red.relaxed.gpu.global.add.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ld_relaxed_gpu(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// The grid-wide sum of every thread's ``c`` in the step word ``slot``;
// returns it to every thread of every CTA once every CTA has added its
// part. Nothing but the word itself crosses CTAs, so relaxed atomics do.
__device__ __forceinline__ unsigned long long grid_sum(unsigned long long c,
                                                       unsigned long long* slot,
                                                       unsigned long long* s_warp,
                                                       unsigned long long* s_total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  c = warp_sum64(c);
  if (lane == 0) s_warp[warp] = c;
  __syncthreads();
  if (warp == 0) {
    const unsigned long long v = warp_sum64(s_warp[lane]);
    if (lane == 0) {
      red_relaxed_gpu(slot, (1ull << kArrivalShift) + v);
      unsigned long long seen;
      do {
        seen = ld_relaxed_gpu(slot);
      } while ((seen >> kArrivalShift) < gridDim.x);
      *s_total = seen & ((1ull << kArrivalShift) - 1);
    }
  }
  __syncthreads();
  return *s_total;
}

template <bool kOnChip>
__global__ void __launch_bounds__(kThreads, 1) bsi_percentile_kernel(const PctParams p) {
  extern __shared__ uint4 dyn[];
  __shared__ unsigned long long s_warp[kWarps];
  __shared__ unsigned long long s_total;
  const int t = threadIdx.x;
  const long long start = (long long)blockIdx.x * p.per_cta;
  const long long end = start + p.per_cta < p.nv ? start + p.per_cta : p.nv;
  const long long mine = end - start;  // <= 0 on a tail CTA, which only counts 0s
  uint4* cur;
  uint4* alt;
  if (kOnChip) {
    cur = dyn;
    alt = dyn + (long long)p.vpt * kThreads;
  } else {
    cur = p.state + start;
    alt = p.state + p.nv + start;
  }

  // consider = not-null & filter; the first step's plane words in flight
  unsigned long long c = 0;
  unsigned off[kVec];
  uint4 nxt[kVec];
  if (kOnChip) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const long long idx = (long long)j * kThreads + t;
      off[j] = 0;
      nxt[j] = make_uint4(0, 0, 0, 0);
      if (j < p.vpt && idx < mine) {
        const long long v = start + idx;
        const long long sh = v / p.wv;
        const long long w = v - sh * p.wv;
        off[j] = (unsigned)(sh * p.shard_stride + w);
        uint4 x = __ldg(p.planes + off[j] + (long long)p.depth * p.plane_stride);
        if (p.filt) x = and4(x, __ldg(p.filt + sh * p.filt_stride + w));
        cur[idx] = x;
        c += popc4(x);
        if (p.depth > 0) nxt[j] = __ldg(p.planes + off[j] + (long long)(p.depth - 1) * p.plane_stride);
      }
    }
  } else {
    for (long long idx = t; idx < mine; idx += kThreads) {
      const long long v = start + idx;
      const long long sh = v / p.wv;
      const long long w = v - sh * p.wv;
      uint4 x = __ldg(p.planes + sh * p.shard_stride + w + (long long)p.depth * p.plane_stride);
      if (p.filt) x = and4(x, __ldg(p.filt + sh * p.filt_stride + w));
      cur[idx] = x;
      c += popc4(x);
    }
  }
  const unsigned long long count = grid_sum(c, p.counters + p.depth, s_warp, &s_total);
  const unsigned long long nth = (unsigned long long)p.nth;
  unsigned long long k = nth * (count / 10000) + (nth * (count % 10000) + 9999) / 10000;
  const unsigned long long top = count > 0 ? count : 1;
  k = k < 1 ? 1 : (k > top ? top : k);

  for (int i = p.depth - 1; i >= 0; --i) {
    c = 0;
    if (kOnChip) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const long long idx = (long long)j * kThreads + t;
        if (j < p.vpt && idx < mine) {
          const uint4 pl = nxt[j];
          const uint4 x = cur[idx];
          const uint4 z = andnot4(x, pl);
          cur[idx] = and4(x, pl);
          alt[idx] = z;
          c += popc4(z);
          if (i > 0) nxt[j] = __ldg(p.planes + off[j] + (long long)(i - 1) * p.plane_stride);
        }
      }
    } else {
      for (long long idx = t; idx < mine; idx += kThreads) {
        const long long v = start + idx;
        const long long sh = v / p.wv;
        const long long w = v - sh * p.wv;
        const uint4 pl = __ldg(p.planes + sh * p.shard_stride + w + (long long)i * p.plane_stride);
        const uint4 x = cur[idx];
        const uint4 z = andnot4(x, pl);
        cur[idx] = and4(x, pl);
        alt[idx] = z;
        c += popc4(z);
      }
    }
    const unsigned long long zeros = grid_sum(c, p.counters + i, s_warp, &s_total);
    const bool clear = k <= zeros;
    if (clear) {
      uint4* tmp = cur;
      cur = alt;
      alt = tmp;
    } else {
      k -= zeros;
    }
    if (blockIdx.x == 0 && t == 0) p.bits[i] = clear ? 0 : 1;
  }
  if (blockIdx.x == 0 && t == 0) *p.count = (int32_t)(unsigned)count;
}

// CTAs of the cooperative grid per device, 0 until prepare() has run
// there; callers on several threads may race to fill it with one value.
static std::atomic<int> g_grid[64];

// Sets the on-chip kernel's shared-memory limit and sizes the grid: CTAs
// an SM holds for both routes at once, times the SMs. Returns the grid
// size through ``grid``.
static cudaError_t prepare(int device, int* grid) {
  *grid = g_grid[device].load(std::memory_order_acquire);
  if (*grid > 0) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(bsi_percentile_kernel<true>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kOnChipSmem);
  if (e != cudaSuccess) return e;
  int on_chip = 0, global = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&on_chip, bsi_percentile_kernel<true>,
                                                    kThreads, kOnChipSmem);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&global, bsi_percentile_kernel<false>,
                                                    kThreads, 0);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const int per_sm = on_chip < global ? on_chip : global;
  // the arrivals of a step word count to the grid size in its top 16 bits
  if (per_sm < 1 || per_sm * sms >= (1 << (64 - kArrivalShift))) return cudaErrorInvalidConfiguration;
  *grid = per_sm * sms;
  g_grid[device].store(*grid, std::memory_order_release);
  return cudaSuccess;
}

// The cooperative grid on ``device`` (CTAs) and the 16-byte vectors of
// ``consider`` the on-chip route holds (grid x 1024 threads x 6).
extern "C" int pilosa_bsi_percentile_grid(int device, int* grid, long long* on_chip_vectors) {
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = prepare(device, grid);
  if (e != cudaSuccess) return (int)e;
  *on_chip_vectors = (long long)*grid * kThreads * kVec;
  return 0;
}

// planes: device int32 [S, depth+1, W] with plane and shard strides in
// 16-byte vectors (16-byte aligned; plane offsets below 2^32 vectors on
// the on-chip route); filt: [S, W] rows filt_stride vectors apart, or
// null; wv = W / 4, nv = S x wv; state: device [2, nv] vectors on the
// global route (ignored on chip); counters: device u64[depth + 1], zeroed
// here; bits: device u8[depth]; count: device i32[1]; S x W x 32 < 2^48.
// Returns the launch's error, or cudaErrorInvalidValue past the limits.
extern "C" int pilosa_bsi_percentile(const void* planes, long long plane_stride,
                                     long long shard_stride, const void* filt,
                                     long long filt_stride, long long wv, long long nv, int depth,
                                     int nth, int on_chip, void* state, void* counters,
                                     void* bits, void* count, int device, void* stream) {
  if (depth < 0 || depth > BP_MAX_DEPTH || nth < 0 || nth > 10000 || wv < 1 || nv < wv ||
      nv % wv || nv >= (1ll << (kArrivalShift - 7)) || device < 0 || device >= 64 ||
      (!on_chip && state == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  int grid = 0;
  e = prepare(device, &grid);
  if (e != cudaSuccess) return (int)e;
  PctParams prm;
  prm.planes = static_cast<const uint4*>(planes);
  prm.plane_stride = plane_stride;
  prm.shard_stride = shard_stride;
  prm.filt = static_cast<const uint4*>(filt);
  prm.filt_stride = filt_stride;
  prm.wv = wv;
  prm.nv = nv;
  prm.per_cta = (nv + grid - 1) / grid;
  prm.state = static_cast<uint4*>(state);
  prm.counters = static_cast<unsigned long long*>(counters);
  prm.bits = static_cast<unsigned char*>(bits);
  prm.count = static_cast<int32_t*>(count);
  prm.depth = depth;
  prm.nth = nth;
  const long long vpt = (prm.per_cta + kThreads - 1) / kThreads;
  if (on_chip && vpt > kVec) return (int)cudaErrorInvalidValue;
  prm.vpt = (int)(vpt < kVec ? vpt : kVec);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = cudaMemsetAsync(counters, 0, (size_t)(depth + 1) * 8, st);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&prm};
  const void* fn = on_chip ? reinterpret_cast<const void*>(&bsi_percentile_kernel<true>)
                           : reinterpret_cast<const void*>(&bsi_percentile_kernel<false>);
  const size_t smem = on_chip ? (size_t)2 * prm.vpt * kThreads * 16 : 0;
  e = cudaLaunchCooperativeKernel(fn, dim3((unsigned)grid), dim3(kThreads), args, smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
