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
// is set; one popcount per word for the count and one per considered word
// a step.
//
// Design: each step's branch needs a count over every shard, which no
// cluster can hold (58 shards on ssb), so the search is one persistent
// grid launched with cudaLaunchCooperativeKernel (every CTA resident) and
// sized to the card's occupancy (queried once per device). CTA b owns
// a fixed slice of the S x W words (ceil(S W / grid) of them, crossing
// shard boundaries); thread t of it owns 16-byte vectors j * 1024 + t of
// the slice.
//
// Two bits a step: with p = plane i and q = plane i-1, a step counts three
// sets of the considered columns x, c1 = |x & ~p|, c00 = |x & ~p & ~q| and
// c10 = |x & p & ~q|, which decide bits i and i-1 together (c1 against k
// decides bit i; then c00 or c10, whichever side bit i chose, bit i-1). So
// a depth-24 search takes 12 grid-wide barriers, not 24. An odd depth ends
// with one single-bit step, the same code with q all ones. The step keeps
// x, not the four sets it may become: the next step first narrows x to
// x & (p or ~p) & (q or ~q) as the branch chose, from p and q in registers.
//
// A barrier: reduce the block (shuffles), then add (1 << 48) + its sum
// into each of the step's u64 words in global memory (each in a 128-byte
// line of its own) with relaxed atomics: each word is both counts and
// the arrivals, so the barrier is a spin, a load of each word an
// iteration, until the top 16 bits of each reach the grid size, and no
// fence waits for the plane loads in flight (cooperative groups'
// grid.sync() is not used, so no relocatable device code). The three
// counts take one word below 2^16 columns, two below 2^24, else three.
// Every CTA reads the same totals and takes the same branch; CTA 0 writes
// the bits.
//
// What is no longer considered is skipped. ``consider`` only shrinks, so a
// vector that is zero before a step's split stays zero: each thread keeps
// a live bit per vector it owns, and a dead vector costs no plane load, no
// shared or scratch access and no popcount. Adjacent threads own adjacent
// vectors, so a warp's loads shrink to the live 32-byte sectors. The next
// step's planes are fetched before the branch is known, for every vector
// live before it (one step behind what the bound counts).
//
// Two routes hold ``consider``:
//   on chip  x in shared memory, with the next step's two planes, fetched
//            by cp.async into shared memory while the grid waits, so no
//            register holds a load in flight; the current step's two
//            planes in registers (4 16-byte vectors a thread: 208 KiB of
//            shared memory a CTA with the vector offsets; ssb's
//            [58, 25, 32768] uses 3.5 on 132 CTAs);
//   global   past that, x in an [S W] scratch in device memory; a step
//            reads x, the last step's two planes again (to narrow x) and
//            its own two, and writes x once. A thread's live bits cover
//            its first 64 vectors; the rest are always read.
// k, the counts and the totals are 64-bit (the reference sums in i32), the
// totals below 2^48 bits. The entry point zeroes the step words with an
// async memset before the launch.

#include <atomic>

#include "common.cuh"

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;  // 16-byte vectors a thread holds on the on-chip route
// a vector's bytes of shared memory on the on-chip route: x, the next
// step's two planes, and its 32-bit offset
constexpr int kVecSmem = 3 * 16 + 4;
constexpr int kOnChipSmem = kVec * kThreads * kVecSmem;
constexpr int kCounts = 3;       // step words of a step: c1, c00, c10
// u64 slots between two step words: each word in a 128-byte line of its
// own, so the grid's atomics on a step's three words proceed in parallel
constexpr int kCounterStride = 16;
constexpr int kLiveRounds = 64;  // global route: the vectors a thread's live bits cover
#define BP_MAX_DEPTH 63

static_assert(kWarps == 32, "the block reduction sums one warp's worth of warp sums");
static_assert(kVec * 4 <= 32, "four outcome bits a vector in one word");

struct PctParams {
  const uint4* planes;
  long long plane_stride;  // in 16-byte vectors
  long long shard_stride;
  const uint4* filt;       // null: no filter
  long long filt_stride;
  long long wv;            // vectors per shard
  long long nv;            // S x wv
  long long per_cta;       // vectors a CTA owns
  uint4* state;            // global route: x, [nv]
  unsigned long long* counters;  // kCounts words a barrier, kCounterStride apart: arrivals << 48 | sum
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

__device__ __forceinline__ unsigned any4(const uint4 a) {
  return ((a.x | a.y | a.z | a.w) != 0u) ? 1u : 0u;
}

// x & (p ^ mp) & (q ^ mq): x narrowed to the side of p and of q a branch
// chose (a mask of 0 keeps the set bits, ~0 the clear ones)
__device__ __forceinline__ uint4 narrow4(const uint4 x, const uint4 p, const uint4 q, unsigned mp,
                                         unsigned mq) {
  return make_uint4(x.x & (p.x ^ mp) & (q.x ^ mq), x.y & (p.y ^ mp) & (q.y ^ mq),
                    x.z & (p.z ^ mp) & (q.z ^ mq), x.w & (p.w ^ mp) & (q.w ^ mq));
}

__device__ __forceinline__ uint4 ones4() { return make_uint4(~0u, ~0u, ~0u, ~0u); }

__device__ __forceinline__ unsigned long long warp_sum64(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;" ::: "memory"); }

constexpr int kArrivalShift = 48;

__device__ __forceinline__ void red_relaxed_gpu(unsigned long long* p, unsigned long long v) {
  asm volatile("red.relaxed.gpu.global.add.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ld_relaxed_gpu(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// The grid-wide sums of every thread's ``c[m]`` in the step words
// ``slot[m * kCounterStride]``, back into ``c`` in every thread of every
// CTA once every CTA has added its part. Nothing but the words themselves
// crosses CTAs, so relaxed atomics do.
template <int N>
__device__ __forceinline__ void grid_sum(unsigned long long (&c)[N], unsigned long long* slot,
                                         unsigned long long (*s_warp)[kWarps],
                                         unsigned long long* s_total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < N; ++m) {
    c[m] = warp_sum64(c[m]);
    if (lane == 0) s_warp[m][warp] = c[m];
  }
  __syncthreads();
  if (warp == 0) {
    unsigned long long v[N];
#pragma unroll
    for (int m = 0; m < N; ++m) v[m] = warp_sum64(s_warp[m][lane]);
    if (lane == 0) {
#pragma unroll
      for (int m = 0; m < N; ++m) red_relaxed_gpu(slot + m * kCounterStride, (1ull << kArrivalShift) + v[m]);
      bool done;
      do {
        done = true;
#pragma unroll
        for (int m = 0; m < N; ++m) {
          v[m] = ld_relaxed_gpu(slot + m * kCounterStride);
          done = done && (v[m] >> kArrivalShift) >= gridDim.x;
        }
      } while (!done);
#pragma unroll
      for (int m = 0; m < N; ++m) s_total[m] = v[m] & ((1ull << kArrivalShift) - 1);
    }
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < N; ++m) c[m] = s_total[m];
}

// A step's three counts (c1, c00, c10) summed over the grid, back into
// ``t``, in as few step words as the search's count allows (``words``,
// the same in every thread): every field's total is at most the count,
// so below 2^16 columns the three share one word's 48 bits, below 2^24
// two words do (c1 and c00 in the first), else one word each. Each word
// is a barrier's spin, so fewer words make a cheaper barrier.
__device__ __forceinline__ void step_sum(unsigned long long (&t)[kCounts], unsigned long long* slot,
                                         int words, unsigned long long (*s_warp)[kWarps],
                                         unsigned long long* s_total) {
  if (words == 1) {
    unsigned long long v[1] = {t[0] | t[1] << 16 | t[2] << 32};
    grid_sum<1>(v, slot, s_warp, s_total);
    t[0] = v[0] & 0xffffull;
    t[1] = v[0] >> 16 & 0xffffull;
    t[2] = v[0] >> 32 & 0xffffull;
  } else if (words == 2) {
    unsigned long long v[2] = {t[0] | t[1] << 24, t[2]};
    grid_sum<2>(v, slot, s_warp, s_total);
    t[0] = v[0] & 0xffffffull;
    t[1] = v[0] >> 24 & 0xffffffull;
    t[2] = v[1];
  } else {
    grid_sum<kCounts>(t, slot, s_warp, s_total);
  }
}

// The search's branch over one step's totals (c1, c00, c10), the same in
// every thread: updates k, returns the outcome (2 x bit hi + bit lo) and
// the masks that narrow x to it.
__device__ __forceinline__ int branch(unsigned long long& k, const unsigned long long (&tot)[kCounts],
                                      unsigned& mp, unsigned& mq) {
  int hi = 0;
  unsigned long long lo_zeros = tot[1];
  if (k > tot[0]) {
    hi = 1;
    k -= tot[0];
    lo_zeros = tot[2];
  }
  int lo = 0;
  if (k > lo_zeros) {
    lo = 1;
    k -= lo_zeros;
  }
  mp = hi ? 0u : ~0u;
  mq = lo ? 0u : ~0u;
  return 2 * hi + lo;
}

// One vector of a step: counts the three sets of x over p and q into c,
// and returns the outcomes in which the vector stays non-zero (bit o for
// outcome o = 2 x bit hi + bit lo).
__device__ __forceinline__ unsigned split4(const uint4 x, const uint4 p, const uint4 q,
                                           unsigned (&c)[kCounts]) {
  const uint4 a = andnot4(x, p);
  const uint4 b = and4(x, p);
  const uint4 a0 = andnot4(a, q);
  const uint4 b0 = andnot4(b, q);
  c[0] += popc4(a);
  c[1] += popc4(a0);
  c[2] += popc4(b0);
  return any4(a0) | (any4(and4(a, q)) << 1) | (any4(b0) << 2) | (any4(and4(b, q)) << 3);
}

template <bool kOnChip>
__global__ void __launch_bounds__(kThreads, 1) bsi_percentile_kernel(const PctParams p) {
  extern __shared__ uint4 dyn[];
  __shared__ unsigned long long s_warp[kCounts][kWarps];
  __shared__ unsigned long long s_total[kCounts];
  const int t = threadIdx.x;
  const long long start = (long long)blockIdx.x * p.per_cta;
  const long long end = start + p.per_cta < p.nv ? start + p.per_cta : p.nv;
  const long long mine = end - start;  // <= 0 on a tail CTA, which only counts 0s
  const long long ps = p.plane_stride;
  const bool writer = blockIdx.x == 0 && t == 0;
  unsigned long long k = 0;
  unsigned long long count = 0;
  unsigned mp = 0u, mq = 0u;  // the last branch's side of its two planes

  if (kOnChip) {
    const int nvec = p.vpt * kThreads;
    uint4* xs = dyn;
    uint4* pb = dyn + nvec;
    uint4* qb = pb + nvec;
    unsigned* offs = reinterpret_cast<unsigned*>(qb + nvec);
    // consider = not-null & filter; the first step's planes fetched
    unsigned live = 0u;
    uint4 pr[kVec], qr[kVec];  // the current step's planes (all ones before the first)
    {
      unsigned long long c[1] = {0};
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int idx = j * kThreads + t;
        pr[j] = ones4();
        qr[j] = ones4();
        if (j < p.vpt && idx < mine) {
          const long long v = start + idx;
          const long long sh = v / p.wv;
          const long long w = v - sh * p.wv;
          const unsigned off = (unsigned)(sh * p.shard_stride + w);
          offs[idx] = off;
          uint4 x = __ldg(p.planes + off + (long long)p.depth * ps);
          if (p.filt) x = and4(x, __ldg(p.filt + sh * p.filt_stride + w));
          c[0] += popc4(x);
          if (any4(x)) {
            live |= 1u << j;
            xs[idx] = x;
            if (p.depth >= 1) cp_async16(pb + idx, p.planes + off + (long long)(p.depth - 1) * ps);
            if (p.depth >= 2) cp_async16(qb + idx, p.planes + off + (long long)(p.depth - 2) * ps);
          }
        }
      }
      cp_async_commit();
      grid_sum<1>(c, p.counters, s_warp, s_total);
      count = c[0];
    }
    const unsigned long long nth = (unsigned long long)p.nth;
    k = nth * (count / 10000) + (nth * (count % 10000) + 9999) / 10000;
    const unsigned long long top = count > 0 ? count : 1;
    k = k < 1 ? 1 : (k > top ? top : k);
    const int words = count < (1ull << 16) ? 1 : (count < (1ull << 24) ? 2 : kCounts);

    for (int hi = p.depth - 1, step = 1; hi >= 0; hi -= 2, ++step) {
      const int lo = hi - 1;  // -1: a single-bit step
      cp_async_wait_all();
      unsigned c[kCounts] = {0u, 0u, 0u};
      unsigned outcomes = 0u;  // 4 bits a vector
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        if (live >> j & 1u) {
          const int idx = j * kThreads + t;
          const uint4 x = narrow4(xs[idx], pr[j], qr[j], mp, mq);
          pr[j] = pb[idx];
          qr[j] = lo >= 0 ? qb[idx] : ones4();
          xs[idx] = x;
          outcomes |= split4(x, pr[j], qr[j], c) << (4 * j);
          const unsigned off = offs[idx];
          if (lo >= 1) cp_async16(pb + idx, p.planes + off + (long long)(lo - 1) * ps);
          if (lo >= 2) cp_async16(qb + idx, p.planes + off + (long long)(lo - 2) * ps);
        }
      }
      cp_async_commit();
      unsigned long long tot[kCounts] = {c[0], c[1], c[2]};
      step_sum(tot, p.counters + kCounts * kCounterStride * step, words, s_warp, s_total);
      const int o = branch(k, tot, mp, mq);
      unsigned next = 0u;
#pragma unroll
      for (int j = 0; j < kVec; ++j) next |= (outcomes >> (4 * j + o) & 1u) << j;
      live = next;
      if (writer) {
        p.bits[hi] = (unsigned char)(o >> 1);
        if (lo >= 0) p.bits[lo] = (unsigned char)(o & 1);
      }
    }
    cp_async_wait_all();
  } else {
    uint4* xs = p.state + start;
    unsigned long long live = 0ull;  // the thread's first kLiveRounds vectors
    {
      unsigned long long c[1] = {0};
      int r = 0;
      for (long long idx = t; idx < mine; idx += kThreads, ++r) {
        const long long v = start + idx;
        const long long sh = v / p.wv;
        const long long w = v - sh * p.wv;
        uint4 x = __ldg(p.planes + sh * p.shard_stride + w + (long long)p.depth * ps);
        if (p.filt) x = and4(x, __ldg(p.filt + sh * p.filt_stride + w));
        xs[idx] = x;
        c[0] += popc4(x);
        if (r < kLiveRounds && any4(x)) live |= 1ull << r;
      }
      grid_sum<1>(c, p.counters, s_warp, s_total);
      count = c[0];
    }
    const unsigned long long nth = (unsigned long long)p.nth;
    k = nth * (count / 10000) + (nth * (count % 10000) + 9999) / 10000;
    const unsigned long long top = count > 0 ? count : 1;
    k = k < 1 ? 1 : (k > top ? top : k);
    const int words = count < (1ull << 16) ? 1 : (count < (1ull << 24) ? 2 : kCounts);

    int last_hi = -1, last_lo = -1;  // the last step's planes (-1: none)
    for (int hi = p.depth - 1, step = 1; hi >= 0; hi -= 2, ++step) {
      const int lo = hi - 1;
      unsigned long long c[kCounts] = {0ull, 0ull, 0ull};
      unsigned long long out[4] = {0ull, 0ull, 0ull, 0ull};  // live bits by outcome
      int r = 0;
      for (long long idx = t; idx < mine; idx += kThreads, ++r) {
        if (r < kLiveRounds && !(live >> r & 1ull)) continue;
        const long long v = start + idx;
        const long long sh = v / p.wv;
        const uint4* base = p.planes + sh * p.shard_stride + (v - sh * p.wv);
        uint4 x = xs[idx];
        if (last_hi >= 0) {
          const uint4 pp = __ldg(base + (long long)last_hi * ps);
          const uint4 qq = last_lo >= 0 ? __ldg(base + (long long)last_lo * ps) : ones4();
          x = narrow4(x, pp, qq, mp, mq);
          xs[idx] = x;
        }
        const uint4 pl = __ldg(base + (long long)hi * ps);
        const uint4 ql = lo >= 0 ? __ldg(base + (long long)lo * ps) : ones4();
        unsigned cc[kCounts] = {0u, 0u, 0u};
        const unsigned o = split4(x, pl, ql, cc);
#pragma unroll
        for (int m = 0; m < kCounts; ++m) c[m] += cc[m];
        if (r < kLiveRounds) {
#pragma unroll
          for (int m = 0; m < 4; ++m) out[m] |= (unsigned long long)(o >> m & 1u) << r;
        }
      }
      step_sum(c, p.counters + kCounts * kCounterStride * step, words, s_warp, s_total);
      const int o = branch(k, c, mp, mq);
      // no runtime index into out, which would put it in local memory
      live = o == 0 ? out[0] : o == 1 ? out[1] : o == 2 ? out[2] : out[3];
      last_hi = hi;
      last_lo = lo;
      if (writer) {
        p.bits[hi] = (unsigned char)(o >> 1);
        if (lo >= 0) p.bits[lo] = (unsigned char)(o & 1);
      }
    }
  }
  if (writer) *p.count = (int32_t)(unsigned)count;
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
// ``consider`` the on-chip route holds (grid x 1024 threads x 4).
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
// null; wv = W / 4, nv = S x wv; state: device [nv] vectors on the global
// route (ignored on chip); counters: device u64[48 x (1 + (depth + 1) / 2)]
// (three words a barrier, each 16 slots apart), zeroed here; bits: device
// u8[depth]; count: device i32[1]; S x W x 32 < 2^48. Returns the launch's error, or cudaErrorInvalidValue
// past the limits.
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
  e = cudaMemsetAsync(counters, 0, (size_t)kCounts * kCounterStride * (1 + (depth + 1) / 2) * 8, st);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&prm};
  const void* fn = on_chip ? reinterpret_cast<const void*>(&bsi_percentile_kernel<true>)
                           : reinterpret_cast<const void*>(&bsi_percentile_kernel<false>);
  const size_t smem = on_chip ? (size_t)prm.vpt * kThreads * kVecSmem : 0;
  e = cudaLaunchCooperativeKernel(fn, dim3((unsigned)grid), dim3(kThreads), args, smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
