// K8 bsi_minmax: the BSI Min or Max recurrence of every shard of a staged
// [S, D+1, W] plane stack in one launch -> bits u8[S, D] (bit i of each
// shard's extreme value) and count i32[S] (the columns holding it).
//
// Replaces pilosa_tpu/ops/bsi.py bsi_min / bsi_max (:47 / :66), which the
// JAX executor jits once per shard: one XLA program walks the planes from
// high to low, popcounting each step. Eager PyTorch made that a popcount
// launch, a memset and a few elementwise launches per plane step: about
// 7,000 launches for one Min over 58 shards.
//
// Bound: bytes. The not-null plane and the filter are needed whole, and a
// step's plane only in the 32-byte sectors where that shard's candidates
// (``consider``) lie; one test per considered word a step and a popcount
// per word for the count. The recurrence is a chain of steps, each of
// which needs the whole shard's answer before the next, so a launch is
// a handful of passes bound by its barriers' latency more than by bytes.
//
// Design: one thread-block cluster of 8 CTAs per shard (portable size,
// launched with cudaLaunchKernelEx and a cluster dimension); CTA r owns
// words [r W/8, (r+1) W/8) of its shard, thread t of it 16-byte vectors
// j * threads + t of that slice. With P' the plane and Q' the next one
// below it (each complemented for Min, so the recurrence keeps the columns
// in P' when any is there), a step decides two bits from three flags over
// the considered columns x:
//   A = any(x & P'), B = any(x & P' & Q'), C = any(x & ~P' & Q');
// the high bit keeps P' iff A, then the low bit keeps Q' iff (A ? B : C),
// and x narrows to x & (P' or ~P') & (Q' or ~Q') as chosen. The branch
// needs only whether a set is empty, not its count, so a step's exchange
// is an OR of 3 flag bits: a warp vote, one shared atomic a warp, one
// cluster barrier, and one distributed-shared-memory read a lane (the
// cluster's 8 flag words, triple-buffered by step so none is cleared while
// read). An odd depth ends with one single-bit step (Q' all ones). The
// final ``consider`` is counted once, at the end.
//
// What is no longer considered is skipped: ``consider`` only shrinks, so
// each thread keeps a live bit per vector, and a dead vector costs no
// plane load and no test; adjacent threads own adjacent vectors, so a
// warp reads only the live 32-byte sectors. Two routes hold ``consider``:
//   registers  (W <= 32768, 8 vectors a thread of 128) x in registers;
//              the next step's two planes are fetched for every live
//              vector by cp.async into shared memory before the barrier
//              (as K10 does), so no register holds a load across it, and
//              the step's planes stay in registers to narrow x after the
//              branch. 128 threads keep the 58 clusters of ssb resident
//              at once (four CTAs an SM, at most 128 registers a thread);
//   shared     (wider shards, up to BSI_MINMAX_MAX_WORDS) x in shared
//              memory, the planes loaded as each step needs them and
//              again, from L2, to narrow x after the branch.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int kCluster = 8;
constexpr int kRegThreads = 128;
constexpr int kRegVec = 8;  // vectors a thread holds on the register route
constexpr int kRegMaxVectors = kRegThreads * kRegVec;  // a CTA's slice: W <= 32768
constexpr int kSmemThreads = 256;
constexpr int kSmemMaxVec = 32;  // the live bits of a thread on the shared route
constexpr int kDynBudget = 200 * 1024;
constexpr int kSlots = 3;  // flag words, by step
#define BM_MAX_DEPTH 63

struct MmParams {
  const uint4* planes;
  long long plane_stride;  // in 16-byte vectors
  long long shard_stride;
  const uint4* filt;  // null: no filter
  long long filt_stride;
  unsigned char* bits;
  int32_t* count;
  int depth;
  int is_min;
  int sv;  // vectors of a CTA's slice
};

__device__ __forceinline__ uint4 and4(const uint4 a, const uint4 b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}

__device__ __forceinline__ uint4 xor4(const uint4 a, unsigned m) {
  return make_uint4(a.x ^ m, a.y ^ m, a.z ^ m, a.w ^ m);
}

__device__ __forceinline__ bool any4(const uint4 a) { return (a.x | a.y | a.z | a.w) != 0u; }

__device__ __forceinline__ uint4 ones4() { return make_uint4(~0u, ~0u, ~0u, ~0u); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;" ::: "memory"); }

// A step's flags of one vector: bit 0 A, bit 1 B, bit 2 C (above).
__device__ __forceinline__ unsigned flags4(const uint4 x, const uint4 pp, const uint4 qq) {
  const uint4 a = and4(x, pp);
  const uint4 c = make_uint4(x.x & ~pp.x & qq.x, x.y & ~pp.y & qq.y, x.z & ~pp.z & qq.z,
                             x.w & ~pp.w & qq.w);
  return (unsigned)any4(a) | (unsigned)any4(and4(a, qq)) << 1 | (unsigned)any4(c) << 2;
}

// x & (P' ^ mp) & (Q' ^ mq): x narrowed to the sides the branch chose
// (a mask of 0 keeps P', ~0 its complement)
__device__ __forceinline__ uint4 narrow4(const uint4 x, const uint4 pp, const uint4 qq, unsigned mp,
                                         unsigned mq) {
  return and4(x, and4(xor4(pp, mp), xor4(qq, mq)));
}

// A plane as the recurrence keeps it: complemented for Min.
__device__ __forceinline__ uint4 primed(const uint4 p, unsigned flip) { return xor4(p, flip); }

// The OR over the cluster of every thread's ``f``, in every thread of
// every CTA: a warp vote, one shared atomic a warp into this step's word,
// the cluster barrier, then lane r reads rank r's word. The caller clears
// the word two steps ahead (after this barrier, before the next).
__device__ __forceinline__ unsigned cluster_or(cg::cluster_group& cluster, unsigned f,
                                               unsigned* word) {
  f = __reduce_or_sync(0xffffffffu, f);
  const int lane = threadIdx.x & 31;
  if (lane == 0 && f) atomicOr(word, f);
  cluster.sync();
  const unsigned g = lane < kCluster ? *cluster.map_shared_rank(word, lane) : 0u;
  return __reduce_or_sync(0xffffffffu, g);
}

// The step's branch from the cluster's flags: the two bits of the value
// (the low one only where lo >= 0) written by one thread, and the masks
// that narrow x.
__device__ __forceinline__ void branch(unsigned g, const MmParams& p, long long shard, int hi,
                                       int lo, bool writer, unsigned& mp, unsigned& mq) {
  const unsigned keep_p = g & 1u;
  const unsigned keep_q = keep_p ? (g >> 1 & 1u) : (g >> 2 & 1u);
  mp = keep_p ? 0u : ~0u;
  mq = keep_q ? 0u : ~0u;
  if (writer) {
    // Min keeps the columns with the bit clear (P' = ~plane) when any is
    p.bits[shard * p.depth + hi] = (unsigned char)(p.is_min ? !keep_p : keep_p);
    if (lo >= 0) p.bits[shard * p.depth + lo] = (unsigned char)(p.is_min ? !keep_q : keep_q);
  }
}

// The cluster's total of every thread's ``c``, written by rank 0; then no
// CTA exits while another may still read its word.
__device__ __forceinline__ void write_count(cg::cluster_group& cluster, unsigned c, unsigned* word,
                                            int rank, int32_t* out) {
  c = warp_sum(c);
  if ((threadIdx.x & 31) == 0 && c) atomicAdd(word, c);
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    unsigned total = 0;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) total += *cluster.map_shared_rank(word, r);
    *out = (int32_t)total;
  }
  cluster.sync();
}

template <bool kReg>
__global__ void __launch_bounds__(kReg ? kRegThreads : kSmemThreads, kReg ? 4 : 1)
bsi_minmax_kernel(const MmParams p) {
  constexpr int kThreads = kReg ? kRegThreads : kSmemThreads;
  extern __shared__ __align__(16) uint4 dyn[];
  __shared__ unsigned s_flags[kSlots];
  __shared__ unsigned s_count;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const long long shard = blockIdx.x / kCluster;
  const int t = threadIdx.x;
  const long long ps = p.plane_stride;
  const uint4* base = p.planes + shard * p.shard_stride + (long long)rank * p.sv;
  const uint4* fbase = p.filt ? p.filt + shard * p.filt_stride + (long long)rank * p.sv : nullptr;
  const unsigned flip = p.is_min ? ~0u : 0u;
  const bool writer = rank == 0 && t == 0;
  if (t < kSlots) s_flags[t] = 0u;
  if (t == 0) s_count = 0u;
  cluster.sync();  // every CTA has started and cleared its words

  unsigned live = 0u;
  unsigned c = 0u;
  if constexpr (kReg) {
    uint4* pb = dyn;  // the next step's planes, [sv] each
    uint4* qb = dyn + p.sv;
    uint4 x[kRegVec], pr[kRegVec], qr[kRegVec];
#pragma unroll
    for (int j = 0; j < kRegVec; ++j) {
      const int idx = j * kThreads + t;
      x[j] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < p.sv) {
        x[j] = __ldg(base + (long long)p.depth * ps + idx);
        if (fbase) x[j] = and4(x[j], __ldg(fbase + idx));
        if (any4(x[j])) {
          live |= 1u << j;
          if (p.depth >= 1) cp_async16(pb + idx, base + (long long)(p.depth - 1) * ps + idx);
          if (p.depth >= 2) cp_async16(qb + idx, base + (long long)(p.depth - 2) * ps + idx);
        }
      }
    }
    cp_async_commit();
    for (int hi = p.depth - 1, step = 0; hi >= 0; hi -= 2, ++step) {
      const int lo = hi - 1;  // -1: a single-bit step
      cp_async_wait_all();
      unsigned f = 0u;
#pragma unroll
      for (int j = 0; j < kRegVec; ++j) {
        if (live >> j & 1u) {
          const int idx = j * kThreads + t;
          pr[j] = primed(pb[idx], flip);
          qr[j] = lo >= 0 ? primed(qb[idx], flip) : ones4();
          f |= flags4(x[j], pr[j], qr[j]);
          if (lo >= 1) cp_async16(pb + idx, base + (long long)(lo - 1) * ps + idx);
          if (lo >= 2) cp_async16(qb + idx, base + (long long)(lo - 2) * ps + idx);
        }
      }
      cp_async_commit();
      const unsigned g = cluster_or(cluster, f, &s_flags[step % kSlots]);
      if (t == 0) s_flags[(step + 2) % kSlots] = 0u;
      unsigned mp, mq;
      branch(g, p, shard, hi, lo, writer, mp, mq);
#pragma unroll
      for (int j = 0; j < kRegVec; ++j) {
        if (live >> j & 1u) {
          x[j] = narrow4(x[j], pr[j], qr[j], mp, mq);
          if (!any4(x[j])) live &= ~(1u << j);
        }
      }
    }
    cp_async_wait_all();
#pragma unroll
    for (int j = 0; j < kRegVec; ++j)
      if (live >> j & 1u) c += popc4(x[j]);
  } else {
    uint4* xs = dyn;  // [sv]
    const int vpt = (p.sv + kThreads - 1) / kThreads;
    for (int j = 0; j < vpt; ++j) {
      const int idx = j * kThreads + t;
      if (idx < p.sv) {
        uint4 x = __ldg(base + (long long)p.depth * ps + idx);
        if (fbase) x = and4(x, __ldg(fbase + idx));
        xs[idx] = x;
        if (any4(x)) live |= 1u << j;
      }
    }
    for (int hi = p.depth - 1, step = 0; hi >= 0; hi -= 2, ++step) {
      const int lo = hi - 1;
      unsigned f = 0u;
      for (int j = 0; j < vpt; ++j) {
        if (live >> j & 1u) {
          const int idx = j * kThreads + t;
          const uint4 pp = primed(__ldg(base + (long long)hi * ps + idx), flip);
          const uint4 qq = lo >= 0 ? primed(__ldg(base + (long long)lo * ps + idx), flip) : ones4();
          f |= flags4(xs[idx], pp, qq);
        }
      }
      const unsigned g = cluster_or(cluster, f, &s_flags[step % kSlots]);
      if (t == 0) s_flags[(step + 2) % kSlots] = 0u;
      unsigned mp, mq;
      branch(g, p, shard, hi, lo, writer, mp, mq);
      for (int j = 0; j < vpt; ++j) {
        if (live >> j & 1u) {
          const int idx = j * kThreads + t;
          const uint4 pp = primed(__ldg(base + (long long)hi * ps + idx), flip);
          const uint4 qq = lo >= 0 ? primed(__ldg(base + (long long)lo * ps + idx), flip) : ones4();
          const uint4 x = narrow4(xs[idx], pp, qq, mp, mq);
          xs[idx] = x;
          if (!any4(x)) live &= ~(1u << j);
        }
      }
    }
    for (int j = 0; j < vpt; ++j)
      if (live >> j & 1u) c += popc4(xs[j * kThreads + t]);
  }
  write_count(cluster, c, &s_count, rank, p.count + shard);
}

static bool g_attr[64];

// planes: device int32 [S, depth+1, W] with the given plane and shard
// strides in 16-byte vectors (16-byte aligned); filt: device int32 shard
// rows at filt_stride vectors apart, or null; sv = W / 32 (vectors of one
// CTA's slice): the register route up to 1024, else the shared route
// (16 bytes a vector, at most 32 a thread); bits: device u8[S, depth];
// count: device i32[S]. Returns the launch's error, or
// cudaErrorInvalidValue past the limits.
extern "C" int pilosa_bsi_minmax(const void* planes, long long plane_stride,
                                 long long shard_stride, const void* filt, long long filt_stride,
                                 int s, int depth, long long sv, int is_min, void* bits,
                                 void* count, int device, void* stream) {
  if (s < 1 || depth < 0 || depth > BM_MAX_DEPTH || sv < 1 || sv * 16 > kDynBudget ||
      sv > (long long)kSmemMaxVec * kSmemThreads || device < 0 || device >= 64)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (!g_attr[device]) {
    e = cudaFuncSetAttribute(bsi_minmax_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDynBudget);
    if (e != cudaSuccess) return (int)e;
    g_attr[device] = true;
  }
  const bool reg = sv <= kRegMaxVectors;
  MmParams prm;
  prm.planes = static_cast<const uint4*>(planes);
  prm.plane_stride = plane_stride;
  prm.shard_stride = shard_stride;
  prm.filt = static_cast<const uint4*>(filt);
  prm.filt_stride = filt_stride;
  prm.bits = static_cast<unsigned char*>(bits);
  prm.count = static_cast<int32_t*>(count);
  prm.depth = depth;
  prm.is_min = is_min;
  prm.sv = (int)sv;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)s * kCluster, 1, 1);
  cfg.blockDim = dim3(reg ? kRegThreads : kSmemThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)(reg ? 2 : 1) * sv * 16;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = reg ? cudaLaunchKernelEx(&cfg, bsi_minmax_kernel<true>, prm)
          : cudaLaunchKernelEx(&cfg, bsi_minmax_kernel<false>, prm);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
