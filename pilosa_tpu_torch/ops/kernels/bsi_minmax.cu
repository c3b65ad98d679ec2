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
// Bound: bytes. Every plane, the not-null plane and the filter are read
// once: (D + 1 + filter) x S x W x 4 bytes.
//
// Design: one thread-block cluster of 8 CTAs per shard (portable size,
// launched with cudaLaunchKernelEx and a cluster dimension). CTA r owns
// words [r W/8, (r+1) W/8) of its shard. Its slice of ``consider`` (not-null
// & filter, then narrowed step by step) lives in shared memory for the
// whole recurrence and never reaches HBM. Planes stream in high to low
// through a 2-stage ring filled by cp.async.bulk (thread 0) and an
// mbarrier per stage. Each step
//   x = consider & ~plane (Min) or consider & plane (Max), popcount it;
//   reduce the block (shuffles), then the cluster: each CTA publishes its
//     count in shared memory, cluster.sync(), and every CTA sums the eight
//     through distributed shared memory (map_shared_rank; the slot is
//     double-buffered by step parity, so one cluster barrier a step does);
//   every CTA sees the same total, so all take the same branch:
//     consider = total ? x : consider, in place; rank 0 records the bit.
// The last reduction counts the final ``consider``.

#include <cooperative_groups.h>

#include "common.cuh"
#include "tma.cuh"

namespace cg = cooperative_groups;

constexpr int kCluster = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDynBudget = 200 * 1024;
#define BM_MAX_DEPTH 63

__device__ __forceinline__ uint4 mm_step(const uint4 c, const uint4 p, int is_min) {
  if (is_min) return make_uint4(c.x & ~p.x, c.y & ~p.y, c.z & ~p.z, c.w & ~p.w);
  return make_uint4(c.x & p.x, c.y & p.y, c.z & p.z, c.w & p.w);
}

// The cluster-wide sum of every thread's ``c``; every thread of every CTA
// of the cluster gets it. ``part`` is this step's publication slot.
__device__ __forceinline__ unsigned cluster_total(cg::cluster_group& cluster, unsigned c,
                                                  unsigned* s_warp, unsigned* part) {
  c = warp_sum(c);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned t = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) t += s_warp[k];
    *part = t;
  }
  cluster.sync();
  unsigned total = 0;
#pragma unroll
  for (int r = 0; r < kCluster; ++r) total += *cluster.map_shared_rank(part, r);
  return total;
}

__global__ void __launch_bounds__(kThreads)
bsi_minmax_kernel(const uint4* __restrict__ planes, long long plane_stride,
                  long long shard_stride, const uint4* __restrict__ filt, long long filt_stride,
                  int depth, int is_min, int sv, unsigned char* __restrict__ bits,
                  int32_t* __restrict__ count) {
  extern __shared__ __align__(16) uint4 dyn[];
  __shared__ __align__(8) uint64_t bar[3];  // two plane stages, the prologue
  __shared__ unsigned s_warp[kWarps];
  __shared__ unsigned s_part[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const long long shard = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  uint4* consider = dyn;
  uint4* stage = dyn + sv;  // stage k at stage + k * sv
  const uint4* base = planes + shard * shard_stride + (long long)rank * sv;
  const unsigned bytes = (unsigned)sv * 16u;

  if (tid == 0) {
    for (int k = 0; k < 3; ++k) mbar_init(&bar[k], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar[2], filt ? 2 * bytes : bytes);
    bulk_g2s(consider, base + depth * plane_stride, bytes, &bar[2]);
    if (filt) bulk_g2s(stage, filt + shard * filt_stride + (long long)rank * sv, bytes, &bar[2]);
  }
  mbar_wait(&bar[2], 0);
  if (filt) {
    for (int v = tid; v < sv; v += kThreads) {
      const uint4 a = consider[v], f = stage[v];
      consider[v] = make_uint4(a.x & f.x, a.y & f.y, a.z & f.z, a.w & f.w);
    }
  }
  __syncthreads();  // stage 0 is free again
  if (tid == 0) {
    for (int k = 0; k < 2 && k < depth; ++k) {
      mbar_expect_tx(&bar[k], bytes);
      bulk_g2s(stage + k * sv, base + (depth - 1 - k) * plane_stride, bytes, &bar[k]);
    }
  }

  for (int k = 0; k < depth; ++k) {
    const int st = k & 1;
    mbar_wait(&bar[st], (unsigned)(k >> 1) & 1u);
    const uint4* pl = stage + st * sv;
    unsigned c = 0;
    for (int v = tid; v < sv; v += kThreads) c += popc4(mm_step(consider[v], pl[v], is_min));
    const unsigned total = cluster_total(cluster, c, s_warp, &s_part[k & 1]);
    if (total)
      for (int v = tid; v < sv; v += kThreads) consider[v] = mm_step(consider[v], pl[v], is_min);
    if (rank == 0 && tid == 0)
      bits[shard * depth + (depth - 1 - k)] = (unsigned char)(is_min ? total == 0 : total != 0);
    __syncthreads();  // the stage is free again
    if (tid == 0 && k + 2 < depth) {
      mbar_expect_tx(&bar[st], bytes);
      bulk_g2s(stage + st * sv, base + (depth - 3 - k) * plane_stride, bytes, &bar[st]);
    }
  }

  unsigned c = 0;
  for (int v = tid; v < sv; v += kThreads) c += popc4(consider[v]);
  const unsigned total = cluster_total(cluster, c, s_warp, &s_part[depth & 1]);
  if (rank == 0 && tid == 0) count[shard] = (int32_t)total;
  cluster.sync();  // no CTA exits while another may still read its slot
}

static bool g_attr[64];

// planes: device int32 [S, depth+1, W] with the given plane and shard
// strides in 16-byte vectors (16-byte aligned); filt: device int32 shard
// rows at filt_stride vectors apart, or null; sv = W / 32 (vectors of one
// CTA's slice); bits: device u8[S, depth]; count: device i32[S]. Returns
// the launch's error, or cudaErrorInvalidValue past the limits.
extern "C" int pilosa_bsi_minmax(const void* planes, long long plane_stride,
                                 long long shard_stride, const void* filt, long long filt_stride,
                                 int s, int depth, long long sv, int is_min, void* bits,
                                 void* count, int device, void* stream) {
  if (s < 1 || depth < 0 || depth > BM_MAX_DEPTH || sv < 1 || 3 * sv * 16 > kDynBudget ||
      device < 0 || device >= 64)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (!g_attr[device]) {
    e = cudaFuncSetAttribute(bsi_minmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDynBudget);
    if (e != cudaSuccess) return (int)e;
    g_attr[device] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)s * kCluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)(3 * sv * 16);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, bsi_minmax_kernel, static_cast<const uint4*>(planes), plane_stride,
                         shard_stride, static_cast<const uint4*>(filt), filt_stride, depth, is_min,
                         (int)sv, static_cast<unsigned char*>(bits), static_cast<int32_t*>(count));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
