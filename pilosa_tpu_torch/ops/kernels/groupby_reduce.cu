// K4 groupby_reduce: the GroupBy cross product and its segmented popcounts.
//
//   g_k                = filt & dims[0][i0] & dims[1][i1] & ...   (product
//                        order, first dimension slowest)
//   counts[k]          = popcount(g_k)
//   plane_counts[k, p] = popcount(g_k & planes[p])
//
// Replaces pilosa_tpu/ops/pallas_kernels.py groupby_plane_counts_pallas (and
// its jit twins combine_groups / groupby_counts / groupby_plane_counts /
// groupby_sum_reduce in pilosa_tpu/ops/packed.py), fused with its producer:
// the JAX path writes the [K, Wf] group matrix to HBM and re-reads it once
// per plane; here a group's words live only in registers.
//
// Bound: operations. The work is K * Wf * (P + 1) popcounts of 32-bit words
// (16 a clock per SM on compute capability 9.0), against one read of the
// dimension rows, the filter and the planes.
//
// Design: one warp per group and word range; the lanes walk 16-byte vectors
// of the flattened word axis, so every load is coalesced. Each lane keeps its
// counts in registers (one accumulator per plane, PMAX a template bound) over
// its whole range; a warp shuffle reduces them once and lane 0 adds them to
// the outputs with integer atomics (exact in any order). Inputs are read in
// place through their strides: a staged [S, P, W] plane stack needs no
// transpose. Two shapes of block:
//   * K >= 8 (a GroupBy panel): 8 groups, one warp each, share a word
//     range. The block stages each tile of the planes and the filter in
//     shared memory once, and all 8 warps read it from there, so a plane
//     word crosses L2 once per 8 groups instead of once per group; only the
//     dimension rows, which differ per group, are read per warp. Without
//     the staging (the first version of this kernel) the planes were read
//     per warp and the panel took 8x its popcount bound.
//   * K < 8 (Sum: K = 1): there is no reuse to stage, so the warps of a
//     block and the grid's second axis split the word range instead, and
//     132 SMs stay busy.
// The grid's fast axis is the group block, so blocks that share a word range
// run together and share it in L2.

#include "common.cuh"

#define GB_MAX_DIMS 8

struct GbDim {
  const uint4* base;
  long long row_stride;    // vectors between rows
  long long shard_stride;  // vectors between shards
  int rows;
};

struct GbArgs {
  GbDim dims[GB_MAX_DIMS];
  int ndims;
  const uint4* filt;  // null: no filter
  long long filt_shard_stride;
  const uint4* planes;
  long long plane_stride;
  long long plane_shard_stride;
  int nplanes;
  long long wv;          // vectors per shard
  long long nv;          // vectors in all
  long long split_vecs;  // vectors per grid.y split
  int k;
  int groups_per_block;  // warps of a block / warps per group
  int warps_per_group;
  int32_t* counts;
  int32_t* plane_counts;
};

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ uint4 and4(uint4 a, const uint4 b) {
  a.x &= b.x; a.y &= b.y; a.z &= b.z; a.w &= b.w;
  return a;
}

template <int PMAX>
__global__ void __launch_bounds__(kThreads)
groupby_reduce_kernel(const GbArgs a) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long k = (long long)blockIdx.x * a.groups_per_block + warp / a.warps_per_group;
  const int sub = warp % a.warps_per_group;
  if (k >= a.k) return;  // whole warp; the kernel has no block barrier

  // this group's row of each dimension, last dimension fastest
  const uint4* rowp[GB_MAX_DIMS];
  long long rem = k;
#pragma unroll
  for (int d = GB_MAX_DIMS - 1; d >= 0; --d) {
    rowp[d] = nullptr;
    if (d < a.ndims) {
      const int r = (int)(rem % a.dims[d].rows);
      rem /= a.dims[d].rows;
      rowp[d] = a.dims[d].base + (long long)r * a.dims[d].row_stride;
    }
  }

  const long long v_begin = (long long)blockIdx.y * a.split_vecs;
  long long v_end = v_begin + a.split_vecs;
  if (v_end > a.nv) v_end = a.nv;
  const long long step = (long long)a.warps_per_group * 32;
  long long v = v_begin + (long long)sub * 32 + lane;
  long long s = v / a.wv;  // once; then carried incrementally
  long long w = v - s * a.wv;

  unsigned cnt = 0;
  unsigned acc[PMAX > 0 ? PMAX : 1];
#pragma unroll
  for (int p = 0; p < (PMAX > 0 ? PMAX : 1); ++p) acc[p] = 0;

  for (; v < v_end; v += step) {
    uint4 g = a.filt != nullptr ? __ldg(a.filt + s * a.filt_shard_stride + w)
                                : make_uint4(~0u, ~0u, ~0u, ~0u);
#pragma unroll
    for (int d = 0; d < GB_MAX_DIMS; ++d)
      if (d < a.ndims) g = and4(g, __ldg(rowp[d] + s * a.dims[d].shard_stride + w));
    cnt += popc4(g);
    if (PMAX > 0) {
      const uint4* pp = a.planes + s * a.plane_shard_stride + w;
#pragma unroll
      for (int p = 0; p < PMAX; ++p)
        if (p < a.nplanes) acc[p] += popc_and(g, __ldg(pp + p * a.plane_stride));
    }
    w += step;
    while (w >= a.wv) {
      w -= a.wv;
      ++s;
    }
  }

  cnt = warp_sum(cnt);
  if (lane == 0 && cnt != 0) atomicAdd(a.counts + k, (int)cnt);
#pragma unroll
  for (int p = 0; p < PMAX; ++p) {
    if (p < a.nplanes) {
      const unsigned t = warp_sum(acc[p]);
      if (lane == 0 && t != 0) atomicAdd(a.plane_counts + k * a.nplanes + p, (int)t);
    }
  }
}

// Vectors per shared-memory tile of the planes: (P + 1) x TILE x 16 bytes.
template <int PMAX>
struct Tile {
  static constexpr int kVecs = PMAX <= 32 ? 128 : 64;
};

template <int PMAX>
__global__ void __launch_bounds__(kThreads)
groupby_tiled_kernel(const GbArgs a) {
  constexpr int T = Tile<PMAX>::kVecs;
  extern __shared__ uint4 s_tile[];  // [nplanes + 1][T]: planes, then the filter
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long k = (long long)blockIdx.x * kWarps + warp;
  const bool active = k < a.k;  // idle warps still load and synchronise

  const uint4* rowp[GB_MAX_DIMS];
  long long rem = active ? k : 0;
#pragma unroll
  for (int d = GB_MAX_DIMS - 1; d >= 0; --d) {
    rowp[d] = nullptr;
    if (d < a.ndims) {
      const int r = (int)(rem % a.dims[d].rows);
      rem /= a.dims[d].rows;
      rowp[d] = a.dims[d].base + (long long)r * a.dims[d].row_stride;
    }
  }

  long long v = (long long)blockIdx.y * a.split_vecs;
  long long v_end = v + a.split_vecs;
  if (v_end > a.nv) v_end = a.nv;
  long long s = v / a.wv;
  long long w = v - s * a.wv;
  const int np = a.nplanes;
  uint4* s_filt = s_tile + np * T;

  unsigned cnt = 0;
  unsigned acc[PMAX];
#pragma unroll
  for (int p = 0; p < PMAX; ++p) acc[p] = 0;

  while (v < v_end) {
    // a tile never crosses a shard
    long long n = a.wv - w;
    if (n > v_end - v) n = v_end - v;
    if (n > T) n = T;
    const uint4* pbase = a.planes + s * a.plane_shard_stride + w;
    for (int i = threadIdx.x; i < (np + 1) * T; i += kThreads) {
      const int p = i / T;  // T is a power of two
      const int j = i - p * T;
      if (j >= n) continue;
      if (p < np)
        s_tile[i] = __ldg(pbase + (long long)p * a.plane_stride + j);
      else
        s_filt[j] = a.filt != nullptr ? __ldg(a.filt + s * a.filt_shard_stride + w + j)
                                      : make_uint4(~0u, ~0u, ~0u, ~0u);
    }
    __syncthreads();
    if (active) {
      for (int j = lane; j < n; j += 32) {
        uint4 g = s_filt[j];
#pragma unroll
        for (int d = 0; d < GB_MAX_DIMS; ++d)
          if (d < a.ndims) g = and4(g, __ldg(rowp[d] + s * a.dims[d].shard_stride + w + j));
        cnt += popc4(g);
#pragma unroll
        for (int p = 0; p < PMAX; ++p)
          if (p < np) acc[p] += popc_and(g, s_tile[p * T + j]);
      }
    }
    __syncthreads();
    v += n;
    w += n;
    if (w == a.wv) {
      w = 0;
      ++s;
    }
  }

  if (!active) return;
  cnt = warp_sum(cnt);
  if (lane == 0 && cnt != 0) atomicAdd(a.counts + k, (int)cnt);
#pragma unroll
  for (int p = 0; p < PMAX; ++p) {
    if (p < np) {
      const unsigned t = warp_sum(acc[p]);
      if (lane == 0 && t != 0) atomicAdd(a.plane_counts + k * np + p, (int)t);
    }
  }
}

template <int PMAX>
static cudaError_t launch(const GbArgs& a, dim3 grid, cudaStream_t stream) {
  if (a.groups_per_block < kWarps || PMAX == 0) {
    groupby_reduce_kernel<PMAX><<<grid, kThreads, 0, stream>>>(a);
    return cudaGetLastError();
  }
  constexpr int P = PMAX > 0 ? PMAX : 1;
  const size_t smem = (size_t)(a.nplanes + 1) * Tile<P>::kVecs * sizeof(uint4);
  cudaError_t e = cudaFuncSetAttribute(groupby_tiled_kernel<P>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  groupby_tiled_kernel<P><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// dims: host GbDim[ndims] (device row pointers, strides in 16-byte vectors);
// filt: device pointer or null, with its shard stride; planes: device
// pointer or null (nplanes 0), plane and shard strides; s shards of wv
// vectors; counts i32[k] and plane_counts i32[k, nplanes] zeroed by the
// caller. Returns cudaGetLastError(), or cudaErrorInvalidValue past the
// limits.
extern "C" int pilosa_groupby_reduce(const GbDim* dims, int ndims, const void* filt,
                                     long long filt_shard_stride, const void* planes,
                                     long long plane_stride, long long plane_shard_stride,
                                     int nplanes, long long s, long long wv, long long k,
                                     void* counts, void* plane_counts, int device,
                                     void* stream) {
  if (ndims < 0 || ndims > GB_MAX_DIMS || nplanes < 0 || nplanes > 64 || k < 1 ||
      k > 0x7fffffffLL || s < 1 || wv < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;

  GbArgs a = {};
  for (int d = 0; d < ndims; ++d) a.dims[d] = dims[d];
  a.ndims = ndims;
  a.filt = static_cast<const uint4*>(filt);
  a.filt_shard_stride = filt_shard_stride;
  a.planes = static_cast<const uint4*>(planes);
  a.plane_stride = plane_stride;
  a.plane_shard_stride = plane_shard_stride;
  a.nplanes = nplanes;
  a.wv = wv;
  a.nv = s * wv;
  a.k = (int)k;
  a.counts = static_cast<int32_t*>(counts);
  a.plane_counts = static_cast<int32_t*>(plane_counts);

  // groups per block: 8 (one warp each) when K allows, else fewer groups
  // with several warps splitting each group's words
  int gpb = kWarps;
  while (gpb > 1 && k < gpb) gpb >>= 1;
  a.groups_per_block = gpb;
  a.warps_per_group = kWarps / gpb;
  const long long group_blocks = (k + gpb - 1) / gpb;
  // split the word axis until about 8 blocks per SM are in flight, keeping
  // at least 4 steps of 32 vectors per warp
  const long long per_warp_min = (long long)a.warps_per_group * 32 * 4;
  long long max_splits = (a.nv + per_warp_min - 1) / per_warp_min;
  if (max_splits > 65535) max_splits = 65535;
  long long splits = ((long long)sms * 8 + group_blocks - 1) / group_blocks;
  if (splits > max_splits) splits = max_splits;
  if (splits < 1) splits = 1;
  a.split_vecs = (a.nv + splits - 1) / splits;
  splits = (a.nv + a.split_vecs - 1) / a.split_vecs;
  if (group_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)group_blocks, (unsigned)splits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nplanes == 0) return (int)launch<0>(a, grid, st);
  if (nplanes <= 8) return (int)launch<8>(a, grid, st);
  if (nplanes <= 16) return (int)launch<16>(a, grid, st);
  if (nplanes <= 32) return (int)launch<32>(a, grid, st);
  return (int)launch<64>(a, grid, st);
}
