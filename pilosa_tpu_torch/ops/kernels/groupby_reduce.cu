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
// per plane; here no group word leaves a register.
//
// Bound: what the inputs need. A filtered panel (SSB Q3.2: 600 groups over
// 1/625 of the columns) holds few non-zero group words, so its bound is the
// bytes of the filter plus the other rows where the filter is set; only a
// dense panel (no filter, every group set at every word) is bound by its
// K * Wf * (P + 1) popcounts.
//
// Design: three paths, chosen by what the launch shows (K, P, a filter).
//   * A panel with a filter, planes, or too wide for the count-only path
//     below, walks the word axis once. Each warp reads the filter 32 words at a
//     time and gathers the words where it is set in shared memory until
//     every lane has one; then each lane walks its own word's groups depth
//     first over the dimensions, first dimension slowest, with a running AND
//     in a register: it loads 8 rows of a dimension at once, descends only
//     into rows its AND keeps (so a group word is reached only where it is
//     set, and every group it is set in is reached, exclusive rows or not),
//     and at a reached group adds popcount(g) and popcount(g & plane[p])
//     (plane words loaded once per word) to a K x (P + 1) histogram in
//     shared memory. A lane reads only the sectors where the filter is set.
//     (A first version walked each 32-word chunk with the whole warp, voting
//     on rows and summing counts over the lanes: at Q3.2's density some 5 %
//     of its lanes had work, and it took more than twice as long.)
//   * An unfiltered count-only panel of at most 64 groups and 16 rows
//     (GroupBy(Rows(c_region), Rows(s_region))) has every group set nearly
//     everywhere: its rows stream once through shared memory and each
//     thread counts a quarter of the groups at a 16-byte vector in
//     registers.
//   * K = 1 (Sum through bsi_plane_counts) has one group set wherever the
//     filter is: one warp per word range, 16-byte loads, a register
//     accumulator per plane and one reduction at the end.
// The grids are persistent (as many blocks as fit on the SMs, one for K = 1
// per word range) and each block adds its non-zero sums to the outputs once,
// with integer atomics (exact in any order); a histogram too big for shared
// memory (K x (P + 1) over 200 KB) adds to the outputs directly.

#include <atomic>

#include "common.cuh"
#include "tma.cuh"

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
  long long split_vecs;  // vectors per block of the streaming kernel (K = 1)
  int k;
  int32_t* counts;
  int32_t* plane_counts;
};

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// the largest shared histogram, K x (P + 1) counts
constexpr size_t kHistMaxBytes = 200 * 1024;
// the dense count-only path: groups, rows, vectors per tile row, ring depth
constexpr int kCountGroups = 64;
constexpr int kCountRows = 16;
constexpr int kCountVecs = 64;
constexpr int kCountStages = 4;
// rows of a dimension the walk loads at once
constexpr int kWalkBatch = 8;

__device__ __forceinline__ uint4 and4(uint4 a, const uint4 b) {
  a.x &= b.x; a.y &= b.y; a.z &= b.z; a.w &= b.w;
  return a;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// -- K = 1: streaming ----------------------------------------------------------------

template <int PMAX>
__global__ void __launch_bounds__(kThreads)
groupby_stream_kernel(const __grid_constant__ GbArgs a) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // the one group's row of each dimension (every dimension has one row)
  const uint4* rowp[GB_MAX_DIMS];
#pragma unroll
  for (int d = 0; d < GB_MAX_DIMS; ++d) rowp[d] = d < a.ndims ? a.dims[d].base : nullptr;

  const long long v_begin = (long long)blockIdx.x * a.split_vecs;
  long long v_end = v_begin + a.split_vecs;
  if (v_end > a.nv) v_end = a.nv;
  const long long step = (long long)kThreads;
  long long v = v_begin + (long long)warp * 32 + lane;
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
  if (lane == 0 && cnt != 0) atomicAdd(a.counts, (int)cnt);
#pragma unroll
  for (int p = 0; p < PMAX; ++p) {
    if (p < a.nplanes) {
      const unsigned t = warp_sum(acc[p]);
      if (lane == 0 && t != 0) atomicAdd(a.plane_counts + p, (int)t);
    }
  }
}

// -- a dense count-only panel: no filter, no planes, K <= 64, 16 rows --------------------

// Every group is set at nearly every word and there are few rows to read:
// the rows stream once through a 4-stage ring in shared memory (cp.async,
// 16 bytes a thread at a time, so many loads are in flight), and each
// thread counts a quarter of the groups at one 16-byte vector of each tile
// into registers of its own.
template <int KMAX>
__global__ void __launch_bounds__(kThreads)
groupby_count_kernel(const __grid_constant__ GbArgs a, int nrows) {
  constexpr int KT = KMAX / 4;  // groups a thread counts
  extern __shared__ uint4 s_ring[];  // [kCountStages][kCountRows][kCountVecs]
  __shared__ const uint4* s_base[kCountRows];
  __shared__ long long s_shard[kCountRows];
  __shared__ unsigned char s_row[KMAX * GB_MAX_DIMS];  // group k's flat row in dim d
  __shared__ unsigned s_cnt[KMAX];
  const int tid = threadIdx.x;
  if (tid < KMAX) s_cnt[tid] = 0;
  if (tid == 0) {
    int j = 0;
    for (int d = 0; d < a.ndims; ++d)
      for (int r = 0; r < a.dims[d].rows; ++r, ++j) {
        s_base[j] = a.dims[d].base + (long long)r * a.dims[d].row_stride;
        s_shard[j] = a.dims[d].shard_stride;
      }
  }
  for (int k = tid; k < a.k; k += kThreads) {
    int rem = k, first = nrows;
    for (int d = a.ndims - 1; d >= 0; --d) {
      first -= a.dims[d].rows;
      s_row[k * GB_MAX_DIMS + d] = (unsigned char)(first + rem % a.dims[d].rows);
      rem /= a.dims[d].rows;
    }
  }
  __syncthreads();

  const unsigned wv = (unsigned)a.wv;
  const long long ntiles_all = (a.nv + kCountVecs - 1) / kCountVecs;
  const long long per = (ntiles_all + gridDim.x - 1) / gridDim.x;
  const long long t0 = (long long)blockIdx.x * per;
  const long long t1 = min(t0 + per, ntiles_all);
  auto issue = [&](long long j) {
    if (j < t1) {
      uint4* dst = s_ring + (size_t)(j % kCountStages) * kCountRows * kCountVecs;
      for (int i = tid; i < nrows * kCountVecs; i += kThreads) {
        const int row = i / kCountVecs;
        const int vv = i - row * kCountVecs;
        const long long v = j * kCountVecs + vv;
        if (v >= a.nv) continue;
        const unsigned s = (unsigned)(v / wv);
        const unsigned w = (unsigned)(v - (long long)s * wv);
        cp_async16(dst + row * kCountVecs + vv, s_base[row] + (long long)s * s_shard[row] + w);
      }
    }
    cp_async_commit();
  };
  for (int j = 0; j < kCountStages - 1; ++j) issue(t0 + j);

  const int vv = tid % kCountVecs;
  const int part = tid / kCountVecs;  // groups k = part + 4 i
  unsigned acc[KT];
#pragma unroll
  for (int i = 0; i < KT; ++i) acc[i] = 0;
  for (long long j = t0; j < t1; ++j) {
    issue(j + kCountStages - 1);  // into the stage the last barrier freed
    cp_async_wait<kCountStages - 1>();
    __syncthreads();
    const uint4* tile = s_ring + (size_t)(j % kCountStages) * kCountRows * kCountVecs + vv;
    if (j * kCountVecs + vv < a.nv) {
#pragma unroll
      for (int i = 0; i < KT; ++i) {
        const int k = part + 4 * i;
        if (k < a.k) {
          uint4 g = make_uint4(~0u, ~0u, ~0u, ~0u);
#pragma unroll
          for (int d = 0; d < GB_MAX_DIMS; ++d)
            if (d < a.ndims) g = and4(g, tile[s_row[k * GB_MAX_DIMS + d] * kCountVecs]);
          acc[i] += popc4(g);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < KT; ++i) {
    const int k = part + 4 * i;
    const unsigned t = warp_sum(acc[i]);  // a warp shares its part
    if ((tid & 31) == 0 && k < a.k && t != 0) atomicAdd(&s_cnt[k], t);
  }
  __syncthreads();
  if (tid < a.k && s_cnt[tid] != 0) atomicAdd(a.counts + tid, (int)s_cnt[tid]);
}

// -- K >= 2: the walk over the groups that are set -----------------------------------

// Adds v to entry idx (0 the count, 1 + p plane p) of group k.
__device__ __forceinline__ void gb_add(const GbArgs& a, unsigned* hist, int k, int idx, unsigned v) {
  const int np = a.nplanes;
  if (hist != nullptr)
    atomicAdd(hist + (size_t)k * (np + 1) + idx, v);
  else if (idx == 0)
    atomicAdd(a.counts + k, (int)v);
  else
    atomicAdd(a.plane_counts + (size_t)k * np + idx - 1, (int)v);
}

// Dimension L under the running AND g of groups k (the product index of the
// rows chosen so far), walked by one lane over its own word; rowp[d] points
// at the lane's word in row 0 of d. A reached group adds its P + 1 counts
// with the lane's atomics.
template <int L, int PMAX>
__device__ __forceinline__ void gb_lane_walk(const GbArgs& a, const uint32_t* const (&rowp)[GB_MAX_DIMS],
                                             const unsigned (&pl)[PMAX > 0 ? PMAX : 1],
                                             unsigned* hist, unsigned g, int k) {
  if (L == a.ndims) {
    gb_add(a, hist, k, 0, __popc(g));
#pragma unroll
    for (int p = 0; p < PMAX; ++p) {
      if (p < a.nplanes) {
        const unsigned v = __popc(g & pl[p]);
        if (v != 0) gb_add(a, hist, k, 1 + p, v);
      }
    }
    return;
  }
  if constexpr (L < GB_MAX_DIMS) {
    const int rows = a.dims[L].rows;
    const long long rs = a.dims[L].row_stride * 4;  // words
    const uint32_t* p = rowp[L];
    for (int r0 = 0; r0 < rows; r0 += kWalkBatch) {
      unsigned m = 0;  // kWalkBatch rows in flight, then the ones to descend into
#pragma unroll
      for (int i = 0; i < kWalkBatch; ++i)
        if (r0 + i < rows && (g & __ldg(p + (long long)(r0 + i) * rs)) != 0) m |= 1u << i;
      while (m != 0) {
        const int i = __ffs(m) - 1;
        m &= m - 1;
        gb_lane_walk<L + 1, PMAX>(a, rowp, pl, hist, g & __ldg(p + (long long)(r0 + i) * rs),
                                  k * rows + r0 + i);
      }
    }
  }
}

template <int PMAX>
__global__ void __launch_bounds__(kThreads)
groupby_walk_kernel(const __grid_constant__ GbArgs a, int use_hist) {
  extern __shared__ unsigned hist_s[];
  // words where the filter is set, gathered per warp until every lane has
  // one: (word index, filter word)
  __shared__ uint2 s_queue[kWarps][2 * 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int np = a.nplanes;
  unsigned* hist = use_hist ? hist_s : nullptr;
  const int nent = use_hist ? a.k * (np + 1) : 0;
  for (int i = threadIdx.x; i < nent; i += kThreads) hist_s[i] = 0;
  __syncthreads();

  const unsigned wsh = (unsigned)a.wv * 4;  // words per shard
  const unsigned nwords = (unsigned)a.nv * 4;
  const uint32_t* filt = reinterpret_cast<const uint32_t*>(a.filt);
  const uint32_t* planes = reinterpret_cast<const uint32_t*>(a.planes);
  const unsigned nchunks = (nwords + 31) / 32;
  const unsigned total = gridDim.x * kWarps;

  // this lane's rows and planes at word i
  auto setup = [&](unsigned i, unsigned f, const uint32_t* (&rowp)[GB_MAX_DIMS],
                   unsigned (&pl)[PMAX > 0 ? PMAX : 1]) {
    const unsigned s = i / wsh;
    const unsigned w = i - s * wsh;
#pragma unroll
    for (int d = 0; d < GB_MAX_DIMS; ++d)
      rowp[d] = d < a.ndims ? reinterpret_cast<const uint32_t*>(a.dims[d].base) +
                                  (long long)s * a.dims[d].shard_stride * 4 + w
                            : nullptr;
    const uint32_t* pp = planes + (long long)s * a.plane_shard_stride * 4 + w;
#pragma unroll
    for (int p = 0; p < (PMAX > 0 ? PMAX : 1); ++p)
      pl[p] = (PMAX > 0 && p < np && f != 0) ? __ldg(pp + (long long)p * a.plane_stride * 4) : 0u;
  };
  const uint32_t* rowp[GB_MAX_DIMS];
  unsigned pl[PMAX > 0 ? PMAX : 1];

  // gather the words where the filter is set until every lane has one,
  // then each lane walks its own
  uint2* q = s_queue[warp];
  int qn = 0;  // uniform
  const unsigned lt = (1u << lane) - 1u;
  for (unsigned ch = blockIdx.x * kWarps + warp;; ch += total) {
    const bool more = ch < nchunks;  // uniform
    if (more) {
      const unsigned i = ch * 32 + lane;
      unsigned f = 0;
      if (i < nwords) {
        const unsigned s = i / wsh;
        f = filt != nullptr ? __ldg(filt + (long long)s * a.filt_shard_stride * 4 + (i - s * wsh))
                            : ~0u;
      }
      const unsigned bal = __ballot_sync(kFull, f != 0);
      if (f != 0) q[qn + __popc(bal & lt)] = make_uint2(i, f);
      qn += __popc(bal);
      __syncwarp();
    }
    if (qn >= 32 || (!more && qn > 0)) {
      const uint2 e = lane < qn ? q[lane] : make_uint2(0, 0);
      __syncwarp();
      if (qn > 32 && lane < qn - 32) q[lane] = q[32 + lane];
      qn = qn > 32 ? qn - 32 : 0;
      __syncwarp();
      setup(e.x, e.y, rowp, pl);
      if (e.y != 0) gb_lane_walk<0, PMAX>(a, rowp, pl, hist, e.y, 0);
      __syncwarp();
    }
    if (!more && qn == 0) break;
  }

  if (!use_hist) return;
  __syncthreads();
  for (int i = threadIdx.x; i < nent; i += kThreads) {
    const unsigned v = hist_s[i];
    if (v == 0) continue;
    const int k = i / (np + 1);
    const int idx = i - k * (np + 1);
    if (idx == 0)
      atomicAdd(a.counts + k, (int)v);
    else
      atomicAdd(a.plane_counts + (size_t)k * np + idx - 1, (int)v);
  }
}

// Raise ``kernel``'s dynamic shared memory limit to ``most``, the most any
// launch of it asks for, once a device; each launch then asks for its own
// size. Setting the limit to each launch's size instead lets a concurrent
// launch (the executor runs a request's calls on several threads) lower
// it between another thread's setting and launch, which then fails.
template <typename K>
static cudaError_t allow_smem(K kernel, std::atomic<bool>* ready, int device, size_t most) {
  if (ready[device].load(std::memory_order_acquire)) return cudaSuccess;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
  if (e == cudaSuccess) ready[device].store(true, std::memory_order_release);
  return e;
}

template <int KMAX>
static cudaError_t launch_count(const GbArgs& a, int nrows, int sms, int device,
                                cudaStream_t stream) {
  static std::atomic<bool> ready[64];
  const size_t smem = (size_t)kCountStages * kCountRows * kCountVecs * sizeof(uint4);
  cudaError_t e = allow_smem(groupby_count_kernel<KMAX>, ready, device, smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, groupby_count_kernel<KMAX>, kThreads,
                                                    smem);
  if (e != cudaSuccess) return e;
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long tiles = (a.nv + kCountVecs - 1) / kCountVecs;
  if (blocks > tiles) blocks = tiles;
  groupby_count_kernel<KMAX><<<(unsigned)blocks, kThreads, smem, stream>>>(a, nrows);
  return cudaGetLastError();
}

template <int PMAX>
static cudaError_t launch(const GbArgs& a, int sms, int device, cudaStream_t stream) {
  static std::atomic<bool> ready[64];
  if (a.k == 1) {
    // split the word axis until about 8 blocks per SM are in flight,
    // keeping at least 4 steps of 32 vectors per warp
    GbArgs b = a;
    const long long per_block_min = (long long)kThreads * 4;
    long long splits = (long long)sms * 8;
    const long long max_splits = (a.nv + per_block_min - 1) / per_block_min;
    if (splits > max_splits) splits = max_splits;
    if (splits < 1) splits = 1;
    b.split_vecs = (a.nv + splits - 1) / splits;
    splits = (a.nv + b.split_vecs - 1) / b.split_vecs;
    groupby_stream_kernel<PMAX><<<(unsigned)splits, kThreads, 0, stream>>>(b);
    return cudaGetLastError();
  }
  int nrows = 0;
  for (int d = 0; d < a.ndims; ++d) nrows += a.dims[d].rows;
  if (a.filt == nullptr && a.nplanes == 0 && a.k <= kCountGroups && nrows <= kCountRows)
    return a.k <= 16   ? launch_count<16>(a, nrows, sms, device, stream)
           : a.k <= 32 ? launch_count<32>(a, nrows, sms, device, stream)
                       : launch_count<64>(a, nrows, sms, device, stream);
  const size_t hist_bytes = (size_t)a.k * (a.nplanes + 1) * sizeof(unsigned);
  const int use_hist = hist_bytes <= kHistMaxBytes;
  const size_t smem = use_hist ? hist_bytes : 0;
  cudaError_t e = allow_smem(groupby_walk_kernel<PMAX>, ready, device, kHistMaxBytes);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, groupby_walk_kernel<PMAX>, kThreads,
                                                    smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) per_sm = 1;
  const long long chunks = (a.nv * 4 + 31) / 32;
  long long blocks = (long long)sms * per_sm;
  const long long most = (chunks + kWarps - 1) / kWarps;
  if (blocks > most) blocks = most;
  groupby_walk_kernel<PMAX><<<(unsigned)blocks, kThreads, smem, stream>>>(a, use_hist);
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
  // the walk indexes words with 32-bit integers
  if (ndims < 0 || ndims > GB_MAX_DIMS || nplanes < 0 || nplanes > 64 || k < 1 ||
      k > 0x7fffffffLL || s < 1 || wv < 1 || s * wv * 4 + 32 > 0xffffffffLL || device < 0 ||
      device >= 64)
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

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nplanes == 0) return (int)launch<0>(a, sms, device, st);
  if (nplanes <= 8) return (int)launch<8>(a, sms, device, st);
  if (nplanes <= 16) return (int)launch<16>(a, sms, device, st);
  if (nplanes <= 32) return (int)launch<32>(a, sms, device, st);
  return (int)launch<64>(a, sms, device, st);
}
