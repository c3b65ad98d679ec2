// K2 sparse_stacked_scores: block-sparse TopN scoring across shards.
//
// out[q, block_row[b]] += popcount(blocks[b] & srcs[q][block_shard[b]]
//                                  container block_slot[b])   for every b.
//
// Replaces the XLA-jitted pilosa_tpu/ops/packed.py sparse_intersection_counts,
// sparse_intersection_counts_stacked, _stacked_batch and _stacked_batch_list
// (gather + popcount + segment_sum): the tall-index TopN scorer. Eager
// PyTorch would materialise the [Q, B, 2048] gathered source blocks that
// XLA fused away; here they never leave the SM.
//
// Bound: bytes. The staged blocks are read once (B x 8 KiB) and, per query,
// the source containers they name (at most S x 16 of 8 KiB), plus the
// indices. On CUDA cores the popcounts would be a second floor: one per
// block word and query, B x 2048 x Q at 16 a clock per SM, which passes
// the bytes from Q = 8 (0.15 ms at the tall index's B = 38,912).
//
// Design. Every block at (shard, slot) is ANDed with the same container of
// each query, so the blocks are taken group by group. The grouping
// (ops.SparseGroups) is made on the host once a bundle: a stable order of
// the valid blocks by (shard, slot), and a work list of items, each a group
// or an even share of at most kSpan = 64 blocks of a larger one; the blocks
// keep their place in memory. A CTA brings its item's containers of its
// queries into shared memory once, one cp.async.bulk of 8 KiB each, from
// each query's source stack by its address (the launch takes the stacks by
// pointer, so a batch is never copied into one tensor), padded by 64 bytes
// a query so that the lanes' reads of eight queries fall in distinct banks.
// Then it streams the item's blocks, which are read once, and adds each
// (block, query) sum into out[q, row] with one atomicAdd (out zeroed by the
// caller; integer atomics give the same sum in any order; a zero sum skips
// its atomic). A block whose row, slot or shard is out of range is not in
// the grouping and contributes nothing (segment_sum drops such rows).
//
// Three routes by batch width, each chosen on the card against the others
// (PERF.md, kernel_ab_probe.py's sparse_* cases):
//   * Q <= 2, CUDA cores: the popcounts cost less than the bytes, so each
//     warp streams whole blocks 2 KiB at a time and ANDs them with the
//     containers in shared memory, the pattern that streams HBM best; a
//     CTA takes 8 blocks of an item, so the short launch spreads evenly
//     (16 or 32 blocks a CTA, which fetch the containers less often, were
//     slower at Q = 2, and no faster at Q = 1).
//   * Q >= 3, tensor cores: a group is a binary matrix product, its blocks
//     the rows and the Q containers the columns, summed over 65,536 bits,
//     which the single-bit MMA computes (mma.sync m16n8k256 .b1 .and.popc:
//     16 blocks x 8 queries x 256 bits an instruction). An item's blocks
//     are up to four 16-row tiles; the warps take a tile's word axis's
//     steps in turn (each lane loads 2 steps of its two rows with streaming
//     loads, then reads the same vectors of its query's container from
//     shared memory and issues two MMAs a step and group of 8 queries), and
//     the warps' partial sums meet in shared memory. A lane (g, t)
//     supplies both operands at the same k, so the words of a step may be
//     laid out across lanes as the loads are.
//     - Q = 3-8: persistent, a CTA an SM walking items; one thread brings
//       the next item's containers into the other of two buffers while the
//       warps score this one (at Q = 8 an item's 64 KiB of containers took
//       long enough that a CTA an item waited on them; at Q = 4 a CTA an
//       item, three an SM, was 6 % faster, not worth a second kernel).
//     - Q = 9-32: 16 queries a CTA (132 KB of containers), a CTA an SM with
//       16 warps; a batch past 16 gives an item two CTAs, next to each
//       other in the grid so the second finds the blocks in L2.

#include <atomic>

#include "common.cuh"
#include "tma.cuh"

#define SS_MAX_Q 32

// Each query's [S, W] source stack: base pointer and shard stride in words
// (cuda._SparseSrcs).
struct SparseSrcs {
  const int32_t* base[SS_MAX_Q];
  long long shard_stride[SS_MAX_Q];
};

constexpr int kBlockWords = 2048;            // one 2^16-bit container
constexpr int kBlockVecs = kBlockWords / 4;  // 16-byte vectors a container
constexpr int kTile = 16;                    // the MMA's M: blocks a tile
constexpr int kMaxTiles = 4;
constexpr int kSpan = kTile * kMaxTiles;  // blocks an item holds (ops.SPARSE_SPAN)
constexpr int kGroup = 8;                 // the MMA's N: queries a group
constexpr int kStepVecs = 8;              // vectors of a block a warp step: 2 a lane
constexpr int kSteps = kBlockVecs / kStepVecs;
constexpr int kSrcVecs = kBlockVecs + 4;  // a query's container in shared memory, + 64 B
constexpr int kSrcBytes = kSrcVecs * 16;

struct SparseParams {
  SparseSrcs srcs;
  const uint4* blocks;       // [nb, 2048] words
  const int32_t* block_row;  // [nb]
  const int32_t* order;      // valid blocks by (shard, slot)
  const int4* items;         // (first in order, blocks, shard, slot)
  int32_t* out;              // [q, num_rows]
  int q;
  int nqc;  // CTAs an item
  int num_rows;
};

// A 16-byte load of a block, which is read once: not kept in L1, and L2
// asked for the 256-byte piece around it (a step reads 128 bytes of a
// block; the next warp's step reads the rest).
__device__ __forceinline__ uint4 ld_stream(const uint4* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

constexpr int kCcMaxQ = 2;       // queries up to which the CUDA-core route runs
constexpr int kPersistWarps = 16;

// Item ``it``'s containers of queries q0 .. q0 + nq - 1 into ``s_src``,
// one cp.async.bulk each completing on ``bar``; called by one thread.
__device__ __forceinline__ void fetch_containers(const SparseParams& p, const int4 it, int q0,
                                                 int nq, uint4* s_src, uint64_t* bar) {
  mbar_expect_tx(bar, (unsigned)nq * kBlockWords * 4u);
  for (int j = 0; j < nq; ++j) {
    const int32_t* src = p.srcs.base[q0 + j] + it.z * p.srcs.shard_stride[q0 + j] +
                         (long long)it.w * kBlockWords;
    bulk_g2s(s_src + j * kSrcVecs, src, kBlockWords * 4u, bar);
  }
}

// The item's header for a CTA that takes one item: its block indices into
// ``s_blk`` and its containers on their way (``bar`` initialised here).
template <int THREADS>
__device__ __forceinline__ void item_start(const SparseParams& p, const int4 it, int q0, int nq,
                                           uint4* s_src, int* s_blk, uint64_t* bar) {
  const int count = min(it.y, kSpan);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
  }
  for (int i = threadIdx.x; i < count; i += THREADS) s_blk[i] = p.order[it.x + i];
  __syncthreads();
  if (threadIdx.x == 0) fetch_containers(p, it, q0, nq, s_src, bar);
}

// The CUDA-core route (Q <= kCcMaxQ): a CTA takes 8 blocks of an item, a
// warp a block, streamed 2 KiB at a time and ANDed with the containers in
// shared memory; one warp sum and one atomicAdd a block and query.
template <int QG>
__global__ void __launch_bounds__(256)
sparse_scores_cc_kernel(const __grid_constant__ SparseParams p) {
  constexpr int kThreads = 256;
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(128) uint4 s_src[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ int s_blk[kSpan];
  constexpr int kParts = kSpan / kWarps;
  const int4 it = p.items[blockIdx.x / kParts];
  const int part = blockIdx.x % kParts;
  const int count = min(it.y, kSpan);
  if (part * kWarps >= count) return;
  const int kend = min(count, part * kWarps + kWarps);
  item_start<kThreads>(p, it, 0, p.q, s_src, s_blk, &bar);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  mbar_wait(&bar, 0);
  for (int k = part * kWarps + warp; k < kend; k += kWarps) {
    const uint4* blk = p.blocks + (long long)s_blk[k] * kBlockVecs;
    unsigned acc[QG];
#pragma unroll
    for (int j = 0; j < QG; ++j) acc[j] = 0;
#pragma unroll 4
    for (int v = lane; v < kBlockVecs; v += 32) {
      const uint4 a = __ldcs(blk + v);
#pragma unroll
      for (int j = 0; j < QG; ++j)
        if (j < p.q) acc[j] += popc_and(a, s_src[j * kSrcVecs + v]);
    }
    const int row = p.block_row[s_blk[k]];
#pragma unroll
    for (int j = 0; j < QG; ++j) {
      const unsigned t = warp_sum(acc[j]);
      if (lane == 0 && t != 0 && j < p.q && row >= 0 && row < p.num_rows)
        atomicAdd(p.out + (long long)j * p.num_rows + row, (int)t);
    }
  }
}

// The MMA route's work on one item whose queries' containers are in
// ``s_src`` and whose block indices are in ``s_blk``: the tiles' products
// into registers, the warps' partial sums into ``s_out`` (zero on entry,
// zero again on return), then one atomicAdd a block and query.
template <int NG, int WARPS>
__device__ __forceinline__ void mma_item(const SparseParams& p, int count, const int* s_blk,
                                         const uint4* s_src, unsigned* s_out, int q0, int nq) {
  constexpr int kThreads = WARPS * 32;
  constexpr int QC = kGroup * NG;  // queries a CTA
  constexpr int kPair = 2;         // warp steps a lane loads before it computes
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // MMA group: rows g and g + 8 of a tile, query g of a group
  const int t = lane & 3;   // thread in group: its vector of a half step
  const int ntiles = (count + kTile - 1) / kTile;
  const uint4* ps[NG];
  bool hs[NG];
#pragma unroll
  for (int sg = 0; sg < NG; ++sg) {
    hs[sg] = sg * kGroup + g < nq;
    ps[sg] = s_src + (hs[sg] ? sg * kGroup + g : 0) * kSrcVecs;
  }

  unsigned acc[kMaxTiles][NG][4];
#pragma unroll
  for (int m = 0; m < kMaxTiles; ++m)
#pragma unroll
    for (int sg = 0; sg < NG; ++sg) acc[m][sg][0] = acc[m][sg][1] = acc[m][sg][2] = acc[m][sg][3] = 0;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // a tile at a time: the warps take its word axis's steps in turn, a
  // lane loading kPair steps of its two rows before it computes
#pragma unroll
  for (int m = 0; m < kMaxTiles; ++m) {
    if (m >= ntiles) break;
    const int ia = m * kTile + g;
    const bool ha = ia < count;
    const bool hb = ia + 8 < count;
    const uint4* pa = p.blocks + (long long)(ha ? s_blk[ia] : 0) * kBlockVecs;
    const uint4* pb = p.blocks + (long long)(hb ? s_blk[ia + 8] : 0) * kBlockVecs;
#pragma unroll 1
    for (int st = warp; st < kSteps; st += WARPS * kPair) {
      uint4 a[kPair][2], b[kPair][2];
#pragma unroll
      for (int u = 0; u < kPair; ++u) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int v = (st + u * WARPS) * kStepVecs + 4 * h + t;
          a[u][h] = ha ? ld_stream(pa + v) : zero;
          b[u][h] = hb ? ld_stream(pb + v) : zero;
        }
      }
#pragma unroll
      for (int u = 0; u < kPair; ++u) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int v = (st + u * WARPS) * kStepVecs + 4 * h + t;
#pragma unroll
          for (int sg = 0; sg < NG; ++sg) {
            const uint4 s = hs[sg] ? ps[sg][v] : zero;
            mma_and_popc(acc[m][sg], a[u][h].x, b[u][h].x, a[u][h].y, b[u][h].y, s.x, s.y);
            mma_and_popc(acc[m][sg], a[u][h].z, b[u][h].z, a[u][h].w, b[u][h].w, s.z, s.w);
          }
        }
      }
    }
  }

  // the accumulator: [0] (row g, query 2t), [1] (row g, 2t + 1), [2] (row
  // g + 8, 2t), [3] (row g + 8, 2t + 1) of each tile and query group
#pragma unroll
  for (int m = 0; m < kMaxTiles; ++m) {
    if (m >= ntiles) break;
#pragma unroll
    for (int sg = 0; sg < NG; ++sg) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned v = acc[m][sg][i];
        if (v != 0)
          atomicAdd(&s_out[(m * kTile + g + 8 * (i >> 1)) * QC + sg * kGroup + 2 * t + (i & 1)], v);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < count * QC; i += kThreads) {
    const int k = i / QC;
    const int j = i - k * QC;
    const unsigned v = s_out[i];
    if (v == 0) continue;
    s_out[i] = 0;
    const int row = p.block_row[s_blk[k]];
    if (j < nq && row >= 0 && row < p.num_rows)
      atomicAdd(p.out + (long long)(q0 + j) * p.num_rows + row, (int)v);
  }
  __syncthreads();
}

// Q > 8: one CTA an item and 16 of its queries (past 16 queries an item
// takes two CTAs, next to each other in the grid).
constexpr int kWideNG = 2;  // query groups a CTA
constexpr int kWideWarps = 16;

__global__ void __launch_bounds__(kWideWarps * 32, 1)
sparse_scores_wide_kernel(const __grid_constant__ SparseParams p) {
  constexpr int kThreads = kWideWarps * 32;
  constexpr int QC = kGroup * kWideNG;
  extern __shared__ __align__(128) uint4 s_src[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ unsigned s_out[kSpan * QC];  // [block of the item][query]
  __shared__ int s_blk[kSpan];
  const int item = blockIdx.x / p.nqc;
  const int q0 = (blockIdx.x - item * p.nqc) * QC;
  const int nq = min(QC, p.q - q0);
  const int4 it = p.items[item];
  for (int i = threadIdx.x; i < kSpan * QC; i += kThreads) s_out[i] = 0;
  item_start<kThreads>(p, it, q0, nq, s_src, s_blk, &bar);
  mbar_wait(&bar, 0);
  mma_item<kWideNG, kWideWarps>(p, min(it.y, kSpan), s_blk, s_src, s_out, q0, nq);
}

// Q = 3 .. 8, persistent: a CTA walks items gridDim.x apart,
// and one thread brings the next item's containers into the other of two
// buffers while the warps score this one, so no item waits for its
// containers.
template <int WARPS>
__global__ void __launch_bounds__(WARPS * 32, 1)
sparse_scores_persistent_kernel(const __grid_constant__ SparseParams p, int n_items) {
  constexpr int kThreads = WARPS * 32;
  extern __shared__ __align__(128) uint4 s_src[];  // two buffers of q containers
  __shared__ __align__(8) uint64_t bar[2];
  __shared__ unsigned s_out[kSpan * kGroup];
  __shared__ int s_blk[2][kSpan];
  const int nq = p.q;
  const int buf_vecs = nq * kSrcVecs;
  if (threadIdx.x == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    fence_barrier_init();
  }
  for (int i = threadIdx.x; i < kSpan * kGroup; i += kThreads) s_out[i] = 0;
  __syncthreads();
  // the containers and block indices of the item ``w`` into buffer ``b``
  auto fetch = [&](int w, int b) {
    const int4 it = p.items[w];
    const int count = min(it.y, kSpan);
    for (int i = threadIdx.x; i < count; i += kThreads) s_blk[b][i] = p.order[it.x + i];
    if (threadIdx.x == 0) fetch_containers(p, it, 0, nq, s_src + b * buf_vecs, &bar[b]);
  };
  int w = blockIdx.x;
  if (w < n_items) fetch(w, 0);
  for (int i = 0; w < n_items; ++i, w += gridDim.x) {
    const int b = i & 1;
    // buffer b ^ 1 was last read in the previous item, which ended with a
    // barrier
    if (w + (int)gridDim.x < n_items) fetch(w + gridDim.x, b ^ 1);
    __syncthreads();  // this item's block indices
    mbar_wait(&bar[b], (i >> 1) & 1);
    mma_item<1, WARPS>(p, min(p.items[w].y, kSpan), s_blk[b], s_src + b * buf_vecs, s_out, 0, nq);
  }
}

// whether a kernel instance may use its shared memory on a device: set
// once per instance and device (callers on several threads may race to
// set it twice)
static std::atomic<bool> g_ready[3][64];

template <typename K>
static cudaError_t launch(K kernel, int instance, int most_smem, int smem, unsigned grid,
                          int threads, const SparseParams& prm, int device, cudaStream_t stream) {
  if (!g_ready[instance][device].load(std::memory_order_acquire)) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most_smem);
    if (e != cudaSuccess) return e;
    g_ready[instance][device].store(true, std::memory_order_release);
  }
  kernel<<<grid, threads, smem, stream>>>(prm);
  return cudaGetLastError();
}

// The persistent route's CTAs on a device at each q (its shared memory):
// the occupancy query's CTAs an SM times the SMs; 0 until first asked.
static std::atomic<int> g_persist_grid[64][kGroup + 1];

static cudaError_t launch_persistent(const SparseParams& prm, int n_items, int device,
                                     cudaStream_t stream) {
  auto kernel = sparse_scores_persistent_kernel<kPersistWarps>;
  const int smem = 2 * prm.q * kSrcBytes;
  int most = g_persist_grid[device][prm.q].load(std::memory_order_acquire);
  if (most == 0) {
    int per_sm = 0, sms = 0;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         2 * kGroup * kSrcBytes);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kPersistWarps * 32, smem);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    most = per_sm * sms;
    g_persist_grid[device][prm.q].store(most, std::memory_order_release);
  }
  const int grid = n_items < most ? n_items : most;
  kernel<<<grid, kPersistWarps * 32, smem, stream>>>(prm, n_items);
  return cudaGetLastError();
}

// srcs: HOST pointer to q source stacks, each int32 [s, w] (w % 2048 == 0)
// at 16-byte aligned addresses and shard strides; blocks int32 [nb, 2048];
// block_row int32 [nb]; order and items the grouping (ops.SparseGroups);
// out int32 [q, num_rows] zeroed by the caller. Returns cudaGetLastError(),
// or cudaErrorInvalidValue past the limits.
extern "C" int pilosa_sparse_scores(const SparseSrcs* srcs, const void* blocks,
                                    const void* block_row, const void* order, const void* items,
                                    int n_items, void* out, int q, int num_rows, int device,
                                    void* stream) {
  if (q < 1 || q > SS_MAX_Q || n_items < 1 || num_rows < 1 || device < 0 || device >= 64)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  SparseParams prm;
  prm.srcs = *srcs;
  prm.blocks = static_cast<const uint4*>(blocks);
  prm.block_row = static_cast<const int32_t*>(block_row);
  prm.order = static_cast<const int32_t*>(order);
  prm.items = static_cast<const int4*>(items);
  prm.out = static_cast<int32_t*>(out);
  prm.q = q;
  prm.num_rows = num_rows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned items_ = (unsigned)n_items;
  if (q <= kCcMaxQ) {
    prm.nqc = 1;
    const unsigned cc_grid = items_ * (kSpan / 8);
    if (q == 1)
      return (int)launch(sparse_scores_cc_kernel<1>, 0, kSrcBytes, kSrcBytes, cc_grid, 256, prm,
                         device, st);
    return (int)launch(sparse_scores_cc_kernel<kCcMaxQ>, 1, kCcMaxQ * kSrcBytes,
                       q * kSrcBytes, cc_grid, 256, prm, device, st);
  }
  prm.nqc = 1;
  if (q <= kGroup) return (int)launch_persistent(prm, n_items, device, st);
  prm.nqc = (q + 2 * kGroup - 1) / (2 * kGroup);
  return (int)launch(sparse_scores_wide_kernel, 2, 2 * kGroup * kSrcBytes,
                     min(q, 2 * kGroup) * kSrcBytes, items_ * (unsigned)prm.nqc, kWideWarps * 32,
                     prm, device, st);
}
