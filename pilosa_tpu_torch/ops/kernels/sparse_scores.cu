// K2 sparse_stacked_scores: block-sparse TopN scoring across shards.
//
// out[q, block_row[b]] += popcount(blocks[b] & srcs[q, block_shard[b]]
//                                  container block_slot[b])   for every b.
//
// Replaces the XLA-jitted pilosa_tpu/ops/packed.py sparse_intersection_counts,
// sparse_intersection_counts_stacked, _stacked_batch and _stacked_batch_list
// (gather + popcount + segment_sum): the tall-index TopN scorer. Eager
// PyTorch would materialise the [Q, B, 2048] gathered source blocks that
// XLA fused away; here they never leave registers.
//
// Bound: bytes. The staged blocks are read once (B*8 KiB) and, per query,
// the source containers they name (at most S*16 of 8 KiB), plus 12 bytes
// of indices per block. The stager stages exactly the candidates' set
// containers, so B is what the function needs.
//
// Design: one warp per staged block, 8 warps per 256-thread block. The warp
// reads its own indices (the TPU version's scalar prefetch), then strides
// the 2048-word block with 16-byte streaming loads and ANDs each vector
// with the same words of the source container of up to QG queries, read
// through the read-only cache (neighbouring blocks of one shard share
// source containers). A warp shuffle reduces each count and lane 0 adds it
// with one atomicAdd into out[q, row]. Integer atomics give the same sum in
// any order; a zero count (most of a sparse tail's blocks) skips the atomic.
// A block whose row, slot or shard is out of range contributes nothing
// (segment_sum drops such rows).

#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockWords = 2048;           // one 2^16-bit container
constexpr int kBlockVecs = kBlockWords / 4;  // 16-byte vectors per container

template <int QG>
__global__ void __launch_bounds__(kThreads)
sparse_scores_kernel(const int32_t* __restrict__ srcs, const int32_t* __restrict__ blocks,
                     const int32_t* __restrict__ block_row,
                     const int32_t* __restrict__ block_slot,
                     const int32_t* __restrict__ block_shard, int32_t* __restrict__ out,
                     int q, int s, long long w, long long nb, int num_rows) {
  const long long b = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.y * QG;
  if (b >= nb) return;  // whole warp
  const int row = block_row[b];
  const int slot = block_slot[b];
  const int shard = block_shard != nullptr ? block_shard[b] : 0;
  if (row < 0 || row >= num_rows || slot < 0 || (long long)slot >= w / kBlockWords ||
      shard < 0 || shard >= s)
    return;  // whole warp
  const uint4* blk = reinterpret_cast<const uint4*>(blocks + b * kBlockWords);
  const uint4* src = reinterpret_cast<const uint4*>(
      srcs + ((long long)q0 * s + shard) * w + (long long)slot * kBlockWords);
  const long long qstride = (long long)s * w / 4;  // vectors per query
  unsigned acc[QG];
#pragma unroll
  for (int j = 0; j < QG; ++j) acc[j] = 0;
#pragma unroll 4
  for (int v = lane; v < kBlockVecs; v += 32) {
    const uint4 a = __ldcs(blk + v);
#pragma unroll
    for (int j = 0; j < QG; ++j) {
      if (q0 + j < q) acc[j] += popc_and(a, __ldg(src + j * qstride + v));
    }
  }
#pragma unroll
  for (int j = 0; j < QG; ++j) {
    const unsigned t = warp_sum(acc[j]);
    if (lane == 0 && t != 0 && q0 + j < q)
      atomicAdd(out + (long long)(q0 + j) * num_rows + row, (int)t);
  }
}

template <int QG>
static void launch(const int32_t* srcs, const int32_t* blocks, const int32_t* brow,
                   const int32_t* bslot, const int32_t* bshard, int32_t* out, int q, int s,
                   long long w, long long nb, int num_rows, cudaStream_t stream) {
  const dim3 grid((unsigned)((nb + kWarps - 1) / kWarps), (q + QG - 1) / QG);
  sparse_scores_kernel<QG><<<grid, kThreads, 0, stream>>>(srcs, blocks, brow, bslot, bshard,
                                                          out, q, s, w, nb, num_rows);
}

// srcs i32[q, s, w] (w % 2048 == 0), blocks i32[nb, 2048], block_row /
// block_slot / block_shard i32[nb] (block_shard may be null: shard 0),
// out i32[q, num_rows] zeroed by the caller. Returns cudaGetLastError().
extern "C" int pilosa_sparse_scores(const void* srcs, const void* blocks, const void* block_row,
                                    const void* block_slot, const void* block_shard, void* out,
                                    int q, int s, long long w, long long nb, int num_rows,
                                    int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int32_t* sr = static_cast<const int32_t*>(srcs);
  const int32_t* bl = static_cast<const int32_t*>(blocks);
  const int32_t* br = static_cast<const int32_t*>(block_row);
  const int32_t* bs = static_cast<const int32_t*>(block_slot);
  const int32_t* bh = static_cast<const int32_t*>(block_shard);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q <= 1)
    launch<1>(sr, bl, br, bs, bh, o, q, s, w, nb, num_rows, st);
  else if (q <= 2)
    launch<2>(sr, bl, br, bs, bh, o, q, s, w, nb, num_rows, st);
  else if (q <= 4)
    launch<4>(sr, bl, br, bs, bh, o, q, s, w, nb, num_rows, st);
  else if (q <= 8)
    launch<8>(sr, bl, br, bs, bh, o, q, s, w, nb, num_rows, st);
  else if (q <= 16)
    launch<16>(sr, bl, br, bs, bh, o, q, s, w, nb, num_rows, st);
  else
    launch<32>(sr, bl, br, bs, bh, o, q, s, w, nb, num_rows, st);
  return (int)cudaGetLastError();
}
