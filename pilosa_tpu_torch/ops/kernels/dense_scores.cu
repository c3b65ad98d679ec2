// K1 dense_scores: out[q, r] = popcount(srcs[q] & mat[r]).
//
// Replaces pilosa_tpu/ops/pallas_kernels.py intersection_counts_matrix_pallas
// (P1) and intersection_counts_matrix_batch_pallas (P2), and the XLA twins
// the JAX executor serves from (ops/packed.py intersection_counts_matrix and
// intersection_counts_matrix_batch_list): the dense TopN chunk scorer.
//
// Bound: bytes. A call must read the R x W staged matrix once (R*W*4 bytes:
// 512 MiB for 4096 rows of 2^20 bits) and the Q sources once (Q*W*4). At
// small Q the matrix read from HBM is the limit; each matrix word costs Q
// ANDs and Q popcounts, so a wide batch turns the popcount issue rate into
// the limit.
//
// Design: one block of 256 threads per matrix row (the Pallas kernel's
// sequential word axis becomes a loop inside the block, so no cross-block
// sum is needed). Threads stride the row with 16-byte streaming loads
// (__ldcs: the matrix is read once and should not evict the sources, which
// every block re-reads through the read-only cache and L2). Each thread
// keeps QG running counts in registers; a warp shuffle and one pass over
// shared memory reduce the block, and thread j writes out[q0 + j, r] once.
// Each output element has exactly one writer, so there are no atomics.
// Ragged R needs no padding: the grid has exactly R columns. Batches wider
// than QG take further grid rows (blockIdx.y), each re-reading the matrix.

#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int QG>
__global__ void __launch_bounds__(kThreads)
dense_scores_kernel(const int32_t* __restrict__ srcs, const int32_t* __restrict__ mat,
                    int32_t* __restrict__ out, int q, int r, long long w) {
  const int row = blockIdx.x;
  const int q0 = blockIdx.y * QG;
  const long long nv = w >> 2;  // 16-byte vectors per row
  const uint4* m = reinterpret_cast<const uint4*>(mat + (long long)row * w);
  const uint4* s = reinterpret_cast<const uint4*>(srcs + (long long)q0 * w);
  unsigned acc[QG];
#pragma unroll
  for (int j = 0; j < QG; ++j) acc[j] = 0;
#pragma unroll 4
  for (long long v = threadIdx.x; v < nv; v += kThreads) {
    const uint4 a = __ldcs(m + v);
#pragma unroll
    for (int j = 0; j < QG; ++j) {
      if (q0 + j < q) acc[j] += popc_and(a, __ldg(s + (long long)j * nv + v));
    }
  }
  __shared__ unsigned part[QG][kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < QG; ++j) {
    const unsigned t = warp_sum(acc[j]);
    if (lane == 0) part[j][warp] = t;
  }
  __syncthreads();
  if (threadIdx.x < QG && q0 + (int)threadIdx.x < q) {
    unsigned t = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) t += part[threadIdx.x][k];
    out[(long long)(q0 + threadIdx.x) * r + row] = (int32_t)t;
  }
}

template <int QG>
static void launch(const int32_t* srcs, const int32_t* mat, int32_t* out, int q, int r,
                   long long w, cudaStream_t stream) {
  const dim3 grid(r, (q + QG - 1) / QG);
  dense_scores_kernel<QG><<<grid, kThreads, 0, stream>>>(srcs, mat, out, q, r, w);
}

// srcs i32[q, w], mat i32[r, w], out i32[q, r]; w % 4 == 0, pointers
// 16-byte aligned (the Python wrapper checks). Returns cudaGetLastError().
extern "C" int pilosa_dense_scores(const void* srcs, const void* mat, void* out, int q,
                                   int r, long long w, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int32_t* s = static_cast<const int32_t*>(srcs);
  const int32_t* m = static_cast<const int32_t*>(mat);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q <= 1)
    launch<1>(s, m, o, q, r, w, st);
  else if (q <= 2)
    launch<2>(s, m, o, q, r, w, st);
  else if (q <= 4)
    launch<4>(s, m, o, q, r, w, st);
  else if (q <= 8)
    launch<8>(s, m, o, q, r, w, st);
  else if (q <= 16)
    launch<16>(s, m, o, q, r, w, st);
  else
    launch<32>(s, m, o, q, r, w, st);
  return (int)cudaGetLastError();
}
