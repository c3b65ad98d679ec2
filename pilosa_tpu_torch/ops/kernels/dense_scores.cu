// K1 dense_scores: out[q, r] = popcount(srcs[q] & mat[r]).
//
// Replaces pilosa_tpu/ops/pallas_kernels.py intersection_counts_matrix_pallas
// (P1) and intersection_counts_matrix_batch_pallas (P2), and the XLA twins
// the JAX executor serves from (ops/packed.py intersection_counts_matrix and
// intersection_counts_matrix_batch_list): the dense TopN chunk scorer.
//
// Bound: bytes. A call must read the R x W staged matrix once (512 MiB for
// 4096 rows of 2^20 bits) and the Q sources once. On CUDA cores it would
// also need a popcount per (row, non-zero source word), which at Q = 8-32
// is the larger term (16 popcounts a clock per SM).
//
// Design: the function is a binary matrix product, out = srcs x mat^T over
// bits with AND for the product and popcount for the sum, which is what the
// tensor cores' single-bit MMA computes (mma.sync m16n8k256 .b1 .and.popc:
// 16 rows x 8 sources x 256 bits an instruction). So the popcounts leave
// the CUDA cores and the kernel streams the matrix.
//   * A block owns 16 matrix rows (the MMA's M) and all Q <= 32 sources
//     (four groups of 8, the MMA's N). When Q <= 4 it owns 8 (half the M
//     idle): twice the blocks spread the stream better where the sources,
//     re-read per block, cost little. Its 16 warps take the word axis's
//     steps (32 words of each row) in turn, so the block walks each row
//     front to back 2 KB at a time; giving each warp a contiguous sixteenth
//     of the axis instead kept 16 x 16 streams of 64-byte pieces open per
//     block and streamed far slower.
//   * Per step a lane loads two 16-byte vectors of each of its two rows
//     (streaming loads that ask L2 for 256 bytes: the matrix is read once)
//     and of its source of each group, and issues four MMAs per group. The
//     MMA pairs A's and B's bits by their k index, and a lane supplies both
//     at the same k, so the words of a step may be laid out across lanes as
//     the loads are: lane (g, t) holds words 4t..4t+3 and 16+4t..16+4t+3 of
//     row g, row g + 8 and source g of each group.
//   * Loads run 4 steps ahead (unrolled), so a block of 16 warps keeps about
//     128 KB in flight. The sources, re-read once per 16 rows, stay in L2.
//   * Counts accumulate in the MMA's int32 registers; at the end each warp
//     adds its 16 x 32 partial sums into shared memory and one thread writes
//     each output: no global atomics and no memset.
// Batches wider than 32 take further grid rows (blockIdx.y), each re-reading
// the matrix. Ragged R, Q and W need no padding: loads past them are zeros.

#include "common.cuh"

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;     // the MMA's M: rows g and g + 8 of lane group g
constexpr int kGroup = 8;     // sources per MMA (its N)
constexpr int kMaxQ = 32;     // sources per grid row: 4 groups
constexpr int kStepVecs = 8;  // 16-byte vectors of a row per warp step: 2 per lane
constexpr int kUnroll = 4;

// A 16-byte load of the matrix, which is read once: not kept in L1, and
// L2 asked for the whole 256-byte piece around it (a step reads 64 bytes of
// each row; the rest arrives for the next steps).
__device__ __forceinline__ uint4 ld_stream(const uint4* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

template <int NG, int ROWS>
__global__ void __launch_bounds__(kThreads)
dense_scores_kernel(const int32_t* __restrict__ srcs, const int32_t* __restrict__ mat,
                    int32_t* __restrict__ out, int q, int r, long long w) {
  __shared__ unsigned s_out[kMaxQ * kRows];
  for (int i = threadIdx.x; i < kMaxQ * kRows; i += kThreads) s_out[i] = 0;
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // MMA group: row g and g + 8, source g of a group
  const int t = lane & 3;   // thread in group: its vector of a step
  const int row0 = blockIdx.x * ROWS;
  const int q0 = blockIdx.y * kMaxQ;
  const int qg = min(kMaxQ, q - q0);

  const long long nv = w >> 2;  // vectors per row
  const bool ra = row0 + g < r;
  const bool rb = ROWS == 16 && row0 + g + 8 < r;
  const uint4* pa = reinterpret_cast<const uint4*>(mat) + (long long)(ra ? row0 + g : 0) * nv;
  const uint4* pb = reinterpret_cast<const uint4*>(mat) + (long long)(rb ? row0 + g + 8 : 0) * nv;
  const uint4* ps[NG];
  bool sv[NG];
#pragma unroll
  for (int sg = 0; sg < NG; ++sg) {
    sv[sg] = sg * kGroup + g < qg;
    ps[sg] = reinterpret_cast<const uint4*>(srcs) + (long long)(sv[sg] ? q0 + sg * kGroup + g : 0) * nv;
  }

  // the block's warps take steps in turn, so at any moment the block reads
  // one contiguous 1 KB piece of each of its 16 rows
  const long long nsteps = (nv + kStepVecs - 1) / kStepVecs;

  unsigned acc[NG][4];
#pragma unroll
  for (int sg = 0; sg < NG; ++sg) acc[sg][0] = acc[sg][1] = acc[sg][2] = acc[sg][3] = 0;
  const uint4 zero = make_uint4(0, 0, 0, 0);

#pragma unroll kUnroll
  for (long long st = warp; st < nsteps; st += kWarps) {
#pragma unroll
    for (int h = 0; h < kStepVecs / 4; ++h) {
      const long long v = st * kStepVecs + 4 * h + t;
      const bool in = v < nv;
      const uint4 a = ra && in ? ld_stream(pa + v) : zero;
      const uint4 b = rb && in ? ld_stream(pb + v) : zero;
#pragma unroll
      for (int sg = 0; sg < NG; ++sg) {
        const uint4 s = sv[sg] && in ? __ldg(ps[sg] + v) : zero;
        mma_and_popc(acc[sg], a.x, b.x, a.y, b.y, s.x, s.y);
        mma_and_popc(acc[sg], a.z, b.z, a.w, b.w, s.z, s.w);
      }
    }
  }

  // the accumulator: [0] (row g, source 2t), [1] (row g, 2t + 1),
  // [2] (row g + 8, 2t), [3] (row g + 8, 2t + 1) of each group
#pragma unroll
  for (int sg = 0; sg < NG; ++sg) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = sg * kGroup + 2 * t + (i & 1);
      const int rl = g + 8 * (i >> 1);
      if (acc[sg][i] != 0) atomicAdd(&s_out[qi * kRows + rl], acc[sg][i]);
    }
  }
  __syncthreads();
  const int nrows = min(ROWS, r - row0);
  for (int i = threadIdx.x; i < qg * kRows; i += kThreads) {
    const int qi = i / kRows;
    const int rl = i - qi * kRows;
    if (rl < nrows) out[(long long)(q0 + qi) * r + row0 + rl] = (int32_t)s_out[i];
  }
}

template <int NG, int ROWS>
static cudaError_t launch(const int32_t* srcs, const int32_t* mat, int32_t* out, int q, int r,
                          long long w, cudaStream_t stream) {
  const dim3 grid((r + ROWS - 1) / ROWS, (q + kMaxQ - 1) / kMaxQ);
  dense_scores_kernel<NG, ROWS><<<grid, kThreads, 0, stream>>>(srcs, mat, out, q, r, w);
  return cudaGetLastError();
}

// srcs i32[q, w], mat i32[r, w], out i32[q, r]; w % 4 == 0, pointers
// 16-byte aligned (the Python wrapper checks). Returns cudaGetLastError().
extern "C" int pilosa_dense_scores(const void* srcs, const void* mat, void* out, int q,
                                   int r, long long w, int device, void* stream) {
  if (q < 1 || r < 1 || w < 4 || (w & 3)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int32_t* s = static_cast<const int32_t*>(srcs);
  const int32_t* m = static_cast<const int32_t*>(mat);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // source groups of 8 in a grid row: as many as the widest grid row needs
  const int groups = ((q < kMaxQ ? q : kMaxQ) + kGroup - 1) / kGroup;
  // Q <= 4: blocks of 8 rows (half the MMA's M idle), twice as many blocks
  // to spread the stream; wider: 16 rows, so the sources are re-read half
  // as often
  if (q <= 4) return (int)launch<1, 8>(s, m, o, q, r, w, st);
  switch (groups) {
    case 1: return (int)launch<1, 16>(s, m, o, q, r, w, st);
    case 2: return (int)launch<2, 16>(s, m, o, q, r, w, st);
    case 3: return (int)launch<3, 16>(s, m, o, q, r, w, st);
    default: return (int)launch<4, 16>(s, m, o, q, r, w, st);
  }
}
