// Helpers shared by the packed-word kernels. Words are the int32 views of
// little-endian u32 bitmap words; the kernels only read bit patterns.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// popcount(a & b) over one 16-byte vector (4 words).
__device__ __forceinline__ unsigned popc_and(const uint4 a, const uint4 b) {
  return __popc(a.x & b.x) + __popc(a.y & b.y) + __popc(a.z & b.z) +
         __popc(a.w & b.w);
}

__device__ __forceinline__ unsigned popc4(const uint4 a) {
  return __popc(a.x) + __popc(a.y) + __popc(a.z) + __popc(a.w);
}

// Sum over the 32 lanes of a warp; every lane must call it.
__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// d += popcount(a & b) over 256 bits for a 16 x 8 tile (mma.sync
// m16n8k256 .b1 .and.popc): a0/a2 row g, a1/a3 row g + 8, b0/b1 column g
// of lane (g, t), at its two k words.
__device__ __forceinline__ void mma_and_popc(unsigned (&d)[4], unsigned a0, unsigned a1,
                                             unsigned a2, unsigned a3, unsigned b0,
                                             unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
