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
