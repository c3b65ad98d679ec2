// K3 tree_count: out[q] = popcount(tree(leaves of query q)) for a boolean
// Intersect / Union / Xor / Difference tree over same-shape leaf stacks.
//
// Replaces the XLA-jitted fused chain count of pilosa_tpu/executor/
// executor.py (_tree_count_jit, _tree_count_batch_jit over _eval_tree),
// which compiled one fusion per tree shape. Eager PyTorch would write every
// inner node's u32[S, W] result to HBM and read it back.
//
// Bound: bytes. Each leaf is read once (nleaves * S * W * 4 bytes per
// query); the result is one int per query.
//
// Design: one kernel interprets every tree shape, so query shapes never
// multiply builds. The host lowers the tree to a postfix program (leaf
// index >= 0 pushes that leaf's vector; -1..-4 combine the top two with
// AND, OR, XOR, AND-NOT, uploaded once per tree shape) and passes the
// leaves' device pointers by value in the kernel's parameter block, so a
// launch uploads nothing. A block copies the program and its query's
// pointers into shared memory; each
// thread then walks 16-byte word vectors in a grid-stride loop, runs the
// program on a small stack of vectors, and popcounts the result. A warp
// shuffle and one pass over shared memory reduce the block, and one
// atomicAdd per block adds it to out[q] (grid.y is the query). Inner-node
// results live only in registers and the thread's stack. The host raises
// before launching a program past the limits below.

#include "common.cuh"

#define TC_MAX_STACK 16
#define TC_MAX_CODE 512
#define TC_MAX_LEAVES 256
// Leaf pointers of one launch (queries x leaves), passed by value: 3.5 KiB
// of the 4 KiB kernel parameter block.
#define TC_MAX_PTRS 448

struct LeafPtrs {
  const uint4* p[TC_MAX_PTRS];
};

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocksPerQuery = 1024;

__global__ void __launch_bounds__(kThreads)
tree_count_kernel(const LeafPtrs leaf_ptrs, const int32_t* __restrict__ code, int code_len, int nleaves, long long nv,
                  int32_t* __restrict__ out) {
  __shared__ int32_t s_code[TC_MAX_CODE];
  __shared__ const uint4* s_leaf[TC_MAX_LEAVES];
  __shared__ unsigned part[kWarps];
  const int qi = blockIdx.y;
  for (int i = threadIdx.x; i < code_len; i += kThreads) s_code[i] = code[i];
  for (int i = threadIdx.x; i < nleaves; i += kThreads)
    s_leaf[i] = leaf_ptrs.p[qi * nleaves + i];
  __syncthreads();

  unsigned cnt = 0;
  uint4 stack[TC_MAX_STACK];
  for (long long v = (long long)blockIdx.x * kThreads + threadIdx.x; v < nv;
       v += (long long)gridDim.x * kThreads) {
    int sp = 0;
    for (int pc = 0; pc < code_len; ++pc) {
      const int ins = s_code[pc];
      if (ins >= 0) {
        stack[sp++] = __ldg(s_leaf[ins] + v);
        continue;
      }
      const uint4 b = stack[--sp];
      uint4 a = stack[sp - 1];
      if (ins == -1) {
        a.x &= b.x; a.y &= b.y; a.z &= b.z; a.w &= b.w;
      } else if (ins == -2) {
        a.x |= b.x; a.y |= b.y; a.z |= b.z; a.w |= b.w;
      } else if (ins == -3) {
        a.x ^= b.x; a.y ^= b.y; a.z ^= b.z; a.w ^= b.w;
      } else {
        a.x &= ~b.x; a.y &= ~b.y; a.z &= ~b.z; a.w &= ~b.w;
      }
      stack[sp - 1] = a;
    }
    cnt += popc4(stack[0]);
  }
  const unsigned t = warp_sum(cnt);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = t;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned total = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) total += part[k];
    if (total != 0) atomicAdd(out + qi, (int)total);
  }
}

// leaf_ptrs: HOST u64[q * nleaves] (query-major) device pointers to
// 16-byte aligned int32 leaves of n_words words each (n_words % 4 == 0);
// code: device i32[code_len] postfix program; out: i32[q] zeroed by the
// caller. Returns cudaGetLastError(), or cudaErrorInvalidValue past the
// limits.
extern "C" int pilosa_tree_count(const unsigned long long* leaf_ptrs, const void* code,
                                 int code_len, int nleaves, long long n_words, int q, void* out,
                                 int device, void* stream) {
  if (code_len < 1 || code_len > TC_MAX_CODE || nleaves < 1 || nleaves > TC_MAX_LEAVES ||
      q < 1 || (long long)q * nleaves > TC_MAX_PTRS || (n_words & 3))
    return (int)cudaErrorInvalidValue;
  LeafPtrs ptrs = {};
  for (int i = 0; i < q * nleaves; ++i) ptrs.p[i] = reinterpret_cast<const uint4*>(leaf_ptrs[i]);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long nv = n_words >> 2;
  long long blocks = (nv + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocksPerQuery) blocks = kMaxBlocksPerQuery;
  if (blocks < 1) blocks = 1;
  const dim3 grid((unsigned)blocks, q);
  tree_count_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ptrs, static_cast<const int32_t*>(code), code_len, nleaves, nv, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
