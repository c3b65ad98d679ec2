// K5 bsi_range: one Range(field <op> value) row from a BSI plane stack.
//
// Replaces pilosa_tpu/ops/bsi.py bsi_range_eq / _neq / _lt / _gt / _between
// (XLA-jitted and vmapped over the shard stack by the JAX executor). Eager
// PyTorch would launch about five ops per plane and write each intermediate
// to HBM.
//
// Bound: bytes. Each plane word the program reads is read once, and one
// output word is written per column word.
//
// Design: the recurrences' scalar state (leading zeros, the early return at
// plane 0, the predicate bits) depends only on the predicate, so the host
// turns it into one opcode byte per plane (ops/bsi.py range_program): the
// low nibble runs first, then the high nibble, each one of
//   1 b &= row            2 b &= ~row
//   3 b &= ~(b & ~row & ~k1)   4 k1 |= b & row        (greater-than side)
//   5 b &= ~(row & ~k2)        6 k2 |= b & ~row       (less-than side)
// and an output selector picks b, k1, k2 or not-null & ~b. The program
// travels by value in the parameter block. Each thread walks 16-byte vectors
// of the [S, W] output in a grid-stride loop, starts from the not-null plane,
// reads each plane the program touches once, from the plane stack in place
// (shard and plane strides), and writes one vector. A plane whose byte is 0
// is never read.

#include "common.cuh"

#define BR_MAX_DEPTH 63

struct RangeProg {
  unsigned char code[64];  // code[i]: the ops of plane i (i < depth)
  int depth;
  int out_sel;  // 0 b, 1 k1, 2 k2, 3 not-null & ~b
};

constexpr int kThreads = 256;

__device__ __forceinline__ void step1(int op, unsigned& b, unsigned& k1, unsigned& k2,
                                      const unsigned row) {
  switch (op) {
    case 1: b &= row; break;
    case 2: b &= ~row; break;
    case 3: b &= ~(b & ~row & ~k1); break;
    case 4: k1 |= b & row; break;
    case 5: b &= ~(row & ~k2); break;
    case 6: k2 |= b & ~row; break;
    default: break;
  }
}

__device__ __forceinline__ void apply(int op, uint4& b, uint4& k1, uint4& k2, const uint4 row) {
  step1(op, b.x, k1.x, k2.x, row.x);
  step1(op, b.y, k1.y, k2.y, row.y);
  step1(op, b.z, k1.z, k2.z, row.z);
  step1(op, b.w, k1.w, k2.w, row.w);
}

__global__ void __launch_bounds__(kThreads)
bsi_range_kernel(const uint4* __restrict__ planes, long long plane_stride, long long shard_stride,
                 long long wv, long long nv, uint4* __restrict__ out, const RangeProg prog) {
  for (long long v = (long long)blockIdx.x * kThreads + threadIdx.x; v < nv;
       v += (long long)gridDim.x * kThreads) {
    const long long s = v / wv;
    const uint4* base = planes + s * shard_stride + (v - s * wv);
    const uint4 nn = __ldcs(base + (long long)prog.depth * plane_stride);
    uint4 b = nn;
    uint4 k1 = make_uint4(0u, 0u, 0u, 0u);
    uint4 k2 = k1;
    for (int i = prog.depth - 1; i >= 0; --i) {
      const int op = prog.code[i];
      if (op == 0) continue;
      const uint4 row = __ldcs(base + (long long)i * plane_stride);
      apply(op & 15, b, k1, k2, row);
      apply(op >> 4, b, k1, k2, row);
    }
    uint4 r;
    if (prog.out_sel == 1) {
      r = k1;
    } else if (prog.out_sel == 2) {
      r = k2;
    } else if (prog.out_sel == 3) {
      r = make_uint4(nn.x & ~b.x, nn.y & ~b.y, nn.z & ~b.z, nn.w & ~b.w);
    } else {
      r = b;
    }
    out[v] = r;
  }
}

// planes: device int32 [s, depth+1, wv*4] viewed through plane_stride and
// shard_stride (16-byte vectors); out: device int32 [s, wv*4] contiguous;
// prog: HOST pointer to the program. Returns cudaGetLastError(), or
// cudaErrorInvalidValue past the limits.
extern "C" int pilosa_bsi_range(const void* planes, long long plane_stride,
                                long long shard_stride, long long s, long long wv, void* out,
                                const RangeProg* prog, int device, void* stream) {
  if (prog->depth < 0 || prog->depth > BR_MAX_DEPTH || prog->out_sel < 0 || prog->out_sel > 3 ||
      s < 1 || wv < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const long long nv = s * wv;
  long long blocks = (nv + kThreads - 1) / kThreads;
  if (blocks > (long long)sms * 16) blocks = (long long)sms * 16;
  if (blocks < 1) blocks = 1;
  bsi_range_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(planes), plane_stride, shard_stride, wv, nv,
      static_cast<uint4*>(out), *prog);
  return (int)cudaGetLastError();
}
