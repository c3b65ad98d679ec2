// K3 tree_count: out[q] = popcount(tree(leaves of query q)) for a boolean
// Intersect / Union / Xor / Difference tree over same-shape leaf stacks.
//
// Replaces the XLA-jitted fused chain count of pilosa_tpu/executor/
// executor.py (_tree_count_jit, _tree_count_batch_jit over _eval_tree),
// which compiled one fusion per tree shape. Eager PyTorch would write every
// inner node's u32[S, W] result to HBM and read it back.
//
// Bound: bytes. Each DISTINCT leaf is read once (coalesced queries often
// share a staged row); the result is one int per query.
//
// Design: one kernel interprets every tree shape, so query shapes never
// multiply builds.
//  * The host sends each distinct leaf pointer once and, per query, one
//    byte per leaf naming its distinct leaf; both tables travel by value in
//    the parameter block (__grid_constant__), so a launch uploads nothing.
//  * The tree is a postfix program (uploaded once per tree shape) with a
//    peephole applied: "push leaf; op" becomes one instruction that folds
//    the leaf into the top of the stack, so a chain of one operator never
//    touches the stack. Words: op << 16 | operand, operand a query-local
//    leaf index or 0xFFFF (the entry below the top). The prologue resolves
//    every query's program against its byte table in shared memory.
//  * A persistent grid (two blocks an SM) walks word tiles. Thread 0
//    brings the tile of every distinct leaf into a 2-4 stage ring in
//    shared memory with cp.async.bulk and an mbarrier, so every leaf load
//    of a tile is in flight at once and the next stages load while this
//    one is counted; the first stages load while the block resolves its
//    programs.
//  * Each thread runs each query's program on its 16-byte vectors of the
//    tile, reading leaves from shared memory; the top of the stack is a
//    register, the entries below it per-thread slots in shared memory
//    (no local memory). Warp shuffles, then shared atomics, count a tile.
//  * No memset: each block adds its per-query counts to a per-stream
//    accumulator, and the last block (an atomic ticket) moves them to
//    out[q] and leaves the accumulator and ticket at zero for the next
//    launch on that stream. One query takes one 64-bit atomic a block,
//    its count and ticket in one word.
// The tile size follows from the distinct-leaf count so that the ring
// fits; the host raises before launching past the limits below.

#include "common.cuh"
#include "tma.cuh"

#define TC_MAX_DISTINCT 256
// queries x leaves of one launch (one byte each)
#define TC_MAX_REFS 1536
#define TC_MAX_CODE 512
// queries x program words, resolved in shared memory
#define TC_MAX_RC 3072
#define TC_MAX_SPILL 15
#define TC_STACK 0xFFFF

enum { TC_PUSH = 0, TC_AND = 1, TC_OR = 2, TC_XOR = 3, TC_ANDNOT = 4 };
// resolved instruction (u16): op in bits 0-3, bit 4 = operand is the
// stack entry below the top, bits 8-15 = distinct leaf
#define TC_RC_STACK 16

struct TcTables {
  const uint4* leaf[TC_MAX_DISTINCT];
  unsigned char ref[TC_MAX_REFS];  // ref[q * nleaves + l]: leaf l of query q
};

constexpr int kThreads = 256;
constexpr int kMaxStages = 4;
// Dynamic shared memory for the ring and the stack slots: about 100 KB,
// so two blocks share an SM (on the H100 two blocks of two stages ran the
// chain shape faster than one block of four, or of 512 threads, or than
// two vectors a thread); more only when two stages of 8 vectors of every
// distinct leaf need it. The static tables add ~12 KB; a block may have
// 227 KB.
constexpr long long kDynTarget = 100 * 1024;
constexpr long long kDynMax = 208 * 1024;
constexpr long long kMaxTile = 2048;  // vectors of one leaf in one stage

__device__ __forceinline__ uint4 tc_apply(unsigned op, uint4 a, const uint4 b) {
  if (op == TC_AND) {
    a.x &= b.x; a.y &= b.y; a.z &= b.z; a.w &= b.w;
  } else if (op == TC_OR) {
    a.x |= b.x; a.y |= b.y; a.z |= b.z; a.w |= b.w;
  } else if (op == TC_XOR) {
    a.x ^= b.x; a.y ^= b.y; a.z ^= b.z; a.w ^= b.w;
  } else {
    a.x &= ~b.x; a.y &= ~b.y; a.z &= ~b.z; a.w &= ~b.w;
  }
  return a;
}

// One query's resolved program on vector v of the tile. ``spill`` is this
// thread's first stack slot; slot k is k * kThreads vectors further.
__device__ __forceinline__ uint4 tc_run(const uint16_t* rc, int n, const uint4* tile, int tv,
                                        int v, uint4* spill) {
  uint4 top = tile[(rc[0] >> 8) * tv + v];
  int sp = 0;
  for (int pc = 1; pc < n; ++pc) {
    const unsigned ins = rc[pc];
    const unsigned op = ins & 15;
    if (ins & TC_RC_STACK) {
      --sp;
      top = tc_apply(op, spill[sp * kThreads], top);
      continue;
    }
    const uint4 b = tile[(ins >> 8) * tv + v];
    if (op == TC_PUSH) {
      spill[sp * kThreads] = top;
      ++sp;
      top = b;
    } else {
      top = tc_apply(op, top, b);
    }
  }
  return top;
}

__global__ void __launch_bounds__(kThreads)
tree_count_kernel(const __grid_constant__ TcTables tab, const int32_t* __restrict__ code,
                  int code_len, int nleaves, int ndistinct, int q, long long nv, int tv,
                  int stages, unsigned* __restrict__ scratch, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint4 dyn[];
  __shared__ uint16_t s_rc[TC_MAX_RC];
  __shared__ unsigned s_cnt[TC_MAX_REFS];
  __shared__ __align__(8) uint64_t bar[kMaxStages];
  __shared__ int s_last;
  const int tid = threadIdx.x;
  uint4* ring = dyn;
  uint4* spill = dyn + (size_t)stages * ndistinct * tv + tid;

  const long long ntiles = (nv + tv - 1) / tv;
  const int my_n =
      blockIdx.x < ntiles ? (int)((ntiles - 1 - blockIdx.x) / gridDim.x + 1) : 0;
  // my j-th tile into stage j % stages: every distinct leaf's slice
  auto issue = [&](int j) {
    const long long v0 = ((long long)blockIdx.x + (long long)j * gridDim.x) * tv;
    const unsigned bytes = (unsigned)(nv - v0 < tv ? nv - v0 : tv) * 16u;
    uint64_t* b = &bar[j % stages];
    uint4* dst = ring + (size_t)(j % stages) * ndistinct * tv;
    mbar_expect_tx(b, bytes * (unsigned)ndistinct);
    for (int d = 0; d < ndistinct; ++d) bulk_g2s(dst + (size_t)d * tv, tab.leaf[d] + v0, bytes, b);
  };
  // the first stages load while the block resolves the programs
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&bar[s], 1);
    fence_barrier_init();
    for (int j = 0; j < stages && j < my_n; ++j) issue(j);
  }
  for (int i = tid; i < q * code_len; i += kThreads) {
    const int qi = i / code_len;
    const int ins = code[i - qi * code_len];
    const int arg = ins & 0xFFFF;
    const unsigned op = (unsigned)(ins >> 16);
    s_rc[i] = (uint16_t)(arg == TC_STACK ? (op | TC_RC_STACK)
                                         : (op | ((unsigned)tab.ref[qi * nleaves + arg] << 8)));
  }
  for (int i = tid; i < q; i += kThreads) s_cnt[i] = 0;
  __syncthreads();

  for (int j = 0; j < my_n; ++j) {
    const int st = j % stages;
    mbar_wait(&bar[st], (unsigned)(j / stages) & 1u);
    const long long v0 = ((long long)blockIdx.x + (long long)j * gridDim.x) * tv;
    const int len = (int)(nv - v0 < tv ? nv - v0 : tv);
    const uint4* tile = ring + (size_t)st * ndistinct * tv;
    for (int qi = 0; qi < q; ++qi) {
      const uint16_t* rc = s_rc + qi * code_len;
      unsigned c = 0;
      for (int v = tid; v < len; v += kThreads) c += popc4(tc_run(rc, code_len, tile, tv, v, spill));
      c = warp_sum(c);
      if ((tid & 31) == 0 && c) atomicAdd(&s_cnt[qi], c);
    }
    __syncthreads();  // the stage is free again
    if (tid == 0 && j + stages < my_n) issue(j + stages);
  }
  __syncthreads();

  if (q == 1) {
    // one atomic a block: the count in the low 40 bits, a ticket above;
    // the last block's old value plus its own is the total
    if (tid == 0) {
      auto* acc = reinterpret_cast<unsigned long long*>(scratch);
      const unsigned long long old = atomicAdd(acc, (1ull << 40) + s_cnt[0]);
      if ((old >> 40) == gridDim.x - 1) {
        out[0] = (int32_t)((old + s_cnt[0]) & ((1ull << 40) - 1));
        atomicExch(acc, 0ull);
      }
    }
    return;
  }
  unsigned* ticket = scratch + 2;
  unsigned* sums = scratch + 3;
  for (int i = tid; i < q; i += kThreads)
    if (s_cnt[i]) atomicAdd(&sums[i], s_cnt[i]);
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (s_last) {
    __threadfence();
    for (int i = tid; i < q; i += kThreads) out[i] = (int32_t)atomicExch(&sums[i], 0u);
    if (tid == 0) atomicExch(ticket, 0u);
  }
}

static int g_sms[64];
static bool g_attr[64];

// leaf_ptrs: HOST u64[ndistinct] device pointers to 16-byte aligned int32
// leaves of n_words words each (n_words % 4 == 0, > 0); refs: HOST
// u8[q * nleaves] (query-major) distinct-leaf indexes; code: device
// i32[code_len] peephole postfix program needing max_spill stack slots;
// scratch: device u32[3 + TC_MAX_REFS], 8-byte aligned (a u64 for one
// query, the ticket, the sums), zero before the first launch on its
// stream and left zero by every launch; out: i32[q], written whole.
// Returns cudaGetLastError(), or cudaErrorInvalidValue past the limits.
extern "C" int pilosa_tree_count(const unsigned long long* leaf_ptrs, const unsigned char* refs,
                                 int ndistinct, const void* code, int code_len, int max_spill,
                                 int nleaves, long long n_words, int q, void* scratch, void* out,
                                 int device, void* stream) {
  if (ndistinct < 1 || ndistinct > TC_MAX_DISTINCT || nleaves < 1 || q < 1 ||
      (long long)q * nleaves > TC_MAX_REFS || code_len < 1 || code_len > TC_MAX_CODE ||
      (long long)q * code_len > TC_MAX_RC || max_spill < 0 || max_spill > TC_MAX_SPILL ||
      n_words < 4 || (n_words & 3) || device < 0 || device >= 64)
    return (int)cudaErrorInvalidValue;
  TcTables tab;
  for (int i = 0; i < ndistinct; ++i) tab.leaf[i] = reinterpret_cast<const uint4*>(leaf_ptrs[i]);
  for (int i = 0; i < q * nleaves; ++i) {
    if (refs[i] >= ndistinct) return (int)cudaErrorInvalidValue;
    tab.ref[i] = refs[i];
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (!g_attr[device]) {
    e = cudaDeviceGetAttribute(&g_sms[device], cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(tree_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kDynMax);
    if (e != cudaSuccess) return (int)e;
    g_attr[device] = true;
  }
  const long long nv = n_words >> 2;
  const long long spill_bytes = (long long)max_spill * kThreads * 16;
  const long long per_vec = (long long)ndistinct * 16;
  long long budget = kDynTarget - spill_bytes;
  if (budget < 2 * 8 * per_vec) budget = 2 * 8 * per_vec;
  if (budget + spill_bytes > kDynMax) return (int)cudaErrorInvalidValue;
  // about four tiles an SM, at least one vector a thread (each block adds
  // two same-address atomics), and room for two stages of every distinct
  // leaf
  long long tv = (nv + 4LL * g_sms[device] - 1) / (4LL * g_sms[device]);
  if (tv < kThreads) tv = kThreads;
  if (tv > kMaxTile) tv = kMaxTile;
  if (tv > budget / (2 * per_vec)) tv = budget / (2 * per_vec);
  tv = tv >= kThreads ? tv / kThreads * kThreads : tv / 8 * 8;
  long long stages = budget / (tv * per_vec);
  if (stages > kMaxStages) stages = kMaxStages;
  const size_t dyn = (size_t)(stages * tv * per_vec + spill_bytes);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tree_count_kernel, kThreads, dyn);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) per_sm = 1;
  const long long ntiles = (nv + tv - 1) / tv;
  long long grid = (long long)g_sms[device] * per_sm;
  if (grid > ntiles) grid = ntiles;
  tree_count_kernel<<<(unsigned)grid, kThreads, dyn, static_cast<cudaStream_t>(stream)>>>(
      tab, static_cast<const int32_t*>(code), code_len, nleaves, ndistinct, q, nv, (int)tv,
      (int)stages, static_cast<unsigned*>(scratch), static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
