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
// The program: the recurrences' scalar state (leading zeros, the early
// return at plane 0, the predicate bits) depends only on the predicate, so
// the host turns it into one opcode byte per plane (ops/bsi.py
// range_program): the low nibble runs first, then the high nibble, each
// one of
//   1 b &= row            2 b &= ~row
//   3 b &= ~(b & ~row & ~k1)   4 k1 |= b & row        (greater-than side)
//   5 b &= ~(row & ~k2)        6 k2 |= b & ~row       (less-than side)
// and an output selector picks b, k1, k2 or not-null & ~b. The entry point
// lists the planes whose byte is not 0, high to low; no other plane is read.
//
// What bounds it on this card: HBM is kept busy only by bytes in flight.
// The earlier design carried one 16-byte vector a thread through a loop
// with one load a plane, each behind a runtime opcode test, so a thread had
// about one load in flight, and at ssb's 58 x 32768 words the launch ran in
// 1.76 waves of blocks: a pass over 2 planes took 0.0385 ms against 0.0068
// of bytes, and 25 planes ran at 62 % of their bound.
//
// Design: a persistent grid (two CTAs an SM, from the occupancy query,
// times the SMs) in which CTA b owns a contiguous run of the S x W/4
// vectors, walked as column tiles of up to 1024 vectors (16 KiB) that never
// cross a shard. A producer warp's elected lane streams each tile's
// not-null plane and then every plane the program reads, one plane-tile a
// slot, through a ring of 6 slots (96 KiB) in shared memory with
// cp.async.bulk; each slot has a "full" mbarrier (the copy's bytes) and an
// "empty" one (one arrival from each consumer warp that has read it). The
// producer runs ahead across tiles as far as the ring goes, so the bytes
// in flight are the ring's (192 KiB an SM), whatever the registers, the
// waves or the depth. Eight consumer warps keep a tile's b, k1, k2 and
// not-null in registers (4 vectors a thread), run each opcode nibble over
// all 4 in one branch as its slot lands, and write the tile with 16-byte
// streaming stores. The tile is fixed: on the card, 16 KiB slots beat
// 8 KiB and 4 KiB ones at every depth (smaller slots cost the consumers
// more per byte than a ring holding two tiles gains; see PERF.md).

#include <atomic>

#include "common.cuh"
#include "tma.cuh"

#define BR_MAX_DEPTH 63

struct RangeProg {
  unsigned char code[64];  // code[i]: the ops of plane i (i < depth)
  int depth;
  int out_sel;  // 0 b, 1 k1, 2 k2, 3 not-null & ~b
};

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kTile = 1024;                // vectors a slot holds: 16 KiB
constexpr int kVpt = kTile / kConsumers;   // vectors a consumer thread holds
constexpr int kSlots = 6;                  // the ring: 96 KiB a CTA
constexpr int kCtasPerSm = 2;

struct RangeParams {
  const uint4* planes;
  long long plane_stride;  // in 16-byte vectors
  long long shard_stride;
  long long wv;            // vectors per shard
  long long nv;            // S x wv
  long long per_cta;       // vectors a CTA owns
  uint4* out;              // [nv], contiguous
  int depth;               // plane ``depth`` is not-null
  int nread;               // planes the program reads
  int out_sel;
  unsigned char plane[64];  // the r-th plane read, high to low
  unsigned char op[64];     // its opcode byte
};

// A thread's j-th vector of the slot ``src`` (0 past the tile's ``n``:
// such a vector is never stored).
__device__ __forceinline__ uint4 slot_vec(const uint4* src, int j, int t, int n) {
  const int idx = j * kConsumers + t;
  return idx < n ? src[idx] : make_uint4(0u, 0u, 0u, 0u);
}

// One opcode nibble over a thread's vectors of a slot: the branch is taken
// once a plane (the opcode is the same in every thread), not per word.
__device__ __forceinline__ void run_op(int op, uint4 (&b)[kVpt], uint4 (&k1)[kVpt],
                                       uint4 (&k2)[kVpt], const uint4* src, int t, int n) {
  switch (op) {
    case 1:
#pragma unroll
      for (int j = 0; j < kVpt; ++j) {
        const uint4 r = slot_vec(src, j, t, n);
        b[j] = make_uint4(b[j].x & r.x, b[j].y & r.y, b[j].z & r.z, b[j].w & r.w);
      }
      break;
    case 2:
#pragma unroll
      for (int j = 0; j < kVpt; ++j) {
        const uint4 r = slot_vec(src, j, t, n);
        b[j] = make_uint4(b[j].x & ~r.x, b[j].y & ~r.y, b[j].z & ~r.z, b[j].w & ~r.w);
      }
      break;
    case 3:  // b &= ~(b & ~row & ~k1), that is b &= row | k1
#pragma unroll
      for (int j = 0; j < kVpt; ++j) {
        const uint4 r = slot_vec(src, j, t, n);
        b[j] = make_uint4(b[j].x & (r.x | k1[j].x), b[j].y & (r.y | k1[j].y),
                          b[j].z & (r.z | k1[j].z), b[j].w & (r.w | k1[j].w));
      }
      break;
    case 4:
#pragma unroll
      for (int j = 0; j < kVpt; ++j) {
        const uint4 r = slot_vec(src, j, t, n);
        k1[j] = make_uint4(k1[j].x | (b[j].x & r.x), k1[j].y | (b[j].y & r.y),
                           k1[j].z | (b[j].z & r.z), k1[j].w | (b[j].w & r.w));
      }
      break;
    case 5:  // b &= ~(row & ~k2), that is b &= ~row | k2
#pragma unroll
      for (int j = 0; j < kVpt; ++j) {
        const uint4 r = slot_vec(src, j, t, n);
        b[j] = make_uint4(b[j].x & (~r.x | k2[j].x), b[j].y & (~r.y | k2[j].y),
                          b[j].z & (~r.z | k2[j].z), b[j].w & (~r.w | k2[j].w));
      }
      break;
    case 6:
#pragma unroll
      for (int j = 0; j < kVpt; ++j) {
        const uint4 r = slot_vec(src, j, t, n);
        k2[j] = make_uint4(k2[j].x | (b[j].x & ~r.x), k2[j].y | (b[j].y & ~r.y),
                           k2[j].z | (b[j].z & ~r.z), k2[j].w | (b[j].w & ~r.w));
      }
      break;
    default:
      break;
  }
}

// The tile of the CTA's run that starts at flat vector ``cur``: its shard,
// its first vector in the shard and its length (never past the shard).
__device__ __forceinline__ void tile_at(const RangeParams& p, long long cur, long long end,
                                        long long& shard, long long& off, int& n) {
  shard = cur / p.wv;
  off = cur - shard * p.wv;
  long long m = end - cur;
  if (m > p.wv - off) m = p.wv - off;
  n = m < kTile ? (int)m : kTile;
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
bsi_range_kernel(const __grid_constant__ RangeParams p) {
  extern __shared__ __align__(128) uint4 ring[];
  __shared__ __align__(8) uint64_t full[kSlots];
  __shared__ __align__(8) uint64_t empty[kSlots];
  const int t = threadIdx.x;
  const long long start = (long long)blockIdx.x * p.per_cta;
  const long long end = start + p.per_cta < p.nv ? start + p.per_cta : p.nv;
  if (t == 0) {
    for (int i = 0; i < kSlots; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (t >= kConsumers) {  // the producer warp; one lane issues every copy
    if (t != kConsumers) return;
    int slot = 0;
    unsigned phase = 1u;  // the first round finds every slot free
    long long shard, off;
    int n;
    for (long long cur = start; cur < end; cur += n) {
      tile_at(p, cur, end, shard, off, n);
      const uint4* src = p.planes + shard * p.shard_stride + off;
      const unsigned bytes = (unsigned)n * 16u;
      for (int r = -1; r < p.nread; ++r) {
        const int plane = r < 0 ? p.depth : p.plane[r];
        mbar_wait(&empty[slot], phase);
        mbar_expect_tx(&full[slot], bytes);
        bulk_g2s(ring + slot * kTile, src + (long long)plane * p.plane_stride, bytes, &full[slot]);
        if (++slot == kSlots) {
          slot = 0;
          phase ^= 1u;
        }
      }
    }
    return;
  }

  const int lane = t & 31;
  int slot = 0;
  unsigned phase = 0u;
  long long shard, off;
  int n;
  for (long long cur = start; cur < end; cur += n) {
    tile_at(p, cur, end, shard, off, n);
    uint4 nn[kVpt], b[kVpt], k1[kVpt], k2[kVpt];
    for (int r = -1; r < p.nread; ++r) {
      mbar_wait(&full[slot], phase);
      const uint4* src = ring + slot * kTile;
      if (r < 0) {
#pragma unroll
        for (int j = 0; j < kVpt; ++j) {
          nn[j] = slot_vec(src, j, t, n);
          b[j] = nn[j];
          k1[j] = make_uint4(0u, 0u, 0u, 0u);
          k2[j] = k1[j];
        }
      } else {
        const int op = p.op[r];
        run_op(op & 15, b, k1, k2, src, t, n);
        run_op(op >> 4, b, k1, k2, src, t, n);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
      if (++slot == kSlots) {
        slot = 0;
        phase ^= 1u;
      }
    }
    uint4* dst = p.out + cur;
#pragma unroll
    for (int j = 0; j < kVpt; ++j) {
      const int idx = j * kConsumers + t;
      if (idx < n) {
        uint4 r;
        if (p.out_sel == 1) {
          r = k1[j];
        } else if (p.out_sel == 2) {
          r = k2[j];
        } else if (p.out_sel == 3) {
          r = make_uint4(nn[j].x & ~b[j].x, nn[j].y & ~b[j].y, nn[j].z & ~b[j].z,
                         nn[j].w & ~b[j].w);
        } else {
          r = b[j];
        }
        __stcs(dst + idx, r);
      }
    }
  }
}

constexpr int kRingBytes = kSlots * kTile * 16;

// CTAs of the persistent grid per device, 0 until first asked there;
// callers on several threads may race to fill it with one value.
static std::atomic<int> g_grid[64];

static cudaError_t grid_size(int device, int* grid) {
  *grid = g_grid[device].load(std::memory_order_acquire);
  if (*grid > 0) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(bsi_range_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
  if (e != cudaSuccess) return e;
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bsi_range_kernel, kThreads,
                                                    kRingBytes);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = per_sm * sms;
  g_grid[device].store(*grid, std::memory_order_release);
  return cudaSuccess;
}

// planes: device int32 [s, depth+1, wv*4] viewed through plane_stride and
// shard_stride (16-byte vectors, 16-byte aligned); out: device int32
// [s, wv*4] contiguous; prog: HOST pointer to the program. Returns
// cudaGetLastError(), or cudaErrorInvalidValue past the limits.
extern "C" int pilosa_bsi_range(const void* planes, long long plane_stride,
                                long long shard_stride, long long s, long long wv, void* out,
                                const RangeProg* prog, int device, void* stream) {
  if (prog->depth < 0 || prog->depth > BR_MAX_DEPTH || prog->out_sel < 0 || prog->out_sel > 3 ||
      s < 1 || wv < 1 || device < 0 || device >= 64)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  int grid = 0;
  e = grid_size(device, &grid);
  if (e != cudaSuccess) return (int)e;
  RangeParams prm;
  prm.planes = static_cast<const uint4*>(planes);
  prm.plane_stride = plane_stride;
  prm.shard_stride = shard_stride;
  prm.wv = wv;
  prm.nv = s * wv;
  // no CTA with less than a vector a consumer thread
  const long long most = (prm.nv + kConsumers - 1) / kConsumers;
  if (grid > most) grid = (int)most;
  prm.per_cta = (prm.nv + grid - 1) / grid;
  prm.out = static_cast<uint4*>(out);
  prm.depth = prog->depth;
  prm.nread = 0;
  for (int i = prog->depth - 1; i >= 0; --i) {
    if (prog->code[i] == 0) continue;
    prm.plane[prm.nread] = (unsigned char)i;
    prm.op[prm.nread] = prog->code[i];
    ++prm.nread;
  }
  prm.out_sel = prog->out_sel;
  bsi_range_kernel<<<(unsigned)grid, kThreads, kRingBytes,
                     static_cast<cudaStream_t>(stream)>>>(prm);
  return (int)cudaGetLastError();
}
