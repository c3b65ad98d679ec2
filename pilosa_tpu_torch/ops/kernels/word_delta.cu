// K7 word_delta: per-word OR / AND-NOT masks patched into a staged tensor.
//
// Replaces pilosa_tpu/ops/delta.py apply_word_updates (flat indexes) and
// apply_word_updates_2d ((shard, word) coordinates), XLA jit scatters:
// out[f] = (words[f] | or[k]) & ~andnot[k] at f = shard * m + word, an update
// outside [0, s) x [0, m) dropped (the padding of the JAX contract). The
// indexes are unique (ops/delta.py coalesce_bit_updates), so no two threads
// write one word.
//
// Bound: bytes. The stager patches a staged tensor in place when no reader
// holds it (executor/stager.py), so the work is the patch: 12 bytes of
// updates per word (16 with a shard index) plus the 32-byte sector of each touched word read and
// written. When a reader holds the snapshot the wrapper first copies the
// whole block device to device (read once, written once), and that copy
// dominates: 512 MiB for the dense 4096-row chunk.
//
// Design: one thread per update in a grid-stride loop. Each thread reads its
// word from the source and writes it to the output, which may be the same
// buffer (the updates are unique, so no word is read after another thread
// wrote it). On the copy route the copy is the wrapper's one cudaMemcpyAsync.

#include "common.cuh"

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
word_delta_kernel(const unsigned* __restrict__ src, unsigned* __restrict__ out,
                  const int* __restrict__ shard_idx, const int* __restrict__ word_idx,
                  const unsigned* __restrict__ or_mask,
                  const unsigned* __restrict__ andnot_mask, long long k, long long s,
                  long long m) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < k;
       i += (long long)gridDim.x * kThreads) {
    const long long w = word_idx[i];
    const long long sh = shard_idx != nullptr ? (long long)shard_idx[i] : 0;
    if (w < 0 || w >= m || sh < 0 || sh >= s) continue;
    const long long f = sh * m + w;
    out[f] = (src[f] | or_mask[i]) & ~andnot_mask[i];
  }
}

// src, out: device int32 [s, m] (may be the same buffer); shard_idx (or
// null: every update in shard 0), word_idx, or_mask, andnot_mask: device
// int32 [k]. Returns cudaGetLastError().
extern "C" int pilosa_word_delta(const void* src, void* out, const void* shard_idx,
                                 const void* word_idx, const void* or_mask,
                                 const void* andnot_mask, long long k, long long s, long long m,
                                 int device, void* stream) {
  if (k < 0 || s < 0 || m < 0) return (int)cudaErrorInvalidValue;
  if (k == 0) return (int)cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  long long blocks = (k + kThreads - 1) / kThreads;
  if (blocks > (long long)sms * 16) blocks = (long long)sms * 16;
  word_delta_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(src), static_cast<unsigned*>(out),
      static_cast<const int*>(shard_idx), static_cast<const int*>(word_idx),
      static_cast<const unsigned*>(or_mask), static_cast<const unsigned*>(andnot_mask), k, s, m);
  return (int)cudaGetLastError();
}
