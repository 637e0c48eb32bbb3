// The per-step winner exchange between the blocks of n shards: each block
// publishes its sorted top-W list of 64-bit keys (topk.cuh: score bits
// high, inverted global index low) into its own outbox, waits until every
// peer has published the same step, and merges the n lists into the
// global top-W.
//
// Replaces the exchange of gasr_tpu/ops/pallas/fused_decode.py::
// _tp_scan_kernel (remote DMAs into every peer's 2-slot receive buffer,
// DMA semaphores, `_merge2_top` fold) and of exchange_probe.py::
// _toy_kernel, which carries the same skeleton around a toy body.
//
// Transport: pull, not push. Shard s's block g writes its list once, into
// outbox[s][par][g] (par = step & 1), and raises flags[s][g] to the step;
// each peer reads it from there. The outboxes and flags may lie on the
// card the block runs on or, through peer pointers, on another card of
// the host. The wrapper hands in flags zeroed for each call; a flag
// holding the step number needs no reset between steps. Every block with
// the same g walks the same utterances in the same order on every shard,
// so step numbers agree.
//
// Memory order. Publish: every thread stores its share of the list; a
// block barrier; thread 0 fences (__threadfence_system) and stores the
// flag with st.release.sys. Wait: one thread per peer spins on the peer's
// flag with ld.acquire.sys, then a block barrier; the payload is read with
// ld.relaxed.sys (strong loads: never a stale L1 line of an earlier step).
//
// Two parity slots suffice. At step t a block writes slot par(t), which
// held its step t-2 payload. Every peer has finished reading that payload:
// the writer passed its step t-1 wait, so every peer had published step
// t-1, and a peer publishes step t-1 only after it merged step t-2, whose
// reads precede its release store.
//
// Co-residency: a block spins until the blocks of its group on every other
// shard have published, so all of them must be resident at once. The
// kernels are launched cooperatively on a persistent grid no larger than
// the card holds; a larger grid is refused at launch, never run.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "topk.cuh"

namespace gasr {
namespace xchg {

struct Exchange {
  unsigned long long* const* outbox;   // [n] -> [2][G][W] keys
  unsigned* const* flags;              // [n] -> [G] published step
  int n;                               // shards in the group
  int G;                               // blocks per shard
  int W;                               // keys per list (<= kListLen)
};

__device__ __forceinline__ unsigned ld_acquire_sys(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ld_relaxed_sys(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.sys.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long* slot(const Exchange& x, int s,
                                                    int g, unsigned step) {
  return x.outbox[s] + ((size_t)(step & 1u) * x.G + g) * x.W;
}

// Every thread of the block: publish list[0, W) (shared memory) as shard
// s's step `step`, then wait until every peer has published it.
__device__ __forceinline__ void publish_and_wait(
    const Exchange& x, int s, int g, unsigned step,
    const unsigned long long* list) {
  unsigned long long* out = slot(x, s, g, step);
  for (int k = threadIdx.x; k < x.W; k += blockDim.x) out[k] = list[k];
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    st_release_sys(x.flags[s] + g, step);
  }
  for (int p = threadIdx.x; p < x.n; p += blockDim.x) {
    if (p == s) continue;
    const unsigned* f = x.flags[p] + g;
    while (ld_acquire_sys(f) < step) __nanosleep(32);
  }
  __syncthreads();
}

// Warp 0: list[0, kListLen) := the largest keys of the n published lists
// (its own from `list`, the peers' from their outboxes), descending; W of
// them from each list, key 0 (below every real key) in the rest. Ends with
// a block barrier.
__device__ __forceinline__ void merge(const Exchange& x, int s, int g,
                                      unsigned step,
                                      unsigned long long* list) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    unsigned long long acc[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int e = 32 * r + lane;
      acc[r] = e < x.W ? list[e] : 0ull;
    }
    for (int p = 0; p < x.n; ++p) {
      if (p == s) continue;
      const unsigned long long* in = slot(x, p, g, step);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = 32 * r + lane;
        b[r] = e < x.W ? ld_relaxed_sys(in + e) : 0ull;
      }
      warp_merge128(acc, b);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) list[32 * r + lane] = acc[r];
  }
  __syncthreads();
}

// How many blocks of `kernel` the current card holds at once.
inline cudaError_t resident_blocks(const void* kernel, int threads,
                                   size_t smem, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  *blocks = err == cudaSuccess ? per_sm * sms : 0;
  return err;
}

}  // namespace xchg
}  // namespace gasr
