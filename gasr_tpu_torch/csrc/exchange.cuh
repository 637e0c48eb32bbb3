// The per-frame winner exchange of the vocab-sharded decode: each of the n
// shards of a group holds its sorted top-W list of 64-bit keys (topk.cuh:
// score bits high, inverted global index low; unique across the shards),
// and every shard needs the W largest keys of the n lists. One merge, two
// transports that bring the peers' lists to it.
//
// Replaces the exchange of gasr_tpu/ops/pallas/fused_decode.py::
// _tp_scan_kernel (remote DMAs into every peer's 2-slot receive buffer,
// DMA semaphores, `_merge2_top` fold) and of exchange_probe.py::
// _toy_kernel, which carries the same skeleton around a toy body.
//
// Merge (`merge`): a rank merge over the whole block. An element's place
// in the union is its place in its own list plus, in every other list,
// the count of larger keys (a binary search of at most 7 steps); the W
// elements of place < W are the result, each written once, with its
// origin (list * W + position) beside it. All n * W elements are ranked
// at once, no warp merges alone. The lists are ranked in folds of at most
// kFoldLists (the running top-W is the first list of every later fold),
// so shared memory stays bounded at any n.
//
// Cluster transport (`SharedBoxes`): the n shards of one utterance are
// the n blocks of a thread-block cluster on one card. Each block keeps
// its inboxes in its own shared memory, and a peer writes its list into
// them through distributed shared memory (mapa + st.relaxed.cluster),
// in the tagged words described below; the reader spins on its own
// shared memory. No device memory, fence, cluster barrier or cooperative
// launch: the hardware schedules a cluster's blocks together, and one
// cluster barrier after the inboxes are zeroed (and one before a block
// exits) is all the cluster synchronises.
//
// Push transport (`DeviceBoxes`): for a group that spans cards, or more
// shards than a cluster holds. Each block writes its list straight into
// every peer's inbox on the peer's card (peer pointers over NVLink).
//
// Both carry the list in 8-byte words that hold the step beside the data,
// as NCCL's LL protocol does:
// word 2k = step << 32 | key_k >> 32, word 2k + 1 = step << 32 | (key_k &
// 0xffffffff). Each word is one naturally aligned 8-byte strong store
// (st.relaxed.sys to device memory, st.relaxed.cluster to a peer's shared
// memory), which the PTX memory model performs single-copy atomically, so
// a reader that sees the step in a word sees its data. The reader spins
// (strong loads, never a stale L1 line) on its own memory until every
// word of every peer carries the step: no flag, no __threadfence_system,
// one remote write a word and no remote read.
//   Two slots suffice. At step t, writer p writes slot t & 1 of reader
// q's inbox, which held p's step t - 2 list. q has read it: p reached
// step t only after its step t - 1 wait saw q's step t - 1 words, which q
// stores only after its step t - 2 gather, whose loads all returned (the
// spin read every word's step) and fed the merge before q's update.
// Step numbers start at 1 in zeroed inboxes, and a stale word holds step
// t - 2, never t. Every block walks its utterances in the same order on
// every shard, so step numbers agree. In the push design a block spins on
// blocks that the hardware does not schedule with it, so the grid is
// persistent and launched cooperatively on each card.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk.cuh"

namespace gasr {
namespace xchg {

constexpr int kFoldLists = 16;   // lists a fold of the merge ranks at once

// The merge's shared memory: a fold's keys and their origins, rounded up
// to 16 bytes (what follows it may hold 8-byte words).
__host__ __device__ inline size_t merge_bytes(int n, int W) {
  const int L = n < kFoldLists ? n : kFoldLists;
  return ((size_t)L * W * (sizeof(unsigned long long) + sizeof(int)) + 15) &
         ~(size_t)15;
}

struct Merge {
  unsigned long long* key;   // [L * W] a fold's lists
  int* org;                  // [L * W] their origins
};

// base: 16-byte aligned.
__device__ __forceinline__ Merge carve_merge(void* base, int n, int W) {
  const int L = n < kFoldLists ? n : kFoldLists;
  Merge m;
  m.key = reinterpret_cast<unsigned long long*>(base);
  m.org = reinterpret_cast<int*>(m.key + (size_t)L * W);
  return m;
}

// Every thread of the block: top[0, W) := the W largest keys of lists
// 0..n-1 (load(p, j): key j of list p, each list W keys descending, keys
// unique across the lists), descending; org[k] = p * W + j of top[k].
// Ends with a block barrier.
template <typename Load>
__device__ __forceinline__ void merge(int n, int W, Load load, Merge m,
                                      unsigned long long* top, int* org) {
  const int L = n < kFoldLists ? n : kFoldLists;
  int done = 0;
  for (int lead = 0; done < n; lead = 1) {
    const int take = min(n - done, L - lead);
    const int cnt = lead + take;               // lists in this fold
    for (int i = threadIdx.x; i < cnt * W; i += blockDim.x) {
      const int q = i / W, j = i - q * W;
      if (q < lead) {
        m.key[i] = top[j];
        m.org[i] = org[j];
      } else {
        const int p = done + q - lead;
        m.key[i] = load(p, j);
        m.org[i] = p * W + j;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < cnt * W; i += blockDim.x) {
      const int q = i / W;
      const unsigned long long x = m.key[i];
      int r = i - q * W;
      for (int q2 = 0; q2 < cnt && r < W; ++q2) {
        if (q2 == q) continue;
        const unsigned long long* l = m.key + q2 * W;
        int lo = 0, hi = W;                     // l[0, lo) > x
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (l[mid] > x) lo = mid + 1; else hi = mid;
        }
        r += lo;
      }
      if (r < W) {
        top[r] = x;
        org[r] = m.org[i];
      }
    }
    __syncthreads();
    done += take;
  }
}

// ------------------------------------------------------- transports

// Every thread of every block of the cluster.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The push design's inboxes, in device memory: shard s's block g receives
// `from`'s words of a step at box(s, step, from). Strong system-scope
// accesses: the peer may be on another card.
struct Push {
  unsigned long long* const* inbox;   // [n] -> shard s's [2][G][n][2W]
  int n;                              // shards in the group
  int G;                              // blocks per shard
  int W;                              // keys per list (<= kListLen)
};

struct DeviceBoxes {
  Push x;
  int g;                              // this block's place in its shard

  __device__ unsigned long long* box(int s, unsigned step, int from) const {
    return x.inbox[s] +
           (((size_t)(step & 1u) * x.G + g) * x.n + from) * 2 * x.W;
  }
  static __device__ void store(unsigned long long* p, unsigned long long v) {
    asm volatile("st.relaxed.sys.global.u64 [%0], %1;"
                 :: "l"(p), "l"(v) : "memory");
  }
  static __device__ unsigned long long load(const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.relaxed.sys.global.u64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
    return v;
  }
};

// The cluster design's inboxes, in the shared memory of each block of the
// cluster ([2][n][2W] words each, at the same offset): block s receives
// `from`'s words at box(s, step, from), reached through distributed
// shared memory (mapa). Strong cluster-scope accesses.
struct SharedBoxes {
  unsigned long long* inbox;          // this block's [2][n][2W]
  int n, W;

  __device__ unsigned long long* box(int s, unsigned step, int from) const {
    unsigned long long* b =
        cooperative_groups::this_cluster().map_shared_rank(inbox, s);
    return b + ((size_t)(step & 1u) * n + from) * 2 * W;
  }
  static __device__ void store(unsigned long long* p, unsigned long long v) {
    asm volatile("st.relaxed.cluster.u64 [%0], %1;"
                 :: "l"(p), "l"(v) : "memory");
  }
  static __device__ unsigned long long load(const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.relaxed.cluster.u64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
    return v;
  }
};

// Every thread: shard s sends list[0, W) (shared memory) of `step` to its
// n - 1 peers, two tagged words a key. No barrier follows: the list is
// read again only by this block's gather.
template <typename Boxes>
__device__ __forceinline__ void push(const Boxes& x, int n, int W, int s,
                                     unsigned step,
                                     const unsigned long long* list) {
  const unsigned long long tag = (unsigned long long)step << 32;
  for (int i = threadIdx.x; i < (n - 1) * W; i += blockDim.x) {
    const int q0 = i / W, k = i - q0 * W;
    const int q = q0 < s ? q0 : q0 + 1;            // every peer but s
    unsigned long long* o = x.box(q, step, s) + 2 * k;
    const unsigned long long key = list[k];
    Boxes::store(o, tag | (key >> 32));
    Boxes::store(o + 1, tag | (key & 0xffffffffull));
  }
}

// The lists shard s merges at `step`: its own from `list`, a peer's from
// its inbox once both words of the key carry the step.
template <typename Boxes>
struct Gather {
  Boxes x;
  const unsigned long long* list;
  int s;
  unsigned step;

  __device__ unsigned long long operator()(int p, int j) const {
    if (p == s) return list[j];
    const unsigned long long* w = x.box(s, step, p) + 2 * j;
    unsigned long long hi, lo;
    while (((hi = Boxes::load(w)) >> 32) != step) __nanosleep(20);
    while (((lo = Boxes::load(w + 1)) >> 32) != step) __nanosleep(20);
    return (hi << 32) | (lo & 0xffffffffull);
  }
};

// The words of one block's shared-memory inboxes.
__host__ __device__ inline size_t inbox_words(int n, int W) {
  return n > 1 ? 2 * (size_t)n * 2 * W : 0;
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

// How many clusters of `size` blocks of `kernel` the current card holds
// at once (0 where it holds none, or refuses the size); sizes past the
// portable 8 are allowed first.
inline int resident_clusters(const void* kernel, int threads, size_t smem,
                             int size) {
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed,
                           size > 8 ? 1 : 0) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(size);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = size;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int k = 0;
  if (cudaOccupancyMaxActiveClusters(&k, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return k;
}

// A launch of `kernel` (args: its argument pointers) in clusters of `size`
// blocks along x, not cooperative.
inline cudaError_t launch_clusters(const void* kernel, dim3 grid,
                                   int threads, size_t smem, int size,
                                   cudaStream_t stream, void** args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
        size > 8 ? 1 : 0);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = size;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace xchg
}  // namespace gasr
