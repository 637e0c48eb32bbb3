// The exchange of tp_scan (exchange.cuh) around a toy body, as a test of
// both transports on their own.
//
// Replaces gasr_tpu/ops/pallas/exchange_probe.py::toy_exchange_scan
// (`_toy_kernel`), which carries fused_tp_scan's exchange skeleton (parity
// buffers, per-peer semaphores, the `_merge2_top` fold) around the same
// body. Per step t and row r, on each shard s: fold the carry (owned by
// shard 0 only; the other shards fold INT_MIN) into the step's local keys
// [128], descending, ties by id ascending (local ids s*128 + lane, carry
// ids 2^20 + lane); exchange the local list with every peer and merge the
// n lists to the top 128; that merge is the step's output and the next
// step's carry. Any parity or ordering fault corrupts the later steps.
//
// A (key, id) pair becomes one 64-bit key (key with its sign bit flipped
// high, inverted id low), so "key desc, id asc" is the key's order, the
// local fold is topk.cuh's warp_merge128 and the exchange is tp_scan's.
// Bound on the card: neither bytes nor operations (1 KB a row and step);
// the step's exchange bounds it. Design: one warp a block, as tp_scan's
// designs place its blocks: the cluster transport with a cluster of n
// blocks a row (every shard on one card); the push transport with a
// persistent grid of n_local x G blocks a card, the rows of a group
// walked in turn, launched cooperatively.
#include <cuda_runtime.h>
#include <stdint.h>

#include "exchange.cuh"
#include "topk.cuh"

namespace {

constexpr int kS = gasr::kListLen;   // 128 keys a row
constexpr int kToyThreads = 32;

__device__ __forceinline__ unsigned long long pack(int key, uint32_t id) {
  return ((unsigned long long)((uint32_t)key ^ 0x80000000u) << 32) |
         (unsigned long long)(~id);
}

__device__ __forceinline__ int unpack_key(unsigned long long k) {
  return (int)((uint32_t)(k >> 32) ^ 0x80000000u);
}

// Shared memory of a toy block: its list, the merged top, the merge and
// its origins; with the cluster transport also its inboxes.
__host__ __device__ inline size_t toy_smem(int n, bool cluster) {
  return 2 * kS * sizeof(unsigned long long) +
         gasr::xchg::merge_bytes(n, kS) + kS * sizeof(int) +
         (cluster ? gasr::xchg::inbox_words(n, kS) : 0) *
             sizeof(unsigned long long);
}

struct ToyParts {
  unsigned long long* list;    // [kS]
  unsigned long long* top;     // [kS]
  gasr::xchg::Merge m;
  int* org;
  unsigned long long* inbox;   // cluster transport: [2][n][2 kS] words
};

__device__ __forceinline__ ToyParts carve_toy(void* base, int n) {
  ToyParts p;
  p.list = reinterpret_cast<unsigned long long*>(base);
  p.top = p.list + kS;
  p.m = gasr::xchg::carve_merge(p.top + kS, n, kS);
  p.org = reinterpret_cast<int*>(reinterpret_cast<uint8_t*>(p.m.key) +
                                 gasr::xchg::merge_bytes(n, kS));
  p.inbox = reinterpret_cast<unsigned long long*>(p.org + kS);
  return p;
}

// Row r's T steps on shard s: its list, then exchange(step), which leaves
// the merge in top and ends with a barrier. out_s: shard s's output [T,
// Bt, kS].
template <typename Exchange>
__device__ __forceinline__ void toy_row(const int* __restrict__ keys, int T,
                                        int Bt, int s, int r,
                                        int* __restrict__ out_s,
                                        const ToyParts& p, unsigned& step,
                                        Exchange exchange) {
  const int lane = threadIdx.x;
  int carry[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) carry[q] = INT32_MIN;
  for (int t = 0; t < T; ++t) {
    ++step;
    const int* row = keys + (((size_t)s * T + t) * Bt + r) * kS;
    unsigned long long a[4], c[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = 32 * q + lane;
      a[q] = pack(row[e], (uint32_t)(s * kS + e));
      c[q] = pack(s == 0 ? carry[q] : INT32_MIN, (1u << 20) + e);
    }
    gasr::warp_merge128(a, c);
#pragma unroll
    for (int q = 0; q < 4; ++q) p.list[32 * q + lane] = a[q];
    __syncthreads();                       // the list is in place
    exchange(step);
    int* o = out_s + ((size_t)t * Bt + r) * kS;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      carry[q] = unpack_key(p.top[32 * q + lane]);
      o[32 * q + lane] = carry[q];
    }
    __syncthreads();   // top is rewritten next step
  }
}

// Cluster transport: cluster r (blocks r*n .. r*n + n - 1) is row r.
// out [n, T, Bt, kS].
__global__ void __launch_bounds__(kToyThreads)
toy_cluster_kernel(const int* __restrict__ keys, int T, int Bt, int n,
                   int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned long long smem[];
  const ToyParts p = carve_toy(smem, n);
  const int s = (int)cooperative_groups::this_cluster().block_rank();
  const int r = blockIdx.x / n;
  for (size_t i = threadIdx.x; i < gasr::xchg::inbox_words(n, kS);
       i += blockDim.x)
    p.inbox[i] = 0;
  gasr::xchg::cluster_barrier();   // every inbox zeroed before any push
  const gasr::xchg::SharedBoxes boxes{p.inbox, n, kS};
  unsigned step = 0;
  toy_row(keys, T, Bt, s, r, out + (size_t)s * T * Bt * kS, p, step,
          [&](unsigned st) {
            gasr::xchg::push(boxes, n, kS, s, st, p.list);
            gasr::xchg::merge(
                n, kS,
                gasr::xchg::Gather<gasr::xchg::SharedBoxes>{boxes, p.list, s,
                                                            st},
                p.m, p.top, p.org);
          });
  gasr::xchg::cluster_barrier();   // no block leaves while a peer writes
}

// Push transport: block (local, g) of shard shards[local] walks rows g,
// g + G, ...; out [n_local, T, Bt, kS].
__global__ void __launch_bounds__(kToyThreads)
toy_push_kernel(const int* __restrict__ keys, int T, int Bt,
                const int* __restrict__ shards, gasr::xchg::Push x,
                int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned long long smem[];
  const ToyParts p = carve_toy(smem, x.n);
  const int local = blockIdx.x / x.G;
  const int g = blockIdx.x - local * x.G;
  const int s = shards[local];
  const gasr::xchg::DeviceBoxes boxes{x, g};
  unsigned step = 0;
  for (int r = g; r < Bt; r += x.G) {
    toy_row(keys, T, Bt, s, r, out + (size_t)local * T * Bt * kS, p, step,
            [&](unsigned st) {
              gasr::xchg::push(boxes, x.n, kS, s, st, p.list);
              gasr::xchg::merge(
                  x.n, kS,
                  gasr::xchg::Gather<gasr::xchg::DeviceBoxes>{boxes, p.list,
                                                              s, st},
                  p.m, p.top, p.org);
            });
  }
}

constexpr int kClusterMax = 16;

}  // namespace

// The largest toy cluster (at most 16 blocks) the current card holds.
extern "C" int toy_cluster_limit(int* limit) {
  *limit = 0;
  for (int c = kClusterMax; c >= 1; --c) {
    if (gasr::xchg::resident_clusters((const void*)toy_cluster_kernel,
                                      kToyThreads, toy_smem(c, true), c) > 0) {
      *limit = c;
      break;
    }
  }
  return 0;
}

// keys, out [n, T, Bt, 128] int32, every shard on the current card.
extern "C" int toy_cluster_launch(const int* keys, int T, int Bt, int n,
                                  int* out, cudaStream_t stream) {
  if (n < 1 || n > kClusterMax || Bt < 1) return (int)cudaErrorInvalidValue;
  void* args[] = {&keys, &T, &Bt, &n, &out};
  return (int)gasr::xchg::launch_clusters((const void*)toy_cluster_kernel,
                                          dim3(n * Bt), kToyThreads,
                                          toy_smem(n, true), n, stream, args);
}

// How many toy push blocks the current card holds at once, for n shards.
extern "C" int toy_push_capacity(int n, int* blocks) {
  const size_t smem = toy_smem(n, false);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)toy_push_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = gasr::xchg::resident_blocks((const void*)toy_push_kernel,
                                      kToyThreads, smem, blocks);
  return (int)err;
}

// keys [n, T, Bt, 128] int32 (on the current card); the n_local shards
// `shards` (device array) of this card, G blocks each; inbox: a device
// array of n pointers (shard s's zeroed [2, G, n, 256] words, on its
// card); out [n_local, T, Bt, 128].
extern "C" int toy_push_launch(const int* keys, int T, int Bt, int n,
                               const int* shards, int n_local, int G,
                               unsigned long long* const* inbox, int* out,
                               cudaStream_t stream) {
  if (n < 1 || G < 1 || n_local < 1 || Bt < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = toy_smem(n, false);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)toy_push_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  gasr::xchg::Push x{inbox, n, G, kS};
  void* args[] = {&keys, &T, &Bt, &shards, &x, &out};
  err = cudaLaunchCooperativeKernel((const void*)toy_push_kernel,
                                    dim3(n_local * G), dim3(kToyThreads),
                                    args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
