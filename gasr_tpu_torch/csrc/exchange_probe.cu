// The exchange protocol of tp_scan (exchange.cuh) around a toy body, as a
// test of the protocol on its own.
//
// Replaces gasr_tpu/ops/pallas/exchange_probe.py::toy_exchange_scan
// (`_toy_kernel`), which carries fused_tp_scan's exchange skeleton (parity
// buffers, per-peer semaphores, the `_merge2_top` fold) around the same
// body. Per step t and row r, on each shard s: fold the carry (owned by
// shard 0 only; the other shards fold INT_MIN) into the step's local keys
// [128], descending, ties by id ascending (local ids s*128 + lane, carry
// ids 2^20 + lane); publish the local list, wait for the peers, fold the
// n lists to the top 128; that fold is the step's output and the next
// step's carry. Any parity or ordering fault corrupts the later steps.
//
// A (key, id) pair becomes one 64-bit key (key with its sign bit flipped
// high, inverted id low), so "key desc, id asc" is the key's order and
// the folds are topk.cuh's warp_merge128. Bound on the card: neither bytes
// nor operations (1 KB a row and step); the step's round trip through the
// card's memory between co-resident blocks bounds it. Design: one warp
// per block, a block per (shard, row group), the rows of a group walked in
// turn, the grid launched cooperatively.
#include <cuda_runtime.h>
#include <stdint.h>

#include "exchange.cuh"
#include "topk.cuh"

namespace {

using gasr::xchg::Exchange;
constexpr int kS = gasr::kListLen;   // 128 keys a row

__device__ __forceinline__ unsigned long long pack(int key, uint32_t id) {
  return ((unsigned long long)((uint32_t)key ^ 0x80000000u) << 32) |
         (unsigned long long)(~id);
}

__device__ __forceinline__ int unpack_key(unsigned long long k) {
  return (int)((uint32_t)(k >> 32) ^ 0x80000000u);
}

__global__ void __launch_bounds__(32)
toy_exchange_kernel(const int* __restrict__ keys, int T, int Bt, Exchange x,
                    int* __restrict__ out) {
  __shared__ unsigned long long list[kS];
  const int s = blockIdx.x / x.G;
  const int g = blockIdx.x - s * x.G;
  const int lane = threadIdx.x;
  unsigned step = 0;
  for (int r = g; r < Bt; r += x.G) {
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
      for (int q = 0; q < 4; ++q) list[32 * q + lane] = a[q];
      __syncthreads();
      gasr::xchg::publish_and_wait(x, s, g, step, list);
      gasr::xchg::merge(x, s, g, step, list);
      int* o = out + (((size_t)s * T + t) * Bt + r) * kS;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        carry[q] = unpack_key(list[32 * q + lane]);
        o[32 * q + lane] = carry[q];
      }
      __syncthreads();   // list is rewritten next step
    }
  }
}

}  // namespace

// How many toy blocks the current card holds at once.
extern "C" int toy_exchange_capacity(int* blocks) {
  return (int)gasr::xchg::resident_blocks((const void*)toy_exchange_kernel,
                                          32, 0, blocks);
}

// keys, out [n, T, Bt, 128] int32 (all n shards on the current card);
// outbox / flags: device arrays of n pointers ([2, G, 128] keys, [G]
// zeroed flags).
extern "C" int toy_exchange_launch(const int* keys, int T, int Bt, int n,
                                   int G, unsigned long long* const* outbox,
                                   unsigned* const* flags, int* out,
                                   cudaStream_t stream) {
  if (n < 1 || G < 1) return (int)cudaErrorInvalidValue;
  Exchange x{outbox, flags, n, G, kS};
  void* args[] = {&keys, &T, &Bt, &x, &out};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)toy_exchange_kernel, dim3(n * G), dim3(32), args, 0,
      stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
