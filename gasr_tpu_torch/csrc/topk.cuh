// Stable block top-W: the selection of `lax.top_k`, bit for bit.
//
// Replaces: gasr_tpu/ops/pallas/topk.py (`pallas_topk` / `_topk_kernel`,
// `_monotone_bits`, `_bitonic_sort_desc`), the machinery the TPU decode
// kernel selects its top-W with.
//
// Order: score descending, then index ascending, on a total order of the
// float bits (monotone_bits: -0.0 ranks below +0.0, as in lax.top_k).
// Each candidate becomes one 64-bit key, monotone score bits high and the
// inverted index low, so keys are unique and the largest keys, in
// descending order, are exactly that selection in that order.
//
// Bound on the card: per utterance and frame the decode's top-W looks at
// W*V = 4700 candidates; bytes and operations are tiny next to the card's
// rates, so what bounds it is the chain of dependent steps and barriers.
// Design: block_top128 keeps every key in registers. A warp owns runs of
// 128 consecutive candidates (element e of a run in register e / 32 of
// lane e % 32), sorts each run with a bitonic network of register swaps
// and xor-shuffles (no shared memory, no block barrier), and folds it into
// its running top-128 list with one bitonic merge (max of the list and
// the reversed run, then a 7-stage clean). The warps' lists then meet in
// a merge tree through shared memory: log2(warps) levels, one barrier
// each. Keys are built on the fly by the caller's functor, so the W*V
// candidates never touch memory at all.
#pragma once

#include <stdint.h>

namespace gasr {

constexpr int kListLen = 128;             // top list length: W, k <= 128
constexpr unsigned kFullMask = 0xffffffffu;

// float32 -> uint32 with the same total order (ascending).
__device__ __forceinline__ uint32_t monotone_bits(float x) {
  uint32_t u = __float_as_uint(x);
  return (u >= 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float inverse_monotone_bits(uint32_t m) {
  uint32_t u = (m >= 0x80000000u) ? (m & 0x7FFFFFFFu) : ~m;
  return __uint_as_float(u);
}

// Sort key of candidate `idx` with score `x`: larger key = earlier rank.
// Key 0 is below every real key: it pads short lists.
__device__ __forceinline__ unsigned long long topk_key(float x, uint32_t idx) {
  return ((unsigned long long)monotone_bits(x) << 32) |
         (unsigned long long)(~idx);
}

__device__ __forceinline__ uint32_t key_index(unsigned long long key) {
  return ~(uint32_t)key;
}

__device__ __forceinline__ float key_value(unsigned long long key) {
  return inverse_monotone_bits((uint32_t)(key >> 32));
}

__device__ __forceinline__ unsigned long long kmax(unsigned long long a,
                                                   unsigned long long b) {
  return a > b ? a : b;
}

__device__ __forceinline__ unsigned long long kmin(unsigned long long a,
                                                   unsigned long long b) {
  return a < b ? a : b;
}

// One bitonic level of block size K on a warp's 128-list v (element
// e = 32*r + lane): stages j = K/2 .. 1; the run containing e is sorted
// descending when (e & K) == 0, ascending otherwise.
template <int K>
__device__ __forceinline__ void warp_bitonic_level(unsigned long long v[4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = K / 2; j > 0; j >>= 1) {
    if (j >= 32) {
      const int jr = j / 32;               // partner in register r ^ jr
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if ((r & jr) == 0) {
          const bool desc = (((32 * r + lane) & K) == 0);
          const unsigned long long a = v[r], b = v[r | jr];
          v[r] = desc ? kmax(a, b) : kmin(a, b);
          v[r | jr] = desc ? kmin(a, b) : kmax(a, b);
        }
      }
    } else {                               // partner in lane ^ j
      const bool lower = (lane & j) == 0;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const bool desc = (((32 * r + lane) & K) == 0);
        const unsigned long long p = __shfl_xor_sync(kFullMask, v[r], j);
        v[r] = (lower == desc) ? kmax(v[r], p) : kmin(v[r], p);
      }
    }
  }
}

// Sort a warp's 128-list descending.
__device__ __forceinline__ void warp_sort128(unsigned long long v[4]) {
  warp_bitonic_level<2>(v);
  warp_bitonic_level<4>(v);
  warp_bitonic_level<8>(v);
  warp_bitonic_level<16>(v);
  warp_bitonic_level<32>(v);
  warp_bitonic_level<64>(v);
  warp_bitonic_level<128>(v);
}

// a := the largest 128 of a and b, descending; both sorted descending.
__device__ __forceinline__ void warp_merge128(unsigned long long a[4],
                                              const unsigned long long b[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    // element 127 - e of b: register 3 - r of lane 31 - lane
    a[r] = kmax(a[r], __shfl_xor_sync(kFullMask, b[3 - r], 31));
  }
  warp_bitonic_level<128>(a);              // a was bitonic: clean it
}

// The kListLen largest of key_of(0), ..., key_of(n - 1), descending, into
// lists[0, kListLen) (key 0 where n < kListLen). `lists` is shared memory
// for (blockDim.x / 32) * kListLen keys; blockDim.x / 32 must be a power
// of two. Every thread of the block calls it; it ends with a barrier.
template <typename KeyOf>
__device__ void block_top128(KeyOf key_of, int n, unsigned long long* lists) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  unsigned long long acc[4] = {0ull, 0ull, 0ull, 0ull};
  for (int base = warp * kListLen; base < n; base += nwarps * kListLen) {
    unsigned long long v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = base + 32 * r + lane;
      v[r] = i < n ? key_of(i) : 0ull;
    }
    warp_sort128(v);
    warp_merge128(acc, v);
  }
  unsigned long long* mine = lists + warp * kListLen;
#pragma unroll
  for (int r = 0; r < 4; ++r) mine[32 * r + lane] = acc[r];
  for (int half = nwarps / 2; half > 0; half /= 2) {
    __syncthreads();
    if (warp < half) {
      const unsigned long long* other = lists + (warp + half) * kListLen;
      unsigned long long b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) b[r] = other[32 * r + lane];
      warp_merge128(acc, b);
#pragma unroll
      for (int r = 0; r < 4; ++r) mine[32 * r + lane] = acc[r];
    }
  }
  __syncthreads();
}

}  // namespace gasr
