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
// descending order, are exactly that selection in that order. Every
// comparison below is on the 64-bit key, never on the score.
//
// Bound on the card: per utterance and frame the decode's top-W looks at
// W*V = 4700 candidates; bytes and operations are tiny next to the card's
// rates, so what bounds it is the chain of dependent steps and barriers,
// and the instructions the block issues on it.
//
// Design: a threshold-filtered top-W (select_seed, select_walk,
// select_rank), run by every decode kernel each frame and, alone, by the
// standalone topk kernel (csrc/topk.cu). Only the W largest keys are
// kept, so most candidates need no sorting at all. A key below a threshold
// theta, such that at least W distinct real candidates have keys >= theta,
// cannot be among the W largest, and one compare drops it.
//   seed  every thread takes the largest seed score of its cells (i = tid,
//         tid + blockDim.x, ...; monotone bits, 32 bits); a warp sorts its
//         32 maxima and publishes its c-th largest q; theta starts at the
//         key q << 32 of the least of the warps' q. There are warps * c
//         maxima at or above it, each of a different cell; a caller whose
//         seed scores may name up to X cells that are not real candidates
//         (the decode: the absorbed extends, X <= W, whose exclusion the
//         seed does not know) asks for warps * c >= W + X; the
//         standalone topk, whose cells are all real, for warps * c >= W.
//   walk  every warp walks the cells in slot order (cell tid first, then
//         tid + blockDim.x, ...); keys >= theta are compacted with a ballot
//         into the warp's buffer, and a full buffer of 32 is sorted and
//         merged into the warp's sorted list of 32R keys (R = 1, 2, 4:
//         32R >= W). A list holding W real keys raises the shared theta to
//         its W-th key (64-bit atomicMax in shared memory; any warp may
//         read a smaller theta than the latest, which only keeps more).
//   rank  every list key's rank among all the lists' keys: its place in
//         its own list plus, in every other list, the count of larger
//         keys (binary search). The keys of rank < W are the block top-W
//         in order. A key >= theta was never dropped unless its list held
//         32R >= W larger keys, so the lists' union holds the W largest.
// Three block barriers in all (after seed, after walk, after rank); the
// caller places them, so the decode folds its own phases in.
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

// One bitonic level of block size K on a warp's list v of 32R keys
// (element e = 32*r + lane): stages j = K/2 .. 1; the run containing e is
// sorted descending when (e & K) == 0, ascending otherwise.
template <int K, int R = 4>
__device__ __forceinline__ void warp_bitonic_level(unsigned long long* v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = K / 2; j > 0; j >>= 1) {
    if (j >= 32) {
      const int jr = j / 32;               // partner in register r ^ jr
#pragma unroll
      for (int r = 0; r < R; ++r) {
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
      for (int r = 0; r < R; ++r) {
        const bool desc = (((32 * r + lane) & K) == 0);
        const unsigned long long p = __shfl_xor_sync(kFullMask, v[r], j);
        v[r] = (lower == desc) ? kmax(v[r], p) : kmin(v[r], p);
      }
    }
  }
}

// Sort one key a lane across the warp, descending (lane 0 the largest).
__device__ __forceinline__ unsigned long long warp_sort32(unsigned long long x) {
  unsigned long long v[1] = {x};
  warp_bitonic_level<2, 1>(v);
  warp_bitonic_level<4, 1>(v);
  warp_bitonic_level<8, 1>(v);
  warp_bitonic_level<16, 1>(v);
  warp_bitonic_level<32, 1>(v);
  return v[0];
}

// a := the largest 128 of a and b, descending; both sorted descending
// (the vocab-sharded decode's exchange, exchange.cuh).
__device__ __forceinline__ void warp_merge128(unsigned long long a[4],
                                              const unsigned long long b[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    // element 127 - e of b: register 3 - r of lane 31 - lane
    a[r] = kmax(a[r], __shfl_xor_sync(kFullMask, b[3 - r], 31));
  }
  warp_bitonic_level<128>(a);              // a was bitonic: clean it
}

// a (32R keys) := the largest 32R of a and the run b (one key a lane),
// descending; both sorted descending. b padded with zeros to 32R keys,
// reversed, is non-zero in a's last register only.
template <int R>
__device__ __forceinline__ void warp_merge_run(unsigned long long* a,
                                               unsigned long long b) {
  a[R - 1] = kmax(a[R - 1], __shfl_xor_sync(kFullMask, b, 31));
  warp_bitonic_level<32 * R, R>(a);
}

// ------------------------------------------------------ filtered top-W

// Shared scratch of the filtered top-W, for `warps` warps.
struct Select {
  unsigned long long* lists;   // [warps][kListLen]: buffer, then the list
  unsigned long long* seed;    // [warps]: each warp's c-th largest maximum
  unsigned long long* theta;   // the running threshold
  int* count;                  // [warps]: real keys in each list
};

__host__ __device__ constexpr size_t select_bytes(int warps) {
  return (size_t)warps * (kListLen + 1) * sizeof(unsigned long long) +
         sizeof(unsigned long long) + (size_t)warps * sizeof(int);
}

// Carve the scratch from 8-byte aligned shared memory; returns its end.
__device__ __forceinline__ void* carve_select(void* base, int warps,
                                              Select* sel) {
  unsigned long long* p = reinterpret_cast<unsigned long long*>(base);
  sel->lists = p;
  sel->seed = p + (size_t)warps * kListLen;
  sel->theta = sel->seed + warps;
  sel->count = reinterpret_cast<int*>(sel->theta + 1);
  return sel->count + warps;
}

// The cells of a grid of `cols` columns that thread `tid` visits, in
// order: i = tid, tid + stride, ...; (w, j) = (i / cols, i % cols) kept
// without a division per step.
struct CellWalk {
  int i, w, j, dw, dj, cols, stride;
  __device__ __forceinline__ CellWalk(int tid, int stride_, int cols_)
      : i(tid), w(tid / cols_), j(tid - (tid / cols_) * cols_),
        dw(stride_ / cols_), dj(stride_ - (stride_ / cols_) * cols_),
        cols(cols_), stride(stride_) {}
  __device__ __forceinline__ void next() {
    i += stride;
    w += dw;
    j += dj;
    if (j >= cols) {
      j -= cols;
      ++w;
    }
  }
};

// Sort one 32-bit value a lane across the warp, descending.
__device__ __forceinline__ uint32_t warp_sort32_bits(uint32_t x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int K = 2; K <= 32; K <<= 1) {
    const bool desc = (lane & K) == 0;
#pragma unroll
    for (int j = K / 2; j > 0; j >>= 1) {
      const uint32_t p = __shfl_xor_sync(kFullMask, x, j);
      x = (((lane & j) == 0) == desc) ? max(x, p) : min(x, p);
    }
  }
  return x;
}

// Seed (every thread; a barrier must follow before select_walk): the
// thread's largest seed_bits(w, j) over its cells of the n-cell grid (the
// monotone bits of a seed score; 0 for none), then its warp's c-th largest
// maximum q: the seed key q << 32 is at or below the key of every cell
// whose seed bits are >= q, whatever its index (key 0 when c > 32: no
// seed). Thread 0 resets the running threshold.
template <typename SeedBits>
__device__ __forceinline__ void select_seed(SeedBits seed_bits, int n,
                                            int cols, int c,
                                            const Select& sel) {
  uint32_t m = 0u;
  // two cells a step: their loads overlap
  for (CellWalk cw(threadIdx.x, blockDim.x, cols); cw.i < n;) {
    CellWalk c1 = cw;
    c1.next();
    const uint32_t b0 = seed_bits(cw.w, cw.j);
    const uint32_t b1 = c1.i < n ? seed_bits(c1.w, c1.j) : 0u;
    m = max(m, max(b0, b1));
    cw = c1;
    cw.next();
  }
  m = warp_sort32_bits(m);
  const uint32_t q = __shfl_sync(kFullMask, m, c <= 32 ? c - 1 : 0);
  if ((threadIdx.x & 31) == 0)
    sel.seed[threadIdx.x >> 5] = c <= 32 ? (unsigned long long)q << 32 : 0ull;
  if (threadIdx.x == 0) *sel.theta = 0ull;
}

// A warp whose list a (32R keys) holds W real keys: its W-th key raises
// the shared theta and the warp's own.
template <int R>
__device__ __forceinline__ void raise_theta(const unsigned long long* a,
                                            int W, const Select& sel,
                                            unsigned long long* th) {
  // one shuffle a register, not a[(W - 1) / 32]: an index into a would
  // put the list in local memory
  unsigned long long kw = 0ull;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const unsigned long long x = __shfl_sync(kFullMask, a[r], (W - 1) & 31);
    kw = r == (W - 1) >> 5 ? x : kw;
  }
  *th = kmax(*th, kw);
  if ((threadIdx.x & 31) == 0) atomicMax(sel.theta, kw);
}

// One chunk of the walk: every lane's key (0 where it has none) that is
// not below theta goes into the warp's buffer in lane order; a buffer of
// 32 is sorted and merged into the warp's list a.
template <int R>
__device__ __forceinline__ void filter_round(unsigned long long key, int W,
                                             const Select& sel,
                                             unsigned long long* buf,
                                             unsigned long long* a,
                                             unsigned long long* th,
                                             int* nbuf, int* nreal) {
  const int lane = threadIdx.x & 31;
  const volatile unsigned long long* theta = sel.theta;
  *th = kmax(*th, *theta);
  const bool keep = key != 0ull && key >= *th;
  const unsigned keepmask = __ballot_sync(kFullMask, keep);
  // -- survivors
  if (keep) buf[*nbuf + __popc(keepmask & ((1u << lane) - 1u))] = key;
  *nbuf += __popc(keepmask);
  if (*nbuf >= 32) {
    // -- flush
    __syncwarp();
    const unsigned long long b = buf[lane];
    const unsigned long long rest = lane + 32 < *nbuf ? buf[lane + 32] : 0ull;
    __syncwarp();
    if (lane + 32 < *nbuf) buf[lane] = rest;
    *nbuf -= 32;
    const unsigned long long sb = warp_sort32(b);
    if (*nreal == 0) a[0] = sb;              // an empty list: no merge
    else warp_merge_run<R>(a, sb);
    *nreal = min(32 * R, *nreal + 32);
    if (*nreal >= W) raise_theta<R>(a, W, sel, th);
    // -- walk
  }
}

// Walk (every thread, after the barrier that follows select_seed; a
// barrier must follow before select_rank): every cell's key_of(i, w, j)
// that is not below theta goes into the warp's list of 32R keys, which
// ends in sel.lists[warp] (descending, key 0 past its count).
template <int R, typename KeyOf>
__device__ __forceinline__ void select_walk(KeyOf key_of, int n, int cols,
                                            int W, const Select& sel) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  // theta starts at the least of the warps' seeds
  unsigned long long th = lane < nwarps ? sel.seed[lane] : ~0ull;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    th = kmin(th, __shfl_xor_sync(kFullMask, th, o));
  unsigned long long* buf = sel.lists + (size_t)warp * kListLen;
  unsigned long long a[R];
#pragma unroll
  for (int r = 0; r < R; ++r) a[r] = 0ull;
  int nreal = 0, nbuf = 0;
  // chunk base = cw.i - lane: warp-uniform
  for (CellWalk cw(threadIdx.x, blockDim.x, cols); cw.i - lane < n;
       cw.next()) {
    filter_round<R>(cw.i < n ? key_of(cw.i, cw.w, cw.j) : 0ull, W, sel, buf,
                    a, &th, &nbuf, &nreal);
  }
  // -- last flush
  __syncwarp();
  if (nbuf > 0) {
    const unsigned long long b = lane < nbuf ? buf[lane] : 0ull;
    const unsigned long long sb = warp_sort32(b);
    if (nreal == 0) a[0] = sb;
    else warp_merge_run<R>(a, sb);
    nreal = min(32 * R, nreal + nbuf);
    if (nreal >= W) raise_theta<R>(a, W, sel, &th);
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < R; ++r) buf[32 * r + lane] = a[r];
  if (lane == 0) sel.count[warp] = nreal;
}

// Entries of the descending list[0, 32R) greater than x (x > 0: the
// zeros past a list's count are below it): a search of the first 32
// (log2(32) + 1 loads that depend on each other and on nothing else),
// and of all 32R where list[31] is above x too.
template <int R>
__device__ __forceinline__ int count_above(const unsigned long long* list,
                                           unsigned long long x) {
  const int span = (R > 1 && list[31] > x) ? 16 * R : 16;
  int pos = 0;
#pragma unroll
  for (int step = 16 * R; step > 0; step >>= 1)
    if (step <= span) pos += list[pos + step - 1] > x ? step : 0;
  return pos + (list[pos] > x ? 1 : 0);
}

// Rank (every thread of kNW warps, after the barrier that follows
// select_walk): calls on_winner(k, key) once for each k in [0, W), key the
// k-th largest, from the thread that ranked it. A key's rank is the count
// of larger keys in all the lists, its own included (its place there);
// the kNW searches are independent, so they overlap.
template <int kNW, int R, typename OnWinner>
__device__ __forceinline__ void select_rank(int W, const Select& sel,
                                            OnWinner on_winner) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned long long th = *sel.theta;
  const unsigned long long* mine = sel.lists + (size_t)warp * kListLen;
  const int n = min(sel.count[warp], W);   // a place >= W ranks >= W
  for (int e = lane; e < n; e += 32) {
    const unsigned long long x = mine[e];
    if (x < th) break;                      // W keys of the lists are above
    int rank = 0;
#pragma unroll
    for (int j = 0; j < kNW; ++j)
      rank += count_above<R>(sel.lists + j * kListLen, x);
    if (rank < W) on_winner(rank, x);
  }
}

}  // namespace gasr
