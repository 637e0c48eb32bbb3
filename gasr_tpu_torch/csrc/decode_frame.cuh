// One frame of the matched-merge CTC prefix beam search, for one thread
// block per utterance: the phases that every decode kernel of this
// directory runs, on a vocab window.
//
// The single-card decode (fused_decode.cu) runs them on the whole vocab;
// the vocab-sharded kernels (decode_tp.cu) on a shard's window [lo, hi).
// Sharing them is what keeps every decode bit-equal to the others by
// construction, as JAX shares `_frame_math` between its decode kernels
// (gasr_tpu/parallel/decode_tp.py:84-90). The expressions are the eager
// decoder's (gasr_tpu_torch/decoder/beam_search.py::_frame_step), one for
// one; the libraries that include this header build with -fmad=false.
//
// The beam lives in shared memory twice (Beam, by frame parity): a frame
// reads one copy and writes the next state into the other, so the winners
// of a frame update their slots without a barrier between the last reader
// of the old state and the first writer of the new. With each slot's
// fields a Beam keeps what the next frame needs of them: the total score,
// f[last] (a gather from the next frame's row, which the decode kernels
// fetch while the frame runs) and the folded match key k2 = 31*h2 + length.
//
// Phases of a frame (the caller places a block barrier after each):
//   match_seed   per stay slot w', the first live w with h1[w] == hp1[w']
//                and k2[w] == 31*hp2[w'] + length[w'] - 1: 16 warps over
//                the stay slots, 32 candidate parents a ballot, at most 4
//                ballots at W <= 128 (the lowest set bit of the first
//                non-empty ballot is the first live w); the stay
//                candidate's scores, and a flag on the extend (w,
//                last[w']) that the stay absorbs, where last[w'] lies in
//                the window; beside it, the threshold's seed (topk.cuh)
//                over the extend keys, which need no match: the absorbed
//                extends (at most W) are unknown to it, so it asks for 2W
//                maxima;
//   window_walk  the filtered walk of topk.cuh over the window's W x
//                (hi - lo) candidates, keyed by the global index w*V + v
//                (score descending, index ascending); the stay sits in the
//                blank column, so only a window holding the blank offers
//                stays;
//   window_rank  the ranks; each of the W winners goes to the caller's
//                on_winner(k, key);
//   update       the new state of the slot that a winner's key names, and
//   commit       its fields, total, f[last] and k2 into the other Beam.
// The frame row in shared memory holds the log-probs of vocab ids
// [row_lo, row_lo + row_len): the whole vocab (row_lo = 0) or the window.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "topk.cuh"

namespace gasr {
namespace frame {

constexpr float kNegInf = -1.0e30f;   // beam_search.NEG_INF
constexpr float kDead = -3.0e38f;     // beam_search.DEAD_KEY_LOG
constexpr float kLiveMin = -1.5e38f;  // DEAD_KEY_LOG * 0.5
constexpr uint32_t kM1 = 1000003u;
constexpr uint32_t kM2 = 16777619u;
constexpr int kThreads = 512;         // 16 warps
constexpr int kWarps = kThreads / 32;

// packed state field order (ops/cuda/fused_decode.py FIELDS)
enum { F_H1, F_H2, F_HP1, F_HP2, F_LAST, F_LEN, F_LIVE, F_S1, F_S2, NF };

// beam_search._logaddexp, expression for expression
__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  const float lo = fminf(a, b);
  const float d = lo - m;
  const float e = __fmul_rn(expf(fmaxf(d, -80.0f)), d > -80.0f ? 1.0f : 0.0f);
  return m + log1pf(e);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Keys a lane holds in a warp's list: 32R >= W (topk.cuh's select_walk).
__host__ __device__ inline int list_regs(int W) {
  return W <= 32 ? 1 : (W <= 64 ? 2 : 4);
}

// Shared memory of one block: the selection's scratch, the sorted top-W,
// two Beams of W slots, two frame rows of row_len log-probs, the stay
// scores and packed backpointers of W slots, absorbed-extend flags for
// W x win_len window cells.
__host__ __device__ inline size_t smem_bytes(int W, int row_len,
                                             int win_len) {
  return select_bytes(kWarps) + 2 * (size_t)W * sizeof(float4)
         + (size_t)kListLen * sizeof(unsigned long long)
         + (size_t)(2 * (NF + 2) * W + 2 * row_len + 4 * W) * sizeof(int)
         + (size_t)W * win_len;
}

// One copy of the beam: the fields [NF][W] and, per slot, what the frame
// that reads it needs. sv packs what a candidate's key reads of its slot
// into one 16-byte load: (total, s1, last, live), total =
// logaddexp(p_blank, p_nonblank), last and live as int bits.
struct Beam {
  int* st;          // [NF][W] beam state
  float4* sv;       // [W] (total, s1, last, live) of each slot
  float* flast;     // [W] f[last] of the frame that reads this copy
  uint32_t* k2;     // [W] 31*h2 + length
  int W;

  __device__ uint32_t* h1() const { return (uint32_t*)(st + F_H1 * W); }
  __device__ uint32_t* h2() const { return (uint32_t*)(st + F_H2 * W); }
  __device__ uint32_t* hp1() const { return (uint32_t*)(st + F_HP1 * W); }
  __device__ uint32_t* hp2() const { return (uint32_t*)(st + F_HP2 * W); }
  __device__ int* last() const { return st + F_LAST * W; }
  __device__ int* len() const { return st + F_LEN * W; }
  __device__ int* live() const { return st + F_LIVE * W; }
  __device__ float* s1() const { return (float*)(st + F_S1 * W); }
  __device__ float* s2() const { return (float*)(st + F_S2 * W); }
  __device__ float total(int k) const { return sv[k].x; }
};

struct Smem {
  Select sel;                  // the filtered top-W's scratch
  unsigned long long* top;     // [kListLen] the frame's top-W keys, sorted
  Beam beam[2];                // by frame parity
  float* frow[2];              // [row_len] frame rows, by frame parity
  float* spb;                  // [W] stay p_blank
  float* spnb;                 // [W] stay p_nonblank
  float* sscore;               // [W] stay score
  int* ys;                     // [W] the frame's packed backpointers
  uint8_t* excl;               // [W * win_len] absorbed extends
  int W;
};

// base: 16-byte aligned dynamic shared memory. Plain pointer arithmetic
// from it (no integer round trip), so that the compiler keeps every
// access a shared-memory one.
__device__ __forceinline__ Smem carve(void* base, int W, int row_len) {
  Smem s;
  s.W = W;
  float4* sv = reinterpret_cast<float4*>(base);         // 16-byte aligned
  s.top = reinterpret_cast<unsigned long long*>(
      carve_select(sv + 2 * W, kWarps, &s.sel));
  int* q = reinterpret_cast<int*>(s.top + kListLen);
  for (int c = 0; c < 2; ++c) {
    s.beam[c].W = W;
    s.beam[c].sv = sv + c * W;
    s.beam[c].st = q;
    s.beam[c].flast = reinterpret_cast<float*>(q + NF * W);
    s.beam[c].k2 = reinterpret_cast<uint32_t*>(s.beam[c].flast + W);
    q += (NF + 2) * W;
  }
  s.frow[0] = reinterpret_cast<float*>(q);
  s.frow[1] = s.frow[0] + row_len;
  s.spb = s.frow[1] + row_len;
  s.spnb = s.spb + W;
  s.sscore = s.spnb + W;
  s.ys = reinterpret_cast<int*>(s.sscore + W);
  s.excl = reinterpret_cast<uint8_t*>(s.ys + W);
  return s;
}

// The vocab window a block scores: global ids [lo, hi).
struct Window {
  int lo, hi;
  __device__ int len() const { return hi - lo; }
};

// Row `src[0, n)` into `dst` with cp.async (4 bytes a thread; threads
// n and up issue nothing); cp_async_wait makes the issuing thread's copies
// complete, and a barrier after it makes them visible to the block.
__device__ __forceinline__ void cp_async_row(float* dst,
                                             const float* __restrict__ src,
                                             int n) {
  for (int v = threadIdx.x; v < n; v += blockDim.x) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst + v);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d),
                 "l"(src + v)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Slot k's per-frame values for the frame whose row is `row`: total,
// f[last] (from the row when f_last is null, which needs the row to cover
// the vocab; else f_last[k]) and k2. One thread per slot, on a Beam whose
// fields are in place; a barrier must follow.
__device__ __forceinline__ void prep(const Beam& be, const float* row, int V,
                                     int row_lo, const float* f_last) {
  const int k = threadIdx.x;
  if (k < be.W) {
    const int last = be.last()[k];
    be.sv[k] = make_float4(logaddexp(be.s1()[k], be.s2()[k]), be.s1()[k],
                           __int_as_float(last),
                           __int_as_float(be.live()[k]));
    be.flast[k] = f_last ? f_last[k] : row[clampi(last, 0, V - 1) - row_lo];
    be.k2[k] = be.h2()[k] * 31u + (uint32_t)be.len()[k];
  }
}

// Parent match, stay candidates and the threshold's seed (every thread;
// a barrier must follow). f_blank is f[blank]; row holds the window's
// log-probs at row - row_lo (kWhole: the whole vocab, row_lo = 0); lm the
// shallow-fusion table [V+1, V] (kLM only). Returns the window cell whose
// flag this thread raised, or -1.
template <bool kLM, bool kWhole>
__device__ __forceinline__ int match_seed(const Smem& s, const Beam& be,
                                          const float* row, int V, int blank,
                                          float f_blank, Window win,
                                          int row_lo,
                                          const float* __restrict__ lm) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int W = s.W;
  const int* last = be.last();
  const int* len = be.len();
  const int* live = be.live();
  const float* s1 = be.s1();
  const float* s2 = be.s2();

  // this lane's candidate parents w = 32 q + lane, q < 4, in registers
  uint32_t ph1[4], pk2[4];
  unsigned plive = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int w = 32 * q + lane;
    const bool in = w < W;
    ph1[q] = in ? be.h1()[w] : 0u;
    pk2[q] = in ? be.k2[w] : 0u;
    plive |= (in && live[w]) ? 1u << q : 0u;
  }
  // this warp's stay slots w' = warp + kWarps * q2: lane q2 loads what
  // slot w' looks for, the ballots read it by shuffles
  const int wp = warp + kWarps * lane;
  const bool mine = wp < W;
  const uint32_t my_want1 = mine ? be.hp1()[wp] : 0u;
  const uint32_t my_want2 =
      mine ? be.hp2()[wp] * 31u + (uint32_t)(len[wp] - 1) : 0u;
  const unsigned stays = __ballot_sync(kFullMask, mine && live[wp]);
  int my_m = -1;
  for (int q2 = 0; warp + kWarps * q2 < W; ++q2) {
    const uint32_t want1 = __shfl_sync(kFullMask, my_want1, q2);
    const uint32_t want2 = __shfl_sync(kFullMask, my_want2, q2);
    int m = -1;
    if ((stays >> q2) & 1u) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (32 * q < W && m < 0) {
          const unsigned hit = __ballot_sync(
              kFullMask, ((plive >> q) & 1u) && ph1[q] == want1 &&
                             pk2[q] == want2);
          if (hit) m = 32 * q + __ffs(hit) - 1;
        }
      }
    }
    if (lane == q2) my_m = m;
  }
  int my_excl = -1;
  if (mine) {
    const int m = my_m;
    const float fl = be.flast[wp];
    const float stay_pb = be.total(wp) + f_blank;
    float stay_pnb = len[wp] > 0 ? s2[wp] + fl : kNegInf;
    float ext_contrib = kNegInf;
    if (m >= 0) {
      const float base = last[m] == last[wp] ? s1[m] : logaddexp(s1[m], s2[m]);
      ext_contrib = base + fl;
    }
    stay_pnb = logaddexp(stay_pnb, ext_contrib);
    s.spb[wp] = stay_pb;
    s.spnb[wp] = stay_pnb;
    s.sscore[wp] = live[wp] ? logaddexp(stay_pb, stay_pnb) : kDead;
    if (m >= 0) {
      // the extend (m, last[w']) is this stay's own prefix: excluded, in
      // the window that holds its cell
      const int v = clampi(last[wp], 0, V - 1);
      if (v != blank && v >= win.lo && v < win.hi) {
        my_excl = m * win.len() + (v - win.lo);
        s.excl[my_excl] = 1;
      }
    }
  }
  // -- seed
  const int Vw = kWhole ? V : win.len();
  const int lo = kWhole ? 0 : win.lo;
  const float4* sv = be.sv;
  const float* f = row - row_lo;                       // indexed by v
  auto seed_bits = [=](int w, int j) {
    const int v = lo + j;
    const float4 q = sv[w];
    const int qlast = __float_as_int(q.z);
    float c = (v == qlast ? q.y : q.x) + f[v];
    if (kLM) c = c + __ldg(lm + (size_t)(qlast + 1) * V + v);
    c = __float_as_int(q.w) ? c : kDead;
    // the stays are not known yet: 0, below every real score
    return v == blank ? 0u : monotone_bits(c);
  };
  select_seed(seed_bits, W * Vw, Vw, (2 * W + kWarps - 1) / kWarps, s.sel);
  return my_excl;
}

// The filtered walk of the window's candidates (every thread, after the
// barrier that follows match_seed; a barrier must follow). R: list_regs(W).
template <bool kLM, bool kWhole, int R>
__device__ __forceinline__ void window_walk(const Smem& s, const Beam& be,
                                            const float* row, int V,
                                            int blank, Window win,
                                            int row_lo,
                                            const float* __restrict__ lm) {
  const int Vw = kWhole ? V : win.len();
  const int lo = kWhole ? 0 : win.lo;
  const float4* sv = be.sv;
  const float* sscore = s.sscore;
  const float* f = row - row_lo;                       // indexed by v
  const uint8_t* excl = s.excl;
  auto key_of = [=](int i, int w, int j) {
    const int v = lo + j;
    const float4 q = sv[w];
    const int qlast = __float_as_int(q.z);
    float c = (v == qlast ? q.y : q.x) + f[v];
    if (kLM && v != blank)
      c = c + __ldg(lm + (size_t)(qlast + 1) * V + v);
    c = (__float_as_int(q.w) && !excl[i]) ? c : kDead;
    if (v == blank) c = sscore[w];
    return topk_key(c, kWhole ? (uint32_t)i : (uint32_t)(w * V + v));
  };
  select_walk<R>(key_of, s.W * Vw, Vw, s.W, s.sel);
}

// The ranks (every thread, after the barrier that follows window_walk):
// on_winner(k, key) for each k in [0, W), key the k-th of the frame's
// top-W.
template <int R, typename OnWinner>
__device__ __forceinline__ void window_rank(const Smem& s,
                                            OnWinner on_winner) {
  select_rank<kWarps, R>(s.W, s.sel, on_winner);
}

// The new state of a slot whose winner is `key` (global index w*V + v),
// from Beam `be`; `row` must hold f[v] at row[v - row_lo].
struct Slot {
  uint32_t h1, h2, hp1, hp2;
  int last, len, live;
  float s1, s2;
  int ys;   // the packed backpointer parent | char<<15 | appended<<30
};

template <bool kLM>
__device__ __forceinline__ Slot update(const Smem& s, const Beam& be,
                                       const float* row,
                                       unsigned long long key, int V,
                                       int blank, int row_lo,
                                       const float* __restrict__ lm) {
  const int idx = (int)key_index(key);
  const float top = key_value(key);
  const int w = idx / V, v = idx - w * V;
  const bool stay = v == blank;
  const bool nl = top > kLiveMin;
  const uint32_t vp1 = (uint32_t)(v + 1);
  const uint32_t h1 = be.h1()[w], h2 = be.h2()[w];
  const float4 q = be.sv[w];
  const int last = __float_as_int(q.z);
  float ext_pnb = (v == last ? q.y : q.x) + row[v - row_lo];
  if (kLM) {
    // a dead slot's row is clamped into the table (its value is unused)
    ext_pnb = ext_pnb + __ldg(lm + (size_t)clampi(last + 1, 0, V) * V + v);
  }
  Slot n;
  n.h1 = stay ? h1 : h1 * kM1 + vp1;
  n.h2 = stay ? h2 : h2 * kM2 + vp1;
  n.hp1 = stay ? be.hp1()[w] : h1;
  n.hp2 = stay ? be.hp2()[w] : h2;
  n.last = stay ? last : v;
  n.len = be.len()[w] + (stay ? 0 : 1);
  n.live = nl ? 1 : 0;
  n.s1 = (nl && stay) ? s.spb[w] : kNegInf;
  n.s2 = nl ? (stay ? s.spnb[w] : ext_pnb) : kNegInf;
  const int appended = (!stay && nl) ? 1 : 0;
  n.ys = w | ((n.last > 0 ? n.last : 0) << 15) | (appended << 30);
  return n;
}

// Slot k's fields, as stored in the packed [NF, B, W] state.
__device__ __forceinline__ int field(const Slot& n, int f) {
  switch (f) {
    case F_H1: return (int)n.h1;
    case F_H2: return (int)n.h2;
    case F_HP1: return (int)n.hp1;
    case F_HP2: return (int)n.hp2;
    case F_LAST: return n.last;
    case F_LEN: return n.len;
    case F_LIVE: return n.live;
    case F_S1: return __float_as_int(n.s1);
    default: return __float_as_int(n.s2);
  }
}

// Slot k of Beam `nx` takes the new state, with its per-frame values for
// the frame whose row is `next_row` (the whole vocab: f[last] is gathered
// from it).
__device__ __forceinline__ void commit(const Beam& nx, const Slot& n, int k,
                                       const float* next_row, int V) {
  nx.h1()[k] = n.h1;
  nx.h2()[k] = n.h2;
  nx.hp1()[k] = n.hp1;
  nx.hp2()[k] = n.hp2;
  nx.last()[k] = n.last;
  nx.len()[k] = n.len;
  nx.live()[k] = n.live;
  nx.s1()[k] = n.s1;
  nx.s2()[k] = n.s2;
  nx.sv[k] = make_float4(logaddexp(n.s1, n.s2), n.s1, __int_as_float(n.last),
                         __int_as_float(n.live));
  nx.flast[k] = next_row[clampi(n.last, 0, V - 1)];
  nx.k2[k] = n.h2 * 31u + (uint32_t)n.len;
}

}  // namespace frame
}  // namespace gasr
