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
// Phases of a frame (each ends with a block barrier):
//   slot_prep   per slot: the total score, f[last] and the folded match
//               key k2 = 31*h2 + length;
//   match_stay  per stay slot w': the first live w with h1[w] == hp1[w']
//               and k2[w] == 31*hp2[w'] + length[w'] - 1 (W x W compare),
//               the stay candidate's scores, and a flag on the extend
//               (w, last[w']) that the stay absorbs, where last[w'] lies
//               in the window;
//   window_top  the block top-W of the window's W x (hi - lo) candidates,
//               keyed by the global index w*V + v (topk.cuh: score
//               descending, index ascending); the stay sits in the blank
//               column, so only a window holding the blank offers stays;
//   update      the new state of the slot that a winner's key names.
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
constexpr int kThreads = 512;   // 16 warps: a power of two (block_top128)

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

// Shared memory of one block: W slots, a frame row of row_len log-probs,
// absorbed-extend flags for W x win_len window cells.
__host__ __device__ inline size_t smem_bytes(int W, int row_len,
                                             int win_len) {
  return (size_t)(kThreads / 32) * kListLen * sizeof(unsigned long long) +
         (size_t)(NF * W + row_len + 6 * W) * sizeof(int) +
         (size_t)W * win_len;
}

struct Smem {
  unsigned long long* lists;   // [16][kListLen]: block top-W scratch
  int* st;                     // [NF][W] beam state
  float* frow;                 // [row_len] frame row
  float* total;                // [W] logaddexp(p_blank, p_nonblank)
  float* flast;                // [W] f[last]
  float* spb;                  // [W] stay p_blank
  float* spnb;                 // [W] stay p_nonblank
  float* sscore;               // [W] stay score
  uint32_t* k2;                // [W]
  uint8_t* excl;               // [W * win_len] absorbed extends

  __device__ uint32_t* h1() const { return (uint32_t*)(st + F_H1 * W); }
  __device__ uint32_t* h2() const { return (uint32_t*)(st + F_H2 * W); }
  __device__ uint32_t* hp1() const { return (uint32_t*)(st + F_HP1 * W); }
  __device__ uint32_t* hp2() const { return (uint32_t*)(st + F_HP2 * W); }
  __device__ int* last() const { return st + F_LAST * W; }
  __device__ int* len() const { return st + F_LEN * W; }
  __device__ int* live() const { return st + F_LIVE * W; }
  __device__ float* s1() const { return (float*)(st + F_S1 * W); }
  __device__ float* s2() const { return (float*)(st + F_S2 * W); }
  int W;
};

__device__ __forceinline__ Smem carve(void* base, int W, int row_len) {
  Smem s;
  s.W = W;
  s.lists = reinterpret_cast<unsigned long long*>(base);
  s.st = reinterpret_cast<int*>(s.lists + (kThreads / 32) * kListLen);
  s.frow = reinterpret_cast<float*>(s.st + NF * W);
  s.total = s.frow + row_len;
  s.flast = s.total + W;
  s.spb = s.flast + W;
  s.spnb = s.spb + W;
  s.sscore = s.spnb + W;
  s.k2 = reinterpret_cast<uint32_t*>(s.sscore + W);
  s.excl = reinterpret_cast<uint8_t*>(s.k2 + W);
  return s;
}

// The vocab window a block scores: global ids [lo, hi).
struct Window {
  int lo, hi;
  __device__ int len() const { return hi - lo; }
};

// Per slot: total, f[last] (from the row when f_last is null, which needs
// the row to cover the vocab; else f_last[w]) and k2. After the row is
// in shared memory and a barrier.
__device__ __forceinline__ void slot_prep(const Smem& s, int V, int row_lo,
                                          const float* f_last) {
  const int tid = threadIdx.x;
  if (tid < s.W) {
    s.total[tid] = logaddexp(s.s1()[tid], s.s2()[tid]);
    s.flast[tid] = f_last ? f_last[tid]
                          : s.frow[clampi(s.last()[tid], 0, V - 1) - row_lo];
    s.k2[tid] = s.h2()[tid] * 31u + (uint32_t)s.len()[tid];
  }
  __syncthreads();
}

// Parent match and stay candidates (thread = stay slot w'); f_blank is
// f[blank]. Returns the window cell whose flag this thread raised, or -1.
__device__ __forceinline__ int match_stay(const Smem& s, int V, int blank,
                                          float f_blank, Window win) {
  const int tid = threadIdx.x;
  const int W = s.W;
  int my_excl = -1;
  if (tid < W) {
    const uint32_t* h1 = s.h1();
    const int* last = s.last();
    const int* len = s.len();
    const int* live = s.live();
    const float* s1 = s.s1();
    const float* s2 = s.s2();
    const int wp = tid;
    int m = -1;
    if (live[wp]) {
      const uint32_t want1 = s.hp1()[wp];
      const uint32_t want2 = s.hp2()[wp] * 31u + (uint32_t)(len[wp] - 1);
      for (int w = 0; w < W; ++w) {
        if (live[w] && h1[w] == want1 && s.k2[w] == want2) {
          m = w;
          break;
        }
      }
    }
    const float fl = s.flast[wp];
    const float stay_pb = s.total[wp] + f_blank;
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
  __syncthreads();
  return my_excl;
}

// The block top-W of the window's candidates into s.lists[0, kListLen).
// lm: the shallow-fusion table [V+1, V] (kLM only). kWhole: the window is
// the whole vocab and the row starts at 0 (the single-card decode), so a
// candidate's grid index i is its global index.
template <bool kLM, bool kWhole>
__device__ __forceinline__ void window_top(const Smem& s, int V, int blank,
                                           Window win, int row_lo,
                                           const float* __restrict__ lm) {
  const int Vw = kWhole ? V : win.len();
  const int lo = kWhole ? 0 : win.lo;
  const int* last = s.last();
  const int* live = s.live();
  const float* s1 = s.s1();
  const float* total = s.total;
  const float* sscore = s.sscore;
  const float* frow = s.frow - (kWhole ? 0 : row_lo);   // indexed by v
  const uint8_t* excl = s.excl;
  auto key_of = [=](int i) {
    const int w = i / Vw, v = lo + (i - w * Vw);
    float c;
    if (v == blank) {
      c = sscore[w];
    } else if (live[w] && !excl[i]) {
      c = (v == last[w] ? s1[w] : total[w]) + frow[v];
      if (kLM) c = c + __ldg(lm + (size_t)(last[w] + 1) * V + v);
    } else {
      c = kDead;
    }
    return topk_key(c, kWhole ? (uint32_t)i : (uint32_t)(w * V + v));
  };
  block_top128(key_of, s.W * Vw, s.lists);
}

// The new state of a slot whose winner is `key` (global index w*V + v);
// the row must hold f[v].
struct Slot {
  uint32_t h1, h2, hp1, hp2;
  int last, len, live;
  float s1, s2;
  int ys;   // the packed backpointer parent | char<<15 | appended<<30
};

template <bool kLM>
__device__ __forceinline__ Slot update(const Smem& s, unsigned long long key,
                                       int V, int blank, int row_lo,
                                       const float* __restrict__ lm) {
  const int idx = (int)key_index(key);
  const float top = key_value(key);
  const int w = idx / V, v = idx - w * V;
  const bool stay = v == blank;
  const bool nl = top > kLiveMin;
  const uint32_t vp1 = (uint32_t)(v + 1);
  const uint32_t h1 = s.h1()[w], h2 = s.h2()[w];
  const int last = s.last()[w];
  float ext_pnb = (v == last ? s.s1()[w] : s.total[w]) + s.frow[v - row_lo];
  if (kLM) {
    // a dead slot's row is clamped into the table (its value is unused)
    ext_pnb = ext_pnb + __ldg(lm + (size_t)clampi(last + 1, 0, V) * V + v);
  }
  Slot n;
  n.h1 = stay ? h1 : h1 * kM1 + vp1;
  n.h2 = stay ? h2 : h2 * kM2 + vp1;
  n.hp1 = stay ? s.hp1()[w] : h1;
  n.hp2 = stay ? s.hp2()[w] : h2;
  n.last = stay ? last : v;
  n.len = s.len()[w] + (stay ? 0 : 1);
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

// Slot k takes the new state (after every reader of the old one passed a
// barrier).
__device__ __forceinline__ void commit(const Smem& s, const Slot& n, int k) {
  s.h1()[k] = n.h1;
  s.h2()[k] = n.h2;
  s.hp1()[k] = n.hp1;
  s.hp2()[k] = n.hp2;
  s.last()[k] = n.last;
  s.len()[k] = n.len;
  s.live()[k] = n.live;
  s.s1()[k] = n.s1;
  s.s2()[k] = n.s2;
}

}  // namespace frame
}  // namespace gasr
