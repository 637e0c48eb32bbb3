// Whole-scan CTC prefix beam-search decode, its backpointer traceback, and
// the streaming chunk's traceback with the base overlay.
//
// fused_prefix_decode replaces gasr_tpu/ops/pallas/fused_decode.py::
// fused_prefix_decode (`_kernel`, `_frame_math`); traceback replaces
// fused_decode.py::traceback_pallas (`_tb_kernel(fused=False)`);
// traceback_overlay replaces fused_decode.py::traceback_overlay_pallas
// (`_tb_kernel(fused=True)`). All are held equal to the eager decoder of
// gasr_tpu_torch/decoder/beam_search.py, whose expressions they copy one
// for one (built with -fmad=false so that no product is fused into a
// following sum that PyTorch computes as a separate op).
//
// Decode. Bound on the card: the data are small (log_probs in, 9.6 MB at
// T=200, B=256, V=47; ys out, 20.5 MB) and the arithmetic per frame is
// ~W*V adds and compares, so neither bytes nor operations bound it; what
// does is the serial chain per utterance (T frames, each a few block-wide
// phases separated by __syncthreads) and the instructions the block
// issues on each. Design: one thread block per utterance runs the whole T
// loop; the beam state lives in shared memory across all frames (twice,
// by frame parity: decode_frame.cuh's Beam) and is never written to
// device memory until the end; the candidate grid is never stored at all:
// each candidate's key is built in registers where it is compared; B
// blocks run side by side, 2 an SM, one wave at B = 256. Per frame, three
// block barriers (the phases of decode_frame.cuh, which the vocab-sharded
// kernels of decode_tp.cu share, on the whole vocab here):
//   0. the next frame's log-probs row is fetched into the other row
//      buffer with cp.async (waited for before the second barrier), and
//      the previous frame's packed backpointers go out from shared memory
//      in one coalesced row;
//   1. per stay slot w', its parent: a warp tests 32 candidate parents a
//      ballot; the stay candidate's scores; the absorbed extend's flag;
//      beside it, the seed of the selection's threshold;      | barrier
//   2. the filtered walk of the W x V candidates (topk.cuh): a key below
//      the threshold is dropped with one compare; the rest are merged into
//      each warp's sorted list;                                | barrier
//   3. every list key's rank; the thread that finds rank k < W builds slot
//      k's new state from the winner's key into the other Beam, with its
//      total, f[last] (from the fetched row) and k2 for the next frame,
//      and its packed backpointer parent | char<<15 | appended<<30.
//                                                              | barrier
// The lists hold R = list_regs(W) keys a lane (1, 2 or 4): at W = 16 and
// W = 64 the smaller lists are faster than R = 4 (PERF.md, row 2).
//
// Shallow fusion (kLM = true; fused_decode.py's `lm_q` variant). The
// table lm [V+1, V] (float32, already bf16-quantized by the caller) adds
// lm[last[w] + 1][v] to every extend candidate's score, in exactly the
// places where the extend score is formed: the seed's score of phase 1,
// the candidate key of phase 2 and the new p_nonblank of phase 3 (the same
// float additions in the same order, so they stay bit-equal); never to the
// absorbed extend's contribution to a stay. The TPU kernel reads the table
// through one-hot MXU contractions over lane- or row-split copies (a
// Mosaic workaround); here it is one __ldg per candidate in the seed and
// one in the walk. The table is 9 KB at V=47, 65 KB at
// V=129 and 261 KB at V=255, so it stays in L1/L2 after the first frames.
// The kLM = false instantiation is the kernel without the table.
//
// Traceback. Bound on the card: bytes (ys read, 20.5 MB; tokens and
// timesteps written, 52 MB at L=256). Design: one block per utterance
// (several where W > 128: at most 128 slots a block), one walking thread
// per slot. ys[t, b, :] is staged into shared memory by cp.async in
// chunks of TC frames taken from the end backwards, double-buffered (the
// earlier chunk lands while this one is walked), so each step's dependent
// load is a shared-memory load. A walk emits at pos-1 (dropped when < 0
// or >= L: head-keeping on overflow); the kept ones fill the positions
// below min(length, L) one by one, and each is collected on chip (token,
// frame) in its row's buffer. After the walk every warp writes whole
// rows, 16-byte stores along the positions, the -1 cells included: every
// cell of the two outputs is written once and nothing is filled before
// the kernel. A row's buffer holds min(L, T) emissions; where the rows do
// not fit the shared memory at once, the walk runs again for each window
// of positions (passes). The plan is (TC, G), the wrapper's
// `traceback_plan`; the buffer and the passes follow from (T, W, L) and
// the shared memory (`tb_passes`).
//
// Traceback with overlay (one streaming chunk). Bound on the card: bytes,
// the reorder copy of the two [B, W, L] buffers (at B=256, W=100, L=256:
// 2 x 26.2 MB read and 2 x 26.2 MB written; ys of a 20-frame chunk is
// 2 MB). Design: one warp per (b, w) row. All 32 lanes walk the chunk's
// Tc frames together (the same ys word each step, one broadcast load);
// lane 0 writes each emission at pos-1, timestep t + t_offset. The walk
// ends at the start slot p and at pos, and the emissions fill exactly
// [pos, final length) (less what falls outside [0, L)); the warp then
// copies every other position of its row from row p of the base buffers
// with coalesced 16-byte loads and stores (4-byte ones when L is not a
// multiple of 4 or a buffer is not 16-byte aligned). The written ranges
// are disjoint, so no ordering between lanes is needed. Many rows may
// read the same parent row; the outputs are fresh buffers the wrapper
// allocates, never the base (a later chunk reads them as its base, and a
// caller may still hold them as a snapshot).
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_frame.cuh"

namespace {

using namespace gasr::frame;

template <bool kLM, int R>
__global__ void __launch_bounds__(kThreads, 2)
fused_prefix_decode_kernel(const float* __restrict__ lp,
                           const int* __restrict__ init,
                           const float* __restrict__ lm, int T, int B, int W,
                           int V, int blank, int* __restrict__ ys,
                           int* __restrict__ fin) {
  extern __shared__ __align__(16) unsigned long long smem[];
  const Smem s = carve(smem, W, V);
  const Window all{0, V};
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* lpb = lp + (size_t)b * V;   // frame t's row at t * B * V
  int* ysb = ys + (size_t)b * W;           // frame t's row at t * B * W

  for (int i = tid; i < NF * W; i += blockDim.x) {
    const int f = i / W, w = i - f * W;
    s.beam[0].st[i] = init[((size_t)f * B + b) * W + w];
  }
  for (int i = tid; i < W * V; i += blockDim.x) s.excl[i] = 0;
  for (int v = tid; v < V; v += blockDim.x) s.frow[0][v] = lpb[v];
  __syncthreads();
  prep(s.beam[0], s.frow[0], V, 0, nullptr);
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const bool odd = t & 1;   // selects, not indexing: no local memory
    const Beam cur = odd ? s.beam[1] : s.beam[0];
    const Beam nxt = odd ? s.beam[0] : s.beam[1];
    const float* row = odd ? s.frow[1] : s.frow[0];
    float* next_row = odd ? s.frow[0] : s.frow[1];
    // ---- 0. prefetch row t+1; store ys of frame t-1
    if (t + 1 < T) cp_async_row(next_row, lpb + (size_t)(t + 1) * B * V, V);
    if (t > 0 && tid < W) ysb[(size_t)(t - 1) * B * W + tid] = s.ys[tid];
    // ---- 1. parent match, stays; seed of the threshold
    const int my_excl =
        match_seed<kLM, true>(s, cur, row, V, blank, row[blank], all, 0, lm);
    __syncthreads();
    // ---- 2. filtered walk over the candidate grid
    window_walk<kLM, true, R>(s, cur, row, V, blank, all, 0, lm);
    cp_async_wait();
    __syncthreads();
    // ---- 3. rank, update the winners into the other Beam
    window_rank<R>(s, [&](int k, unsigned long long key) {
        // -- update
        const Slot n = update<kLM>(s, cur, row, key, V, blank, 0, lm);
        s.ys[k] = n.ys;
        commit(nxt, n, k, next_row, V);
        // -- rank
    });
    if (my_excl >= 0) s.excl[my_excl] = 0;   // no reader until next frame
    __syncthreads();
  }

  // ---- epilogue
  if (T > 0 && tid < W) ysb[(size_t)(T - 1) * B * W + tid] = s.ys[tid];
  const Beam last = (T & 1) ? s.beam[1] : s.beam[0];
  for (int i = tid; i < NF * W; i += blockDim.x) {
    const int f = i / W, w = i - f * W;
    fin[((size_t)f * B + b) * W + w] = last.st[i];
  }
}

// Traceback, one block per (b, group of at most kTbRows slots): one
// walking thread a slot, every warp writing rows. Shared memory: two
// chunks of ys frames [TC][W], and each row's kept emissions in walk
// order (the q-th lands at position min(length, L) - 1 - q), CAP of them
// a pass: token | frame << 15 in 32 bits where T <= 2^17 (kWideT false),
// else a 16-bit token and a 32-bit frame.
constexpr int kTbThreads = 256;
constexpr int kTbRows = 128;             // rows a block at most
constexpr int kTbSmemMax = 232448;

__host__ __device__ inline int tb_entry_bytes(int T) {
  return T <= (1 << 17) ? 4 : 6;
}
__host__ __device__ inline size_t tb_stage_bytes(int W, int TC) {
  return 2 * (size_t)TC * W * sizeof(int);
}
// emissions a row a pass (CAP) and passes: every kept emission of a row
// (at most min(L, T)) in one pass where the shared memory holds them
__host__ __device__ inline void tb_passes(int T, int W, int L, int TC, int G,
                                          int* cap, int* npass) {
  const int rows = (W + G - 1) / G, need = min(L, T);
  const long long room = (long long)kTbSmemMax - (long long)tb_stage_bytes(W, TC);
  const long long fit = room / ((long long)rows * tb_entry_bytes(T));
  *cap = (int)min((long long)need, fit);
  *npass = need == 0 ? 1 : (*cap > 0 ? (need + *cap - 1) / *cap : 0);
}
__host__ __device__ inline size_t tb_smem(int T, int W, int L, int TC,
                                          int G) {
  int cap, npass;
  tb_passes(T, W, L, TC, G, &cap, &npass);
  const int rows = (W + G - 1) / G;
  return tb_stage_bytes(W, TC) +
         (size_t)rows * (cap > 0 ? cap : 1) * tb_entry_bytes(T);
}

// 4 or 16 bytes global -> shared, through L2
__device__ __forceinline__ void tb_copy(void* dst, const void* src,
                                        bool wide) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  if (wide)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}

template <bool kWideT>
__global__ void __launch_bounds__(kTbThreads)
traceback_kernel(const int* __restrict__ ys, const int* __restrict__ lengths,
                 int T, int B, int W, int L, int TC, int G, int cap,
                 int npass, int* __restrict__ tok, int* __restrict__ ts,
                 int* __restrict__ start_parent) {
  extern __shared__ __align__(16) int tb_smem_words[];
  const int b = blockIdx.x / G;
  const int rows = (W + G - 1) / G;
  const int r0 = (blockIdx.x % G) * rows;
  const int nr = min(rows, W - r0);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  constexpr int kWarps = kTbThreads / 32;
  int* frames = tb_smem_words;                             // [2][TC][W]
  uint32_t* em32 = reinterpret_cast<uint32_t*>(frames + 2 * TC * W);
  int* emt = reinterpret_cast<int*>(em32);                 // kWideT: [rows][cap]
  uint16_t* emk = reinterpret_cast<uint16_t*>(emt + rows * cap);   // frames,
  const bool wide = W % 4 == 0;                                   // tokens
  const int per_frame = wide ? W / 4 : W;
  const int nchunks = (T + TC - 1) / TC;
  const bool vec = L % 4 == 0;

  // chunk c holds frames [T - (c + 1) TC, T - c TC) (the first from 0)
  auto load = [&](int c) {
    const int hi = T - c * TC, lo = max(0, hi - TC);
    int* dst = frames + (c & 1) * TC * W;
    for (int i = tid; i < (hi - lo) * per_frame; i += kTbThreads) {
      const int f = i / per_frame, q = i - f * per_frame;
      const int e = wide ? 4 * q : q;
#ifndef GASR_PROBE_TB_NO_STAGE
      tb_copy(dst + f * W + e, ys + ((size_t)(lo + f) * B + b) * W + e, wide);
#endif
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  const bool walker = tid < nr;
  const int len = walker ? lengths[(size_t)b * W + r0 + tid] : 0;

  for (int pass = 0; pass < npass; ++pass) {
    // the walk: every frame from the end; the emissions of window
    // [pass cap, (pass + 1) cap) of this row's kept ones into shared memory
    const int q0 = pass * cap;
    int cur = r0 + tid, pos = len, q = 0;
    if (nchunks > 0) load(0);
    for (int c = 0; c < nchunks; ++c) {
      if (c + 1 < nchunks) {
        load(c + 1);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      __syncthreads();               // chunk c has landed for every thread
      if (walker) {                  // the dependent loads: shared memory
        const int hi = T - c * TC, lo = max(0, hi - TC);
        const int* fr = frames + (c & 1) * TC * W;
#ifndef GASR_PROBE_TB_NO_WALK
        for (int f = hi - lo - 1; f >= 0; --f) {
          const int packed = fr[f * W + cur];
          if ((packed >> 30) & 1) {
            const int e = pos - 1;
            if (e >= 0 && e < L) {   // kept: the q-th, at hi_end - 1 - q
              const int k = q - q0;
              if (k >= 0 && k < cap) {
                const int tk = (packed >> 15) & 0x7FFF;
                if (kWideT) {
                  emt[tid * cap + k] = lo + f;
                  emk[tid * cap + k] = (uint16_t)tk;
                } else {
                  em32[tid * cap + k] = (uint32_t)tk |
                                        ((uint32_t)(lo + f) << 15);
                }
              }
              ++q;
            }
            pos -= 1;
          }
#ifdef GASR_PROBE_TB_NO_STAGE
          cur = (packed & 0x7FFF) % W;   // unstaged words: keep the index
#else                                    // in the buffer (time only)
          cur = packed & 0x7FFF;
#endif
        }
#endif
      }
      __syncthreads();               // chunk c walked: its buffer is free
    }
    if (walker && pass == npass - 1) start_parent[(size_t)b * W + r0 + tid] =
        cur;
    // each row's window once, a warp a row, 4 positions a lane (16-byte
    // stores where L % 4 == 0): position p holds kept emission
    // q = hi_end - 1 - p if q < the kept count, else -1; the cells at or
    // past hi_end get -1 in the first pass, those below the last window in
    // the last
    if (walker) frames[tid] = q;     // the kept count (the chunks are done)
    __syncthreads();
    for (int r = warp; r < nr; r += kWarps) {
      const int n = frames[r];
      const int he = min(max(lengths[(size_t)b * W + r0 + r], 0), L);
      // (the last pass also takes the cells below the window: no kept
      // emission reaches them when the length is past T)
      const int plo = pass == npass - 1 ? 0 : max(he - (pass + 1) * cap, 0);
      const int phi = pass == 0 ? L : he - pass * cap;
      const size_t row = ((size_t)b * W + r0 + r) * L;
      auto value = [&](int p, int& tv, int& sv) {
        const int qq = he - 1 - p;
        if (p >= he || qq >= n) {
          tv = -1;
          sv = -1;
        } else if (kWideT) {
          tv = emk[r * cap + qq - q0];
          sv = emt[r * cap + qq - q0];
        } else {
          const uint32_t v = em32[r * cap + qq - q0];
          tv = (int)(v & 0x7FFF);
          sv = (int)(v >> 15);
        }
      };
#ifndef GASR_PROBE_TB_NO_WRITES
      if (vec) {
        for (int p4 = (plo & ~3) + 4 * lane; p4 < phi; p4 += 128) {
          if (p4 >= plo && p4 + 4 <= phi) {
            int tv[4], sv[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) value(p4 + e, tv[e], sv[e]);
            *reinterpret_cast<int4*>(tok + row + p4) =
                make_int4(tv[0], tv[1], tv[2], tv[3]);
            *reinterpret_cast<int4*>(ts + row + p4) =
                make_int4(sv[0], sv[1], sv[2], sv[3]);
          } else {
            for (int e = 0; e < 4; ++e)
              if (p4 + e >= plo && p4 + e < phi) {
                int tv, sv;
                value(p4 + e, tv, sv);
                tok[row + p4 + e] = tv;
                ts[row + p4 + e] = sv;
              }
          }
        }
      } else {
        for (int p = plo + lane; p < phi; p += 32) {
          int tv, sv;
          value(p, tv, sv);
          tok[row + p] = tv;
          ts[row + p] = sv;
        }
      }
#endif
    }
    __syncthreads();                 // the emissions are written
  }
}

template <bool kVec>
__global__ void traceback_overlay_kernel(
    const int* __restrict__ ys, const int* __restrict__ lengths,
    const int* __restrict__ base_tok, const int* __restrict__ base_ts,
    int Tc, int B, int W, int L, int t_offset, int* __restrict__ tok,
    int* __restrict__ ts, int* __restrict__ start_parent) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= B * W) return;   // whole warps leave together
  const int b = row / W;
  int* trow = tok + (size_t)row * L;
  int* srow = ts + (size_t)row * L;
  const int len = lengths[row];
  int cur = row - b * W;
  int pos = len;
  for (int t = Tc - 1; t >= 0; --t) {
    const int packed = ys[((size_t)t * B + b) * W + cur];
    if ((packed >> 30) & 1) {
      const int e = pos - 1;
      if (lane == 0 && e >= 0 && e < L) {
        trow[e] = (packed >> 15) & 0x7FFF;
        srow[e] = t + t_offset;
      }
      pos -= 1;
    }
    cur = packed & 0x7FFF;
  }
  if (lane == 0) start_parent[row] = cur;

  // the walk wrote [lo, hi) (within [0, L)); the rest is base row `cur`
  const int lo = pos, hi = len;
  const size_t src = ((size_t)b * W + cur) * L;
  if (kVec) {
    const int4* bt = reinterpret_cast<const int4*>(base_tok + src);
    const int4* bs = reinterpret_cast<const int4*>(base_ts + src);
    int4* to = reinterpret_cast<int4*>(trow);
    int4* so = reinterpret_cast<int4*>(srow);
    for (int q = lane; q < (L >> 2); q += 32) {
      const int p0 = q << 2;
      const int4 a = __ldg(bt + q);
      const int4 c = __ldg(bs + q);
      if (p0 + 4 <= lo || p0 >= hi) {
        to[q] = a;
        so[q] = c;
      } else {
        const int av[4] = {a.x, a.y, a.z, a.w};
        const int cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (p0 + k < lo || p0 + k >= hi) {
            trow[p0 + k] = av[k];
            srow[p0 + k] = cv[k];
          }
        }
      }
    }
  } else {
    for (int p = lane; p < L; p += 32) {
      if (p < lo || p >= hi) {
        trow[p] = base_tok[src + p];
        srow[p] = base_ts[src + p];
      }
    }
  }
}

}  // namespace

// The instantiation for (lm, W): the lists hold list_regs(W) keys a lane.
static const void* pick_kernel(bool lm, int W) {
  switch (list_regs(W)) {
    case 1: return lm ? (const void*)fused_prefix_decode_kernel<true, 1>
                      : (const void*)fused_prefix_decode_kernel<false, 1>;
    case 2: return lm ? (const void*)fused_prefix_decode_kernel<true, 2>
                      : (const void*)fused_prefix_decode_kernel<false, 2>;
    default: return lm ? (const void*)fused_prefix_decode_kernel<true, 4>
                       : (const void*)fused_prefix_decode_kernel<false, 4>;
  }
}

static cudaError_t prepare(const void* k, int W, int V, size_t* smem) {
  *smem = smem_bytes(W, V, V);
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

// lm: the [V+1, V] float32 table, or NULL for the decode without an LM
extern "C" int fused_prefix_decode_launch(const float* lp, const int* init,
                                          const float* lm, int T, int B,
                                          int W, int V, int blank, int* ys,
                                          int* fin, cudaStream_t stream) {
  if (W < 1 || W > gasr::kListLen) return (int)cudaErrorInvalidValue;
  const void* k = pick_kernel(lm != nullptr, W);
  size_t smem = 0;
  cudaError_t err = prepare(k, W, V, &smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&lp, &init, &lm, &T, &B, &W, &V, &blank, &ys, &fin};
  err = cudaLaunchKernel(k, dim3(B), dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// What the launch at (W, V, lm) gets: blocks an SM (the occupancy query),
// registers a thread (cudaFuncGetAttributes) and the dynamic shared memory
// a block that the launch requests.
extern "C" int fused_prefix_decode_info(int W, int V, int lm, int* blocks,
                                        int* regs, int* smem_requested) {
  if (W < 1 || W > gasr::kListLen) return (int)cudaErrorInvalidValue;
  const void* k = pick_kernel(lm != 0, W);
  size_t smem = 0;
  cudaError_t err = prepare(k, W, V, &smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, kThreads,
                                                        smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, k);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *smem_requested = (int)smem;
  return 0;
}

// Shared memory of a traceback block at (T, W, L, chunks of TC frames, G
// blocks an utterance); 0 where a row's emissions cannot fit one at a
// time.
extern "C" int traceback_smem(int T, int W, int L, int TC, int G) {
  if (W < 1 || TC < 1 || G < 1 || T < 0 || L < 0) return 0;
  int cap, npass;
  tb_passes(T, W, L, TC, G, &cap, &npass);
  if (npass == 0) return 0;
  const size_t n = tb_smem(T, W, L, TC, G);
  return n > 0x7fffffff ? 0x7fffffff : (int)n;
}

// The whole traceback in one launch of B G blocks, chunks of TC frames;
// every cell of tok and ts is written once by the kernel (no fill before).
extern "C" int traceback_launch(const int* ys, const int* lengths, int T,
                                int B, int W, int L, int TC, int G, int* tok,
                                int* ts, int* start_parent,
                                cudaStream_t stream) {
  if (TC < 1 || G < 1 || (W + G - 1) / G > kTbRows || T < 0 || L < 0)
    return (int)cudaErrorInvalidValue;
  int cap, npass;
  tb_passes(T, W, L, TC, G, &cap, &npass);
  const size_t smem = tb_smem(T, W, L, TC, G);
  if (npass == 0 || smem > (size_t)kTbSmemMax)
    return (int)cudaErrorInvalidValue;
  const bool wide_t = tb_entry_bytes(T) > 4;
  const void* k = wide_t ? (const void*)traceback_kernel<true>
                         : (const void*)traceback_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&ys, &lengths, &T, &B, &W, &L, &TC, &G, &cap, &npass,
                  &tok, &ts, &start_parent};
  err = cudaLaunchKernel(k, dim3(B * G), dim3(kTbThreads), args, smem,
                         stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int traceback_overlay_launch(const int* ys, const int* lengths,
                                        const int* base_tok,
                                        const int* base_ts, int Tc, int B,
                                        int W, int L, int t_offset, int* tok,
                                        int* ts, int* start_parent,
                                        cudaStream_t stream) {
  const int threads = 256;               // 8 warps, one row each
  const int rows_per_block = threads / 32;
  const int blocks = (B * W + rows_per_block - 1) / rows_per_block;
  const bool vec = (L % 4 == 0) &&
                   ((reinterpret_cast<uintptr_t>(base_tok) |
                     reinterpret_cast<uintptr_t>(base_ts) |
                     reinterpret_cast<uintptr_t>(tok) |
                     reinterpret_cast<uintptr_t>(ts)) % 16 == 0);
  if (vec) {
    traceback_overlay_kernel<true><<<blocks, threads, 0, stream>>>(
        ys, lengths, base_tok, base_ts, Tc, B, W, L, t_offset, tok, ts,
        start_parent);
  } else {
    traceback_overlay_kernel<false><<<blocks, threads, 0, stream>>>(
        ys, lengths, base_tok, base_ts, Tc, B, W, L, t_offset, tok, ts,
        start_parent);
  }
  return (int)cudaGetLastError();
}
