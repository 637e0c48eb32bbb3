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
// timesteps written, 52 MB at L=256). Design: the -1 fill of both outputs
// is a coalesced memset; then one thread per (b, w) walks t = T-1..0,
// reading one ys word per frame and writing each emission at position
// pos-1 (dropped when < 0 or >= L: head-keeping on overflow).
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

__global__ void traceback_kernel(const int* __restrict__ ys,
                                 const int* __restrict__ lengths, int T,
                                 int B, int W, int L, int* __restrict__ tok,
                                 int* __restrict__ ts,
                                 int* __restrict__ start_parent) {
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= B * W) return;
  const int b = gid / W;
  int* trow = tok + (size_t)gid * L;
  int* srow = ts + (size_t)gid * L;
  int cur = gid - b * W;
  int pos = lengths[gid];
  for (int t = T - 1; t >= 0; --t) {
    const int packed = ys[((size_t)t * B + b) * W + cur];
    const int appended = (packed >> 30) & 1;
    if (appended) {
      const int e = pos - 1;
      if (e >= 0 && e < L) {
        trow[e] = (packed >> 15) & 0x7FFF;
        srow[e] = t;
      }
      pos -= 1;
    }
    cur = packed & 0x7FFF;
  }
  start_parent[gid] = cur;
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

extern "C" int traceback_launch(const int* ys, const int* lengths, int T,
                                int B, int W, int L, int* tok, int* ts,
                                int* start_parent, cudaStream_t stream) {
  const size_t bytes = (size_t)B * W * L * sizeof(int);
  cudaError_t err = cudaMemsetAsync(tok, 0xFF, bytes, stream);  // -1 fill
  if (err == cudaSuccess) err = cudaMemsetAsync(ts, 0xFF, bytes, stream);
  if (err != cudaSuccess) return (int)err;
  const int threads = 128;
  const int blocks = (B * W + threads - 1) / threads;
  traceback_kernel<<<blocks, threads, 0, stream>>>(ys, lengths, T, B, W, L,
                                                   tok, ts, start_parent);
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
