// Vocab-sharded (tensor-parallel) CTC prefix beam search: one shard's
// frame, and the whole scan with the per-frame winner exchange.
//
// tp_frame replaces gasr_tpu/ops/pallas/fused_decode.py::fused_tp_frame
// (`_tp_kernel`, `_frame_math(tp=...)`); tp_scan replaces
// fused_decode.py::fused_tp_scan (`_tp_scan_kernel`, `_merge2_top`). Both
// run the frame phases of decode_frame.cuh, the ones the single-card
// decode (fused_decode.cu) runs, on the shard's vocab window [lo, hi) =
// [s*V/n, (s+1)*V/n): the W x (hi - lo) extends there and, on the shard
// that owns the blank, the W stays (they sit in the blank column). The
// W x W parent match is replicated on every shard.
//
// Exactness. Every candidate (w, v) gets the single-card key
// topk_key(score, w*V + v): unique, ordered by (score desc, global index
// asc), the order of lax.top_k on the single-card grid. Each candidate
// lives on exactly one shard, and the global top-W lie in the union of
// the shards' top-Ws, so the global top-W are the W largest keys of that
// union: a merge of n sorted key lists (topk.cuh's warp_merge128), with
// no value reconstruction and no lexicographic sort. The state update of
// the merged winners is decode_frame.cuh's, so the decode is bit-equal to
// fused_prefix_decode by construction.
//
// tp_frame: one block per utterance, one frame, one shard. The window's
// log-probs, f[last] and f[blank] come in from outside (the caller
// gathers them from the full row), which keeps the kernel independent of
// V: any vocab with ceil(V/n) <= 128. It writes the shard's W winners'
// keys (sign bit flipped, so int64 order is key order), their packed
// backpointers and their updated fields. Bound on the card: bytes; at
// B=256, W=100, n=4 a launch reads the state (0.92 MB), f[last] and the
// window and writes the fields, ys and keys (about 1.3 MB), under a
// microsecond at 3.35 TB/s, so the launch and the block's barrier chain
// bound it. Design: the frame phases as in the single-card kernel, the
// absorbed-extend flags over W x (hi - lo) cells only.
//
// tp_scan: all T frames of every shard in one launch per card, the beam
// state in shared memory as in fused_prefix_decode. Per frame a block
// takes its window's top-W, publishes the W keys (exchange.cuh), waits
// for its n - 1 peers, merges the n lists and updates its state from the
// merged keys; the full frame row (V <= 256) sits in shared memory, so
// every shard's update reads f[v] of any winner. The payload is the W
// keys, 8 bytes each: the fields follow from the replicated state.
// Persistent grid: n_local shards x G blocks, block (s, g) walks
// utterances g, g + G, ...; every shard's block g walks them in the same
// order, so the n blocks of a group exchange with each other only, and the
// grid is launched cooperatively (co-resident or refused). At n = 1 no
// exchange code runs. Bound on the card: neither bytes (log-probs 9.6 MB,
// ys 20.5 MB, the exchanged keys 0.16 GB written and read n - 1 times at
// T=200, B=256, W=100, n=4) nor operations; the serial chain of block
// phases per frame and the wait for the slowest peer bound it, and with
// fewer resident blocks than utterances x shards each block walks several
// utterances in turn.
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_frame.cuh"
#include "exchange.cuh"

namespace {

using namespace gasr::frame;
using gasr::xchg::Exchange;

constexpr unsigned long long kSignBit = 1ull << 63;

template <int R>
__global__ void __launch_bounds__(kThreads, 2)
tp_frame_kernel(const float* __restrict__ f_loc, int ld,
                const float* __restrict__ f_last,
                const float* __restrict__ f_blank,
                const int* __restrict__ state, int B, int W, int V, int lo,
                int hi, int blank, int* __restrict__ ys,
                unsigned long long* __restrict__ keys,
                int* __restrict__ fin) {
  extern __shared__ __align__(16) unsigned long long smem[];
  const Window win{lo, hi};
  const int Vw = win.len();
  const Smem s = carve(smem, W, Vw);
  const Beam be = s.beam[0];
  const float* row = s.frow[0];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;

  for (int i = tid; i < NF * W; i += blockDim.x) {
    const int f = i / W, w = i - f * W;
    be.st[i] = state[((size_t)f * B + b) * W + w];
  }
  for (int i = tid; i < W * Vw; i += blockDim.x) s.excl[i] = 0;
  for (int j = tid; j < Vw; j += blockDim.x)
    s.frow[0][j] = f_loc[(size_t)b * ld + j];
  __syncthreads();
  prep(be, row, V, lo, f_last + (size_t)b * W);
  __syncthreads();
  match_seed<false, false>(s, be, row, V, blank, f_blank[b], win, lo,
                           nullptr);
  __syncthreads();
  window_walk<false, false, R>(s, be, row, V, blank, win, lo, nullptr);
  __syncthreads();
  window_rank<R>(s, [&](int k, unsigned long long key) { s.top[k] = key; });
  __syncthreads();
  if (tid < W) {
    const unsigned long long key = s.top[tid];
    const Slot n = update<false>(s, be, row, key, V, blank, lo, nullptr);
    const size_t o = (size_t)b * W + tid;
    ys[o] = n.ys;
    keys[o] = key ^ kSignBit;
#pragma unroll
    for (int f = 0; f < NF; ++f)
      fin[((size_t)f * B + b) * W + tid] = field(n, f);
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads, 2)
tp_scan_kernel(const float* __restrict__ lp, const int* __restrict__ init,
               int T, int B, int W, int V, int blank,
               const int* __restrict__ shards, Exchange x,
               int* __restrict__ ys, int* __restrict__ fin) {
  extern __shared__ __align__(16) unsigned long long smem[];
  const Smem s = carve(smem, W, V);
  const int local = blockIdx.x / x.G;
  const int g = blockIdx.x - local * x.G;
  const int sh = shards[local];
  const Window win{(int)((long long)sh * V / x.n),
                   (int)((long long)(sh + 1) * V / x.n)};
  const int tid = threadIdx.x;
  const bool writes_ys = sh == 0 && ys != nullptr;

  for (int i = tid; i < W * win.len(); i += blockDim.x) s.excl[i] = 0;
  unsigned step = 0;
  for (int b = g; b < B; b += x.G) {
    const float* lpb = lp + (size_t)b * V;   // frame t's row at t * B * V
    for (int i = tid; i < NF * W; i += blockDim.x) {
      const int f = i / W, w = i - f * W;
      s.beam[0].st[i] = init[((size_t)f * B + b) * W + w];
    }
    for (int v = tid; v < V; v += blockDim.x) s.frow[0][v] = lpb[v];
    __syncthreads();
    prep(s.beam[0], s.frow[0], V, 0, nullptr);
    __syncthreads();
    for (int t = 0; t < T; ++t) {
      ++step;
      const bool odd = t & 1;   // selects, not indexing: no local memory
      const Beam cur = odd ? s.beam[1] : s.beam[0];
      const Beam nxt = odd ? s.beam[0] : s.beam[1];
      const float* row = odd ? s.frow[1] : s.frow[0];
      float* next_row = odd ? s.frow[0] : s.frow[1];
      if (t + 1 < T) cp_async_row(next_row, lpb + (size_t)(t + 1) * B * V, V);
      const int my_excl =
          match_seed<false, false>(s, cur, row, V, blank, row[blank], win, 0,
                                   nullptr);
      __syncthreads();
      window_walk<false, false, R>(s, cur, row, V, blank, win, 0, nullptr);
      cp_async_wait();
      __syncthreads();
      window_rank<R>(s, [&](int k, unsigned long long key) { s.top[k] = key; });
      if (my_excl >= 0) s.excl[my_excl] = 0;   // no reader until next frame
      __syncthreads();
      if (x.n > 1) {
        gasr::xchg::publish_and_wait(x, sh, g, step, s.top);
        gasr::xchg::merge(x, sh, g, step, s.top);
      }
      if (tid < W) {
        const Slot n = update<false>(s, cur, row, s.top[tid], V, blank, 0,
                                     nullptr);
        if (writes_ys) ys[((size_t)t * B + b) * W + tid] = n.ys;
        commit(nxt, n, tid, next_row, V);
      }
      __syncthreads();
    }
    const Beam last = (T & 1) ? s.beam[1] : s.beam[0];
    for (int i = tid; i < NF * W; i += blockDim.x) {
      const int f = i / W, w = i - f * W;
      fin[(((size_t)local * NF + f) * B + b) * W + w] = last.st[i];
    }
    __syncthreads();   // the next utterance's state overwrites beam[0]
  }
}

// The instantiations for W: the lists hold list_regs(W) keys a lane.
const void* pick_frame(int W) {
  switch (list_regs(W)) {
    case 1: return (const void*)tp_frame_kernel<1>;
    case 2: return (const void*)tp_frame_kernel<2>;
    default: return (const void*)tp_frame_kernel<4>;
  }
}

const void* pick_scan(int W) {
  switch (list_regs(W)) {
    case 1: return (const void*)tp_scan_kernel<1>;
    case 2: return (const void*)tp_scan_kernel<2>;
    default: return (const void*)tp_scan_kernel<4>;
  }
}

cudaError_t set_smem(const void* kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

size_t scan_smem(int W, int V, int n) {
  return smem_bytes(W, V, (V + n - 1) / n);
}

}  // namespace

// One shard's frame. f_loc: the window's log-probs, row b at f_loc + b*ld;
// f_last [B, W]; f_blank [B]; state [NF, B, W] -> ys [B, W], keys [B, W]
// (sign bit flipped), fin [NF, B, W].
extern "C" int tp_frame_launch(const float* f_loc, int ld, const float* f_last,
                               const float* f_blank, const int* state, int B,
                               int W, int V, int lo, int hi, int blank,
                               int* ys, unsigned long long* keys, int* fin,
                               cudaStream_t stream) {
  if (W < 1 || W > gasr::kListLen || hi <= lo || lo < 0 || hi > V)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(W, hi - lo, hi - lo);
  const void* k = pick_frame(W);
  cudaError_t err = set_smem(k, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&f_loc, &ld,  &f_last, &f_blank, &state, &B,   &W,
                  &V,     &lo,  &hi,     &blank,   &ys,    &keys, &fin};
  err = cudaLaunchKernel(k, dim3(B), dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many tp_scan blocks the current card holds at once, for a mesh of n
// model shards.
extern "C" int tp_scan_capacity(int W, int V, int n, int* blocks) {
  const size_t smem = scan_smem(W, V, n);
  const void* k = pick_scan(W);
  cudaError_t err = set_smem(k, smem);
  if (err == cudaSuccess)
    err = gasr::xchg::resident_blocks(k, kThreads, smem, blocks);
  return (int)err;
}

// The whole scan for the n_local shards `shards` (device array) of an
// n-shard group that live on the current card, G blocks each. outbox /
// flags: device arrays of n pointers (shard s's [2, G, W] keys and [G]
// zeroed flags, on any card of the host). init [NF, B, W]; ys [T, B, W]
// (written by shard 0's blocks; null where shard 0 is not on this card);
// fin [n_local, NF, B, W].
extern "C" int tp_scan_launch(const float* lp, const int* init, int T, int B,
                              int W, int V, int blank, int n,
                              const int* shards, int n_local, int G,
                              unsigned long long* const* outbox,
                              unsigned* const* flags, int* ys, int* fin,
                              cudaStream_t stream) {
  if (W < 1 || W > gasr::kListLen || n < 1 || n > V || G < 1 || n_local < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = scan_smem(W, V, n);
  const void* k = pick_scan(W);
  cudaError_t err = set_smem(k, smem);
  if (err != cudaSuccess) return (int)err;
  Exchange x{outbox, flags, n, G, W};
  void* args[] = {&lp, &init, &T, &B, &W, &V, &blank, &shards, &x, &ys, &fin};
  err = cudaLaunchCooperativeKernel(k,
                                    dim3(n_local * G), dim3(kThreads), args,
                                    smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Let the current card read and write `peer`'s memory (the outboxes and
// flags of shards on another card of the host).
extern "C" int enable_peer_access(int peer) {
  cudaError_t err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();   // clear the sticky-free error state
    return 0;
  }
  return (int)err;
}
