// Vocab-sharded (tensor-parallel) CTC prefix beam search: the per-frame
// kernel (tp_frame) and the whole scan (tp_scan) in two designs.
//
// tp_frame replaces gasr_tpu/ops/pallas/fused_decode.py::fused_tp_frame
// (`_tp_kernel`, `_frame_math(tp=...)`); tp_scan replaces
// fused_decode.py::fused_tp_scan (`_tp_scan_kernel`, `_merge2_top`). Both
// run the frame phases of decode_frame.cuh, the ones the single-card
// decode (fused_decode.cu) runs, on the shard's vocab window [lo, hi) =
// [s*V/n, (s+1)*V/n): the W x (hi - lo) extends there and, on the shard
// that owns the blank, the W stays (they sit in the blank column).
//
// Exactness. Every candidate (w, v) gets the single-card key
// topk_key(score, w*V + v): unique, ordered by (score desc, global index
// asc), the order of lax.top_k on the single-card grid. Each candidate
// lives on exactly one shard, and the global top-W lie in the union of
// the shards' top-Ws, so the global top-W are the W largest keys of that
// union: exchange.cuh's merge of n sorted key lists, with no value
// reconstruction. The state update of the merged winners is
// decode_frame.cuh's, so the decode is bit-equal to fused_prefix_decode
// by construction.
//
// tp_frame: one launch a card a frame, the host loop holding nothing
// else. Block (b, local shard s) starts the frame by merging the previous
// frame's n lists (keys, packed backpointers and fields, from a [2, n,
// ...] parity buffer on its card; replicated, as JAX's all_gather
// replicates): the merged fields are the beam, the merged backpointers
// the previous frame's ys (written by shard 0's block). It reads the
// frame's full row itself (f[last], f[blank], its window), runs the frame
// phases on its window and writes its W winners (keys with the sign bit
// flipped, backpointers, updated fields) into the buffer of every card of
// the group (peer pointers); the host orders frames across cards with
// events. A merge-only launch closes the scan. The JAX-shaped single
// frame (`tp_frame_launch` with no input keys: the state is the one input
// list; f[last], f[blank] and the window given) is its special case.
// Bound on the card: bytes; at B=256, W=100, n=4 a launch reads the four
// lists (1.3 MB) and the rows and writes its lists (1.3 MB a card):
// under a microsecond at 3.35 TB/s, so the launch and the block's chain
// of barriers bound it; the design takes the host out (about 25 eager
// ops a frame went) and leaves one launch a card a frame.
//
// tp_scan: all T frames in one launch per card, the beam state in shared
// memory as in fused_prefix_decode, the full frame row (V <= 256) in
// shared memory so that every shard's update reads f[v] of any winner.
// Per frame a block takes its window's top-W, exchanges it (exchange.cuh)
// and updates its state from the merged keys; the payload is the W keys:
// the fields follow from the replicated state. At n = 1 no exchange runs.
//   cluster design (every shard on one card, n <= the cluster the card
//     admits): as many clusters of n blocks as the card holds at once,
//     cluster c walking utterances c, c + C, ...; the lists pushed into
//     the peers' shared memory; not cooperative.
//   push design (a group across cards, or n past the cluster limit): a
//     persistent grid of n_local x G blocks a card, block (s, g) walking
//     utterances g, g + G, ..., every shard's block g in the same order;
//     the lists pushed into the peers' inboxes in device memory; launched
//     cooperatively on every card, since peers spin on each other.
// Bound on the card: neither bytes (log-probs 9.6 MB, ys 20.5 MB at
// T=200, B=256, W=100) nor operations; the serial chain of block phases a
// frame. On one card the n shards' blocks share the SMs and each repeats
// the replicated beam work (parent match, update) on its utterance, so
// the time grows as n times row 2's (NVIDIA H100 80GB HBM3, 700 W: 3.78
// ms for row 2, 13.43 ms push and 14.06 ms cluster at n = 4); the designs
// take out the system fences, the flags and the one-warp merge of the
// earlier pull exchange. A variant that split the match and the update
// across a cluster's blocks (two more cluster barriers a frame) ran
// slower at every n measured, and is not built.
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_frame.cuh"
#include "exchange.cuh"

namespace {

using namespace gasr::frame;
using gasr::kFullMask;
using gasr::monotone_bits;
using gasr::xchg::Merge;

constexpr unsigned long long kSignBit = 1ull << 63;
constexpr int kMaxCards = 8;     // cards a tp_frame launch writes lists to

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// ------------------------------------------------------------ tp_frame

struct FrameArgs {
  const float* f;            // frame rows: f[b * ld + v - f_lo]
  long long ld;
  int f_lo;
  const float* f_last;       // [B, W], or null: from the rows
  const float* f_blank;      // [B], or null: from the rows
  const long long* keys_in;  // [n_in, B, W], or null: fin_in is the state
  const int* ys_in;          // [n_in, B, W]
  const int* fin_in;         // [n_in, NF, B, W]
  int n_in;
  int* ys_merged;            // [B, W] the merged backpointers, or null
  int* st_merged;            // [NF, B, W]: merge only, no frame
  const int* shards;         // [gridDim.y] shard of each block row, or
  int n, lo, hi, win_max;    //   null: the one window [lo, hi)
  int n_out;                 // cards whose buffers take the lists
  long long* keys_out[kMaxCards];   // [n, B, W]
  int* ys_out[kMaxCards];           // [n, B, W]
  int* fin_out[kMaxCards];          // [n, NF, B, W]
  int B, W, V, blank;
};

__host__ __device__ inline size_t frame_smem(int W, int win_max, int n_in) {
  return align16(smem_bytes(W, win_max, win_max)) +
         gasr::xchg::merge_bytes(n_in, W) + gasr::kListLen * sizeof(int);
}

template <int R>
__global__ void __launch_bounds__(kThreads, 2)
tp_frame_kernel(const FrameArgs a) {
  extern __shared__ __align__(16) unsigned long long smem[];
  const int W = a.W, B = a.B, V = a.V;
  const Smem s = carve(smem, W, a.win_max);
  uint8_t* tail = reinterpret_cast<uint8_t*>(smem) +
                  align16(smem_bytes(W, a.win_max, a.win_max));
  const Merge m = gasr::xchg::carve_merge(tail, a.n_in, W);
  int* org = reinterpret_cast<int*>(tail +
                                    gasr::xchg::merge_bytes(a.n_in, W));
  const Beam be = s.beam[0];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int sh = a.shards ? a.shards[blockIdx.y] : 0;
  const Window win =
      a.shards ? Window{(int)((long long)sh * V / a.n),
                        (int)((long long)(sh + 1) * V / a.n)}
               : Window{a.lo, a.hi};
  const float* fb = a.f + (size_t)b * a.ld - a.f_lo;   // indexed by v

  // ---- the beam: the input state, or the merge of the input lists
  if (a.keys_in == nullptr) {
    for (int i = tid; i < NF * W; i += blockDim.x) {
      const int f = i / W, w = i - f * W;
      be.st[i] = a.fin_in[((size_t)f * B + b) * W + w];
    }
  } else {
    const long long* keys = a.keys_in;
    gasr::xchg::merge(
        a.n_in, W,
        [=](int p, int j) {
          return (unsigned long long)keys[((size_t)p * B + b) * W + j] ^
                 kSignBit;
        },
        m, s.top, org);
    for (int i = tid; i < NF * W; i += blockDim.x) {
      const int f = i / W, r = i - f * W;
      const int p = org[r] / W, k = org[r] - p * W;
      const int v = a.fin_in[(((size_t)p * NF + f) * B + b) * W + k];
      be.st[i] = v;
      if (a.st_merged) a.st_merged[((size_t)f * B + b) * W + r] = v;
    }
    if (a.ys_merged && sh == 0) {
      for (int r = tid; r < W; r += blockDim.x) {
        const int p = org[r] / W, k = org[r] - p * W;
        a.ys_merged[(size_t)b * W + r] = a.ys_in[((size_t)p * B + b) * W + k];
      }
    }
    if (a.st_merged) return;
  }

  // ---- the frame on the window
  const int Vw = win.len();
  for (int i = tid; i < W * Vw; i += blockDim.x) s.excl[i] = 0;
  for (int j = tid; j < Vw; j += blockDim.x)
    s.frow[0][j] = fb[win.lo + j];
  __syncthreads();
  if (a.f_last == nullptr && tid < W)     // read by prep in this thread
    s.sscore[tid] = fb[clampi(be.last()[tid], 0, V - 1)];
  prep(be, s.frow[0], V, win.lo,
       a.f_last ? a.f_last + (size_t)b * W : s.sscore);
  const float f_blank = a.f_blank ? a.f_blank[b] : fb[a.blank];
  __syncthreads();
  const float* row = s.frow[0];
  match_seed<false, false>(s, be, row, V, a.blank, f_blank, win, win.lo,
                           nullptr);
  __syncthreads();
  window_walk<false, false, R>(s, be, row, V, a.blank, win, win.lo,
                               nullptr);
  __syncthreads();
  window_rank<R>(s, [&](int k, unsigned long long key) { s.top[k] = key; });
  __syncthreads();
  if (tid < W) {
    const unsigned long long key = s.top[tid];
    const Slot n = update<false>(s, be, row, key, V, a.blank, win.lo,
                                 nullptr);
    const size_t o = ((size_t)sh * B + b) * W + tid;
    for (int c = 0; c < a.n_out; ++c) {
      a.keys_out[c][o] = (long long)(key ^ kSignBit);
      a.ys_out[c][o] = n.ys;
#pragma unroll
      for (int f = 0; f < NF; ++f)
        a.fin_out[c][(((size_t)sh * NF + f) * B + b) * W + tid] = field(n, f);
    }
  }
}

// ------------------------------------------------------------- tp_scan

// One utterance, T frames: its window's top-W into `list`, then
// exchange(step, list), which starts with the barrier that publishes the
// list and leaves the merged keys in s.top, ending with a barrier; then
// the update from s.top. fin_b: this shard's [NF, B, W] final state.
template <int R, typename Exchange>
__device__ __forceinline__ void scan_utterance(
    const Smem& s, const float* __restrict__ lp,
    const int* __restrict__ init, int T, int B, int W, int V, int blank,
    Window win, int b, bool writes_ys, int* __restrict__ ys,
    int* __restrict__ fin_b, unsigned long long* list, unsigned& step,
    Exchange exchange) {
  const int tid = threadIdx.x;
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
    const int my_excl = match_seed<false, false>(s, cur, row, V, blank,
                                                 row[blank], win, 0, nullptr);
    __syncthreads();
    window_walk<false, false, R>(s, cur, row, V, blank, win, 0, nullptr);
    cp_async_wait();
    __syncthreads();
    window_rank<R>(s, [&](int k, unsigned long long key) { list[k] = key; });
    if (my_excl >= 0) s.excl[my_excl] = 0;   // no reader until next frame
    exchange(step, list);
    if (tid < W) {
      const Slot u = update<false>(s, cur, row, s.top[tid], V, blank, 0,
                                   nullptr);
      if (writes_ys) ys[((size_t)t * B + b) * W + tid] = u.ys;
      commit(nxt, u, tid, next_row, V);
    }
    __syncthreads();
  }
  const Beam last = (T & 1) ? s.beam[1] : s.beam[0];
  for (int i = tid; i < NF * W; i += blockDim.x) {
    const int f = i / W, w = i - f * W;
    fin_b[((size_t)f * B + b) * W + w] = last.st[i];
  }
}

// Shared memory of a tp_scan block: the frame state (the whole row, the
// largest window's flags), its list, the merge and its origins; in the
// cluster design also its inboxes.
__host__ __device__ inline size_t scan_smem(int W, int V, int n,
                                            bool cluster) {
  return align16(smem_bytes(W, V, (V + n - 1) / n)) +
         gasr::kListLen * sizeof(unsigned long long) +
         gasr::xchg::merge_bytes(n, W) + gasr::kListLen * sizeof(int) +
         (cluster ? gasr::xchg::inbox_words(n, W) : 0) *
             sizeof(unsigned long long);
}

struct ScanParts {
  Smem s;
  unsigned long long* list;    // [kListLen] this block's top-W
  Merge m;
  int* org;                    // [kListLen] the merged keys' origins
  unsigned long long* inbox;   // cluster design: [2][n][2W] words
};

__device__ __forceinline__ ScanParts carve_scan(void* base, int W, int V,
                                                int n) {
  ScanParts p;
  p.s = carve(base, W, V);
  uint8_t* tail = reinterpret_cast<uint8_t*>(base) +
                  align16(smem_bytes(W, V, (V + n - 1) / n));
  p.list = reinterpret_cast<unsigned long long*>(tail);
  p.m = gasr::xchg::carve_merge(p.list + gasr::kListLen, n, W);
  p.org = reinterpret_cast<int*>(reinterpret_cast<uint8_t*>(p.m.key) +
                                 gasr::xchg::merge_bytes(n, W));
  p.inbox = reinterpret_cast<unsigned long long*>(p.org + gasr::kListLen);
  return p;
}

__device__ __forceinline__ Window shard_window(int sh, int V, int n) {
  return Window{(int)((long long)sh * V / n),
                (int)((long long)(sh + 1) * V / n)};
}

// Cluster design: a persistent grid of clusters of n blocks, cluster c
// walking utterances c, c + C, ... (C clusters), its block of rank s shard
// s. fin [n, NF, B, W]; ys written by shard 0.
template <int R>
__global__ void __launch_bounds__(kThreads, 2)
tp_cluster_kernel(const float* __restrict__ lp, const int* __restrict__ init,
                  int T, int B, int W, int V, int blank, int n,
                  int* __restrict__ ys, int* __restrict__ fin) {
  extern __shared__ __align__(16) unsigned long long smem[];
  const ScanParts p = carve_scan(smem, W, V, n);
  const int sh = (int)cooperative_groups::this_cluster().block_rank();
  const Window win = shard_window(sh, V, n);
  const int C = gridDim.x / n;
  for (int i = threadIdx.x; i < W * win.len(); i += blockDim.x)
    p.s.excl[i] = 0;
  unsigned step = 0;
  int* fin_b = fin + (size_t)sh * NF * B * W;
  if (n == 1) {
    for (int b = blockIdx.x; b < B; b += C)
      scan_utterance<R>(
          p.s, lp, init, T, B, W, V, blank, win, b, true, ys, fin_b,
          p.s.top, step,
          [](unsigned, unsigned long long*) { __syncthreads(); });
    return;
  }
  for (size_t i = threadIdx.x; i < gasr::xchg::inbox_words(n, W);
       i += blockDim.x)
    p.inbox[i] = 0;
  gasr::xchg::cluster_barrier();   // every inbox zeroed before any push
  const gasr::xchg::SharedBoxes boxes{p.inbox, n, W};
  const Merge m = p.m;
  int* org = p.org;
  unsigned long long* top = p.s.top;
  for (int b = blockIdx.x / n; b < B; b += C) {
    scan_utterance<R>(
        p.s, lp, init, T, B, W, V, blank, win, b, sh == 0, ys, fin_b,
        p.list, step, [=](unsigned st, unsigned long long* list) {
          __syncthreads();                 // the list is in place
          gasr::xchg::push(boxes, n, W, sh, st, list);
          gasr::xchg::merge(
              n, W,
              gasr::xchg::Gather<gasr::xchg::SharedBoxes>{boxes, list, sh,
                                                          st},
              m, top, org);
        });
    __syncthreads();   // the next utterance's state overwrites beam[0]
  }
  gasr::xchg::cluster_barrier();   // no block leaves while a peer writes
}

// Push design: block (local, g) of shard shards[local] walks utterances
// g, g + G, ...; fin [n_local, NF, B, W]; ys written by shard 0's blocks
// (null where shard 0 is on another card).
template <int R>
__global__ void __launch_bounds__(kThreads, 2)
tp_push_kernel(const float* __restrict__ lp, const int* __restrict__ init,
               int T, int B, int W, int V, int blank,
               const int* __restrict__ shards, gasr::xchg::Push x,
               int* __restrict__ ys, int* __restrict__ fin) {
  extern __shared__ __align__(16) unsigned long long smem[];
  const ScanParts p = carve_scan(smem, W, V, x.n);
  const int local = blockIdx.x / x.G;
  const int g = blockIdx.x - local * x.G;
  const int sh = shards[local];
  const Window win = shard_window(sh, V, x.n);
  for (int i = threadIdx.x; i < W * win.len(); i += blockDim.x)
    p.s.excl[i] = 0;
  unsigned step = 0;
  const Merge m = p.m;
  int* org = p.org;
  unsigned long long* top = p.s.top;
  const gasr::xchg::DeviceBoxes boxes{x, g};
  for (int b = g; b < B; b += x.G) {
    scan_utterance<R>(
        p.s, lp, init, T, B, W, V, blank, win, b, sh == 0 && ys != nullptr,
        ys, fin + (size_t)local * NF * B * W, p.list, step,
        [=](unsigned st, unsigned long long* list) {
          __syncthreads();                 // the list is in place
          gasr::xchg::push(boxes, x.n, W, sh, st, list);
          gasr::xchg::merge(
              x.n, W,
              gasr::xchg::Gather<gasr::xchg::DeviceBoxes>{boxes, list, sh,
                                                          st},
              m, top, org);
        });
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

const void* pick_cluster(int W) {
  switch (list_regs(W)) {
    case 1: return (const void*)tp_cluster_kernel<1>;
    case 2: return (const void*)tp_cluster_kernel<2>;
    default: return (const void*)tp_cluster_kernel<4>;
  }
}

const void* pick_push(int W) {
  switch (list_regs(W)) {
    case 1: return (const void*)tp_push_kernel<1>;
    case 2: return (const void*)tp_push_kernel<2>;
    default: return (const void*)tp_push_kernel<4>;
  }
}

cudaError_t set_smem(const void* kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

constexpr int kClusterMax = 16;    // the non-portable cluster limit

}  // namespace

// One frame on the blocks (b, s) of grid B x n_local (shards: device array
// of the local shards, or null with n_local = 1: the window [lo, hi)).
// f: frame rows, row b's vocab id v at f[b*ld + v - f_lo]; f_last [B, W]
// and f_blank [B] or null (then f holds whole rows). keys_in [n_in, B, W]
// (sign bit flipped), ys_in [n_in, B, W], fin_in [n_in, NF, B, W]: the
// previous frame's lists, merged first; keys_in null: fin_in is the state
// (n_in = 1). ys_merged [B, W] or null: the merged backpointers (shard 0's
// blocks). st_merged [NF, B, W] or null: merge only, no frame. outs: a
// host array of n_out triples (keys, ys, fin) of [n, B, W] / [n, NF, B,
// W] buffers, one a card; shard s writes its list at index s of each.
extern "C" int tp_frame_launch(const float* f, long long ld, int f_lo,
                               const float* f_last, const float* f_blank,
                               const long long* keys_in, const int* ys_in,
                               const int* fin_in, int n_in, int* ys_merged,
                               int* st_merged, const int* shards,
                               int n_local, int n, int lo, int hi,
                               void* const* outs, int n_out, int B, int W,
                               int V, int blank, cudaStream_t stream) {
  if (W < 1 || W > gasr::kListLen || n < 1 || n_in < 1 || n_local < 1 ||
      n_out < 0 || n_out > kMaxCards || B < 1 ||
      (keys_in == nullptr && n_in != 1) ||
      (shards == nullptr && (n_local != 1 || hi <= lo || lo < 0 || hi > V)))
    return (int)cudaErrorInvalidValue;
  FrameArgs a{};
  a.f = f; a.ld = ld; a.f_lo = f_lo; a.f_last = f_last; a.f_blank = f_blank;
  a.keys_in = keys_in; a.ys_in = ys_in; a.fin_in = fin_in; a.n_in = n_in;
  a.ys_merged = ys_merged; a.st_merged = st_merged;
  a.shards = shards; a.n = n; a.lo = lo; a.hi = hi;
  a.win_max = shards ? (V + n - 1) / n : hi - lo;
  a.n_out = n_out;
  for (int c = 0; c < n_out; ++c) {
    a.keys_out[c] = (long long*)outs[3 * c];
    a.ys_out[c] = (int*)outs[3 * c + 1];
    a.fin_out[c] = (int*)outs[3 * c + 2];
  }
  a.B = B; a.W = W; a.V = V; a.blank = blank;
  const size_t smem = frame_smem(W, a.win_max, n_in);
  const void* k = pick_frame(W);
  cudaError_t err = set_smem(k, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&a};
  err = cudaLaunchKernel(k, dim3(B, st_merged ? 1 : n_local),
                         dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The largest cluster (at most 16 blocks) of tp_scan's cluster design, at
// n = its size, that the current card holds at least once (0: none).
extern "C" int tp_scan_cluster_limit(int W, int V, int* limit) {
  *limit = 0;
  if (W < 1 || W > gasr::kListLen) return (int)cudaErrorInvalidValue;
  for (int c = kClusterMax < V ? kClusterMax : V; c >= 1; --c) {
    if (gasr::xchg::resident_clusters(pick_cluster(W), kThreads,
                                      scan_smem(W, V, c, true), c) > 0) {
      *limit = c;
      break;
    }
  }
  return 0;
}

// The cluster design: all n shards on the current card, as many clusters
// of n blocks as the card holds at once (at most B), each walking
// utterances. init [NF, B, W]; ys [T, B, W]; fin [n, NF, B, W].
extern "C" int tp_scan_cluster_launch(const float* lp, const int* init, int T,
                                      int B, int W, int V, int blank, int n,
                                      int* ys, int* fin,
                                      cudaStream_t stream) {
  if (W < 1 || W > gasr::kListLen || n < 1 || n > V || n > kClusterMax ||
      B < 1)
    return (int)cudaErrorInvalidValue;
  const void* k = pick_cluster(W);
  const size_t smem = scan_smem(W, V, n, true);
  int C = gasr::xchg::resident_clusters(k, kThreads, smem, n);
  if (C < 1) C = 1;          // the launch refuses a cluster the card lacks
  if (C > B) C = B;
  void* args[] = {&lp, &init, &T, &B, &W, &V, &blank, &n, &ys, &fin};
  return (int)gasr::xchg::launch_clusters(k, dim3(n * C), kThreads, smem, n,
                                          stream, args);
}

// How many push-design blocks the current card holds at once, for a group
// of n shards.
extern "C" int tp_scan_push_capacity(int W, int V, int n, int* blocks) {
  const size_t smem = scan_smem(W, V, n, false);
  const void* k = pick_push(W);
  cudaError_t err = set_smem(k, smem);
  if (err == cudaSuccess)
    err = gasr::xchg::resident_blocks(k, kThreads, smem, blocks);
  return (int)err;
}

// The push design for the n_local shards `shards` (device array) of an
// n-shard group that live on the current card, G blocks each. inbox: a
// device array of n pointers (shard s's zeroed [2, G, n, 2W] words, on its
// card). init [NF, B, W]; ys [T, B, W] (written by shard 0's blocks; null
// where shard 0 is not on this card); fin [n_local, NF, B, W].
extern "C" int tp_scan_push_launch(const float* lp, const int* init, int T,
                                   int B, int W, int V, int blank, int n,
                                   const int* shards, int n_local, int G,
                                   unsigned long long* const* inbox, int* ys,
                                   int* fin, cudaStream_t stream) {
  if (W < 1 || W > gasr::kListLen || n < 1 || n > V || G < 1 ||
      n_local < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = scan_smem(W, V, n, false);
  const void* k = pick_push(W);
  cudaError_t err = set_smem(k, smem);
  if (err != cudaSuccess) return (int)err;
  gasr::xchg::Push x{inbox, n, G, W};
  void* args[] = {&lp, &init, &T, &B, &W, &V, &blank, &shards, &x, &ys, &fin};
  err = cudaLaunchCooperativeKernel(k, dim3(n_local * G), dim3(kThreads),
                                    args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Let the current card read and write `peer`'s memory (the inboxes and
// list buffers of shards on another card of the host).
extern "C" int enable_peer_access(int peer) {
  cudaError_t err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();   // clear the sticky-free error state
    return 0;
  }
  return (int)err;
}
