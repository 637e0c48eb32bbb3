// LSTM recurrence, gates i, f, g, o:
//   pre = xw[t] + bf16(h_{t-1}) @ W_hh_bf16   (float32 accumulation)
//   c = sigmoid(f) * c + sigmoid(i) * tanh(g),  h = sigmoid(o) * tanh(c)
// forward or reverse in time, one or two directions, in one persistent
// launch a call.
//
// Replaces gasr_tpu/ops/pallas/lstm_scan.py::lstm_scan_pallas_raw (`_kernel`)
// with its cast pattern: h and c carried in float32, h rounded to bf16 only
// as the product's operand, W_hh held in bf16, the gates in float32. The
// output keeps xw's time index (in reverse the first step reads xw[T-1] and
// writes out[T-1]). The input GEMM x @ W_ih + b_ih + b_hh stays outside.
//
// Bound on the card: bytes. One layer-direction at the DS2 shape (T=300,
// B=32, H=512) moves xw (78.6 MB), out (19.7 MB) and W_hh (2.1 MB), 0.030
// ms at 3.35 TB/s; its 20.1 GFLOP of bf16 products take 0.020 ms at 989
// TFLOP/s. The steps are serial (step t needs all of h_{t-1}), so what
// costs is the chain of steps: a step at DS2 is 134 MFLOP and ~0.3 MB for
// both directions, latency all through.
//
// Design: one cooperative launch walks every step of every direction.
// Block (unit tile j, y, direction d), 512 threads, owns UB = 16 hidden
// units [16 j, 16 j + 16) of direction d, all four gates of them, and the
// batch groups y, y + gridDim.y, ... (B cut into G groups of RB <= 128
// rows). The grid holds as many groups a unit tile as the card holds at
// once, all G where they fit (G = 1 at the presets' B = 32 and 16): a
// block walks several groups a step only past that, so every B runs in
// one launch.
//   - W_hh resident. The block rounds the four column slices g H + [16 j,
//     16 j + 16) of W_hh (all Hp rows) to bf16 once, into shared memory as
//     W^T (64 gate columns x K, k contiguous), and keeps them for the whole
//     call: 66.5 KB at H = 512. DS2 runs 2 x 32 blocks, the BiLSTM 2 x 16.
//   - No K split across blocks: a block reads all of bf16 h_{t-1} for a
//     chunk of 32 rows, 32 KB a step at DS2 (2 MB a step over the card),
//     at once into shared memory (cp.async.cg: from L2, never a stale L1
//     line).
//   - 16 warps, 4 (quarters of K) x 2 (16 rows) x 2 (32 gate columns: i, f
//     or g, o), multiply by mma.sync m16n8k16 into float32 accumulators, a
//     quarter of the k16 steps each (the next step's fragments load while
//     the current one multiplies): a step's chain of products is a quarter
//     as long. The four partial 32 x 64 tiles go through shared memory, and
//     each thread sums the four gates of its (row, unit) pair there, in a
//     fixed order.
//   - c never leaves the block: where a block holds one group (every
//     preset) each thread keeps the c of its pair of each chunk in
//     registers from c0 to the last step. A block that walks several
//     groups parks the c of the group it leaves in scratch of its own
//     (cbuf [D, B, Hp]), which the same thread reads back the next step.
//   - xw[t] is moved into L2 by prefetch during step t - 1 and read into
//     registers when the step's chunk starts, so its load overlaps the
//     products.
//   - h_t goes to out (float32) and, rounded to bf16, into the other slot
//     of the direction's two-slot ping-pong buffer hbf [D, 2, B, Hp].
//   - The step barrier (recurrence.cuh: a counter a direction in the
//     call's own scratch, a release add a block) is per direction: a
//     direction's blocks wait only on each other. A block arrives once its
//     copies of slot t % 2 have landed and been multiplied and its h_t is
//     written; it writes slot t % 2 again at step t + 1, after every block
//     of its direction has passed step t's barrier.
// Where the time goes (scripts/torch_recurrence_probe.py, PERF.md): at DS2
// a step is ~5 us, latency all through: the barrier (~1.5 us), h from L2
// (~1.5 us), the products (~1.1 us) and the cell (~0.9 us).
#include "recurrence.cuh"

namespace {

using namespace gasr::rec;

constexpr int UB = 16;          // hidden units a block
constexpr int NC = 4 * UB;      // gate columns a block (gate g, unit u at
                                // g UB + u)
constexpr int MB = 32;          // batch rows a chunk
constexpr int CH_MAX = 4;       // chunks a batch group: RB <= 128 rows
constexpr int KQ = 4;           // K quarters among the warps
constexpr int kThreads = 512;   // 16 warps: 4 (K quarters) x 2 (16 rows) x 2
                                // (32 columns)
constexpr int LDC = NC + 4;     // float a row of a gate tile
static_assert(MB * UB == kThreads, "one (row, unit) pair a thread");

struct Args {
  const float* xw[2];  // [T, B, 4H] per direction
  const float* w[2];   // [H, 4H] float32, rounded to bf16 on the way in
  const float* h0;     // [B, H]
  const float* c0;     // [B, H]
  float* out;          // [T, B, D H]
  bf16* hbf;           // [D, 2, B, Hp] scratch
  float* cbuf;         // [D, B, Hp] scratch: c of a block's other groups
  unsigned long long* bar;     // barrier words, one a block (scratch)
  unsigned long long* clocks;   // probe builds only
  int D, T, B, H, Hp, RB, G, rev_mask;
};

__host__ __device__ inline size_t smem_w(int Hp) {
  return (size_t)NC * (Hp + 8) * sizeof(bf16);
}
__host__ __device__ inline size_t smem_h(int Hp) {
  return (size_t)MB * (Hp + 8) * sizeof(bf16);
}
__host__ __device__ inline size_t smem_bytes(int Hp) {
  return smem_w(Hp) + smem_h(Hp) + (size_t)KQ * MB * LDC * sizeof(float);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The fragments of one k16 step: A, this warp's 16 rows of the staged h
// (row stride ld); B, its 4 n8 tiles (32 gate columns from 32 wn) of the
// resident W^T.
__device__ __forceinline__ void load_frags(uint32_t (&af)[4],
                                           uint32_t (&bf)[4][2],
                                           const bf16* hs, const bf16* ws,
                                           int ld, int wm, int wn, int lane,
                                           int k16) {
  ldsm_x4(af, hs + (wm * 16 + a_row(lane)) * ld + k16 + a_col(lane));
#pragma unroll
  for (int i = 0; i < 4; i += 2) {
    uint32_t q[4];
    ldsm_x4(q, ws + (wn * 32 + i * 8 + b_row(lane)) * ld + k16 +
                   b_col(lane));
    bf[i][0] = q[0];
    bf[i][1] = q[1];
    bf[i + 1][0] = q[2];
    bf[i + 1][1] = q[3];
  }
}

__global__ void __launch_bounds__(kThreads, 1) lstm_scan_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int d = blockIdx.z;
  const int j0 = blockIdx.x * UB;                  // this block's units
  const int LDW = a.Hp + 8;
  const int H = a.H, Hp = a.Hp, RB = a.RB;
  const bool multi = a.G > (int)gridDim.y;         // several groups a block
  bf16* Ws = reinterpret_cast<bf16*>(smem);              // [NC][Hp + 8]
  bf16* hs = reinterpret_cast<bf16*>(smem + smem_w(Hp));  // [MB][Hp + 8]
  float* Cs = reinterpret_cast<float*>(smem + smem_w(Hp) + smem_h(Hp));
                                                         // [KQ][MB][LDC]
  const float* xw = a.xw[d];
  const bool rev = (a.rev_mask >> d) & 1;
  bf16* hbf = a.hbf + (size_t)d * 2 * a.B * Hp;
  float* cbuf = a.cbuf + (size_t)d * a.B * Hp;
  const int nblk = gridDim.x * gridDim.y;          // blocks of a direction
  unsigned long long* bar = a.bar + (size_t)d * nblk;
  const int me = blockIdx.y * gridDim.x + blockIdx.x;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kq = warp / 4, wm = (warp / 2) % 2, wn = warp % 2;
  const int er = tid / UB, eu = tid % UB;   // this thread's (row, unit)
  const int n16 = Hp / 16, per = (n16 + KQ - 1) / KQ;
  const int kb = min(kq * per, n16), ke = min(kb + per, n16);  // its k16s
  const int j = j0 + eu;
  Clock clk;
  clk.start();

  // W_hh's gate slices, rounded to bf16, transposed: read along units
  for (int i = tid; i < NC * Hp; i += kThreads) {
    const int col = i % NC, k = i / NC;
    const int g = col / UB, jj = j0 + col % UB;
    const float v = k < H && jj < H
                        ? a.w[d][(size_t)k * 4 * H + (size_t)g * H + jj]
                        : 0.f;
    Ws[col * LDW + k] = __float2bfloat16_rn(v);
  }
  // this thread's pair (row r0 + c MB + er, unit j) of chunk c of a group
  // at row r0 with `rows` rows: whether it is a real row
  auto real = [&](int rows, int c) { return c * MB + er < rows; };
  // h0 into slot 0, c0 into registers (one group) or cbuf (several), for
  // this thread's pair of each chunk of each of the block's groups
  float cst[CH_MAX];
  for (int gi = blockIdx.y; gi < a.G; gi += gridDim.y) {
    const int r0 = gi * RB, rows = min(RB, a.B - r0);
#pragma unroll
    for (int c = 0; c < CH_MAX; ++c) {
      const size_t b = r0 + c * MB + er;
      const float cv = real(rows, c) && j < H ? a.c0[b * H + j] : 0.f;
      if (!multi) cst[c] = cv;
      if (real(rows, c)) {
        if (multi) cbuf[b * Hp + j] = cv;
        hbf[b * Hp + j] =
            __float2bfloat16_rn(j < H ? a.h0[b * H + j] : 0.f);
      }
    }
  }

  // gate g's xw of this thread's pair in chunk c of the group at row r0,
  // step s
  auto xw_at = [&](int s, int r0, int c, int g) -> const float* {
    const int t = rev ? a.T - 1 - s : s;
    return xw + ((size_t)t * a.B + r0 + c * MB + er) * 4 * H +
           (size_t)g * H + j;
  };
  // xw of step s into L2, ahead of the step that reads it: a prefetch has
  // no result, so no fence or barrier waits for it
  auto prefetch_l2 = [&](int s) {
    if (j >= H) return;
    for (int gi = blockIdx.y; gi < a.G; gi += gridDim.y) {
      const int r0 = gi * RB, rows = min(RB, a.B - r0);
      for (int c = 0; c * MB + er < rows; ++c)
#pragma unroll
        for (int g = 0; g < 4; ++g)
          asm volatile("prefetch.global.L2 [%0];" ::"l"(xw_at(s, r0, c, g)));
    }
  };
  prefetch_l2(0);
  clk.lap(kLoads);   // the prologue: W_hh, h0 and c0
  prologue_barrier(a.bar, a.D * nblk);
  clk.lap(kWait);

  for (int s = 0; s < a.T; ++s) {
    const int t = rev ? a.T - 1 - s : s;
    const bf16* h_r = hbf + (size_t)(s & 1) * a.B * Hp;
    bf16* h_w = hbf + (size_t)((s + 1) & 1) * a.B * Hp;

    // chunk c of group gi: its rows of bf16 h_{t-1}, all of K, into hs
    auto load_h = [&](int gi, int c) {
      const int r0 = gi * RB, rows = min(RB, a.B - r0);
      const bf16* src = h_r + (size_t)(r0 + c * MB) * Hp;
      for (int i = tid; i < MB * (Hp / 8); i += kThreads) {
        const int r = i / (Hp / 8), cc = (i % (Hp / 8)) * 8;
        const bool ok = c * MB + r < rows;
#ifndef GASR_PROBE_NO_LOADS
        cp_async16(hs + r * LDW + cc, ok ? src + (size_t)r * Hp + cc : src,
                   ok);
#endif
      }
      cp_async_commit();
    };
    load_h(blockIdx.y, 0);
    if (s + 1 < a.T) prefetch_l2(s + 1);

    for (int gi = blockIdx.y; gi < a.G; gi += gridDim.y) {
      const int r0 = gi * RB, rows = min(RB, a.B - r0);
      const int nch = (rows + MB - 1) / MB;
      if (multi)
#pragma unroll
        for (int c = 0; c < CH_MAX; ++c)
          if (real(rows, c))
            cst[c] = cbuf[(size_t)(r0 + c * MB + er) * Hp + j];
#pragma unroll
      for (int c = 0; c < CH_MAX; ++c) {
        if (c >= nch) break;
        // this chunk's xw (from L2), in flight during the products
        const bool xok = real(rows, c) && j < H;
        float x[4];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          x[g] = xok ? __ldg(xw_at(s, r0, c, g)) : 0.f;
        cp_async_wait<0>();   // the chunk has landed ...
        __syncthreads();      // ... for every thread
        clk.lap(kLoads);
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
        if (c * MB + wm * 16 < rows && kb < ke) {   // a real row, some K
          // fragments of k16 step k + 1 load while step k multiplies
          uint32_t af[2][4], bf[2][4][2];
          load_frags(af[0], bf[0], hs, Ws, LDW, wm, wn, lane, 16 * kb);
          for (int k = kb; k < ke; k += 2) {
#pragma unroll
            for (int cur = 0; cur < 2; ++cur) {
              if (k + cur >= ke) break;
              if (k + cur + 1 < ke)
                load_frags(af[cur ^ 1], bf[cur ^ 1], hs, Ws, LDW, wm, wn,
                           lane, 16 * (k + cur + 1));
#pragma unroll
              for (int i = 0; i < 4; ++i)
                mma16816(acc[i], af[cur], bf[cur][i][0], bf[cur][i][1]);
            }
          }
        }
        clk.lap(kProducts);

        // the K quarters' 32 x 64 gate tiles through shared memory, so
        // that one thread holds the four gates of a (row, unit); then the
        // cell
        const int g8 = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* p = Cs + kq * MB * LDC + (wm * 16 + g8) * LDC + wn * 32 +
                     i * 8 + c2;
          *reinterpret_cast<float2*>(p) = make_float2(acc[i][0], acc[i][1]);
          *reinterpret_cast<float2*>(p + 8 * LDC) =
              make_float2(acc[i][2], acc[i][3]);
        }
        __syncthreads();   // hs is free, the tiles are written
        // the block's next chunk lands during the cell
        if (c + 1 < nch)
          load_h(gi, c + 1);
        else if (gi + (int)gridDim.y < a.G)
          load_h(gi + gridDim.y, 0);
        const size_t b = r0 + c * MB + er;
#ifndef GASR_PROBE_NO_EPILOGUE
        if (real(rows, c)) {
          float pre[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const float* q = Cs + er * LDC + g * UB + eu;
            pre[g] = x[g] + ((q[0] + q[MB * LDC]) +
                             (q[2 * MB * LDC] + q[3 * MB * LDC]));
          }
          const float ig = sigmoid(pre[0]);
          const float fg = sigmoid(pre[1]);
          const float gg = tanhf(pre[2]);
          const float og = sigmoid(pre[3]);
          cst[c] = fg * cst[c] + ig * gg;
          const float h = og * tanhf(cst[c]);
#ifndef GASR_PROBE_NO_OUT
          if (j < H)
            a.out[((size_t)t * a.B + b) * a.D * H + (size_t)d * H + j] = h;
#endif
          h_w[b * Hp + j] = __float2bfloat16_rn(h);
        }
#endif
        __syncthreads();   // the gate tiles are free for the next chunk
        clk.lap(kEpilogue);
      }
      if (multi)
#pragma unroll
        for (int c = 0; c < CH_MAX; ++c)
          if (real(rows, c))
            cbuf[(size_t)(r0 + c * MB + er) * Hp + j] = cst[c];
    }
    if (s + 1 < a.T) {
      step_barrier(bar, nblk, me, s + 1);
      clk.lap(kWait);
    }
  }
  clk.flush(a.clocks);
}

// ---- The streamed design: W_hh past shared-memory residency (the
// resident design needs a unit tile's 4 x 16 columns of all Hp rows in
// each block, and D Hp / 16 blocks at once: past H = 1008 on an H100).
//
// One cooperative launch for both directions; per direction, blocks tile
// the output over batch and units together, as rnn_scan.cu's streamed
// design does: block (d, gb0, gn) computes the gates of units [n0, n0 +
// NU) for the batch tiles gb0, gb0 + gBr, .. of MB rows from h_{t-1}'s
// rows of each and W_hh's four gate columns of those units. A unit tile
// owns all four gates of its units, so the cell stays in the block:
//   - The prologue rounds W_hh to bf16 once a call into the scratch wblk
//     [D][gN][Hp][4 NU + 8]: a unit tile's K rows, each its 4 NU gate
//     columns by octets of units, gate by gate ((octet 4 + gate) 8 +
//     unit % 8), then 8 zeros, so the k rows of an ldmatrix are 4 NU / 8 +
//     1 (odd) 16-byte chunks apart and fall in distinct bank groups; zeros
//     past H. It writes h0 (bf16) into slot 0 of the direction's ping-pong
//     buffer hblk [D][2][Hp / KS][Bp][KS] (recurrence.cuh: h_index; rows
//     past B zero in both slots), and c0 into cbuf where a block walks
//     several batch tiles; the grid meets once.
//   - K streams in stages of KS rows (128, or 64 where a stage of 128
//     leaves room for fewer than two): the copy warp of recurrence.cuh
//     (stream_copies) issues the stage's W tile [KS][4 NU + 8] and h tile
//     [MB][KS], one bulk copy each, into a ring of S stages; each block
//     starts K at its own stage; the step barrier is one counter for each
//     (direction, block row): the gN blocks that write and read those
//     rows of that direction's h.
//   - 8 consumer warps: WGM along the rows, WGN along the unit octets (a
//     warp owns whole octets: its n8 tiles are the four gates of each),
//     WGK along each stage's K, mma.sync m16n8k16, every product
//     unconditional (a warp with fewer octets multiplies a copy of its
//     last one into accumulators it never stores). K slice 0's
//     accumulators start from xw[t] (prefetched into L2 during the step
//     before, loaded as a tile starts); the other slices' partial tiles
//     are added in K order through shared memory. Then each lane holds
//     all four gates of its (row, unit) pairs in registers: c = f c + i g,
//     h = o tanh(c), with c in registers from c0 to the last step (or
//     parked in cbuf between the batch tiles a block walks), out[t] in
//     float32 and bf16 h_t into the other slot.
// Bound on the card: at B = 256, H = 2048 a direction's bf16 W_hh (32 MB)
// is past L2 with the other's, and each batch tile a block walks reads it
// again: the step is the stream of W_hh; at small B the step is the
// latency of streaming W_hh from L2 with little to multiply.
constexpr int kStreamConsumers = 256;                  // 8 warps
constexpr int kStreamWarps = kStreamConsumers / 32;
constexpr int kStreamThreads = kStreamConsumers + 32;  // + the copy warp
constexpr int kStreamMaxStages = 8;

struct StreamArgs {
  const float* xw[2];  // [T, B, 4H] per direction
  const float* w[2];   // [H, 4H] float32 per direction
  const float* h0;     // [B, H]
  const float* c0;     // [B, H]
  float* out;          // [T, B, D H]
  bf16* wblk;          // [D][gN][Hp][4 NU + 8] scratch
  bf16* hblk;          // [D][2][Hp / KS][gB MB][KS] scratch (swizzled)
  float* cbuf;         // [D][gB MB][Hp] scratch, where gB > gBr
  unsigned long long* bar;      // D gBr words (scratch)
  unsigned long long* clocks;   // probe builds only
  int D, T, B, H, Hp, KS, MB, gB, gBr, NU, gN, WGM, WGN, WGK, S, rev_mask,
      vec;
};

__host__ __device__ inline int stream_ldw(int NU) { return 4 * NU + 8; }
__host__ __device__ inline size_t stream_stage(int KS, int MB, int NU) {
  return ((size_t)MB + stream_ldw(NU)) * KS * sizeof(bf16);
}
__host__ __device__ inline size_t stream_red(int MB, int NU, int WGK) {
  return (size_t)(WGK - 1) * MB * (4 * NU + 4) * sizeof(float);
}
__host__ __device__ inline size_t stream_smem(int KS, int MB, int NU,
                                              int WGK, int S) {
  return S * stream_stage(KS, MB, NU) + stream_red(MB, NU, WGK) +
         2 * (size_t)S * sizeof(uint64_t);
}

// MT: m16 tiles a warp (1 or 2); OCW: unit octets a warp (1 or 2), 4 OCW
// n8 tiles. ptxas (sm_90a, the 168-register cap of 288 threads): (1, 1)
// 142 registers, (1, 2) 168, (2, 1) 161, no spills; (2, 2) spills 172
// bytes, and its tiles of 128 rows still halve the W_hh a step streams
// at B = 256 (T = 200, H = 2048, both directions: 18.59 against 22.38 ms
// on an NVIDIA H100 80GB HBM3 at 700 W, scripts/torch_lstm_tiles.py).
template <int MT, int OCW>
__global__ void __launch_bounds__(kStreamThreads, 1)
lstm_stream_kernel(StreamArgs a) {
  constexpr int NTW = 4 * OCW;
  extern __shared__ __align__(128) unsigned char smem[];
  const int per_dir = a.gBr * a.gN;
  const int d = blockIdx.x / per_dir, bl = blockIdx.x % per_dir;
  const int gb0 = bl / a.gN, gn = bl % a.gN;
  const int n0 = gn * a.NU;
  const int noct = min(a.NU, a.Hp - n0) / 8;    // this tile's octets
  const int H = a.H, KS = a.KS, LDW = stream_ldw(a.NU), LDR = 4 * a.NU + 4;
  const int Bp = a.gB * a.MB, nk = a.Hp / KS, S = a.S;
  const int rot = (int)((long long)gn * nk / a.gN);   // the first K stage
  const bool rev = (a.rev_mask >> d) & 1, multi = a.gB > a.gBr;
  const float* xw = a.xw[d];
  const size_t stage_bytes = stream_stage(KS, a.MB, a.NU);
  const size_t slot_elems = (size_t)nk * Bp * KS;
  bf16* hblk = a.hblk + (size_t)d * 2 * slot_elems;
  float* cbuf = multi ? a.cbuf + (size_t)d * Bp * a.Hp : nullptr;
  float* red = reinterpret_cast<float*>(smem + S * stage_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + S * stage_bytes + stream_red(a.MB, a.NU, a.WGK));
  const Ring ring{smem, stage_bytes, (uint32_t)(KS * LDW * sizeof(bf16)),
                  (uint32_t)(a.MB * KS * sizeof(bf16)), S, full, full + S};
  unsigned long long* counter = a.bar + (size_t)d * a.gBr + gb0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  Clock clk;
  clk.start();

  // W_hh of every direction rounded to bf16 once into wblk, by the whole
  // grid: one 16-byte chunk (8 units of one gate) a thread at a time
  {
    const int cpr = LDW / 8;                    // chunks a row
    const size_t per_d = (size_t)a.gN * a.Hp * cpr;
    const size_t total = a.D * per_d;
    for (size_t i = (size_t)blockIdx.x * kStreamThreads + tid; i < total;
         i += (size_t)gridDim.x * kStreamThreads) {
      const int dd = (int)(i / per_d);
      size_t rem = i % per_d;
      const int ch = (int)(rem % cpr);
      rem /= cpr;
      const int k = (int)(rem % a.Hp), tile = (int)(rem / a.Hp);
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
      const int u = tile * a.NU + (ch / 4) * 8, g = ch % 4;
      if (ch < cpr - 1 && k < H && u < H) {
        const float* wr = a.w[dd] + (size_t)k * 4 * H + (size_t)g * H + u;
        if (H % 4 == 0 && (reinterpret_cast<uintptr_t>(a.w[dd]) & 15) == 0 &&
            u + 8 <= H) {
          const float4 lo = __ldg(reinterpret_cast<const float4*>(wr));
          const float4 hi = __ldg(reinterpret_cast<const float4*>(wr + 4));
          v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
          v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = u + e < H ? __ldg(wr + e) : 0.f;
        }
      }
      uint4 pk;
      uint32_t* w32 = reinterpret_cast<uint32_t*>(&pk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        __nv_bfloat162 b2 = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
        w32[e] = *reinterpret_cast<uint32_t*>(&b2);
      }
      *reinterpret_cast<uint4*>(
          a.wblk + (((size_t)dd * a.gN + tile) * a.Hp + k) * LDW + ch * 8) =
          pk;
    }
  }
  // this block's tiles of h0 into slot 0 (rows past B zero in both slots)
  // and, where it walks several batch tiles, of c0 into cbuf
  const int nu = noct * 8;
  for (int gb = gb0; gb < a.gB; gb += a.gBr)
    for (int i = tid; i < a.MB * nu; i += kStreamThreads) {
      const int r = gb * a.MB + i / nu, u = n0 + i % nu;
      const bool ok = r < a.B && u < H;
      const size_t e = h_index(r, u, Bp, KS);
      hblk[e] = __float2bfloat16_rn(ok ? a.h0[(size_t)r * H + u] : 0.f);
      if (r >= a.B) hblk[slot_elems + e] = __float2bfloat16_rn(0.f);
      if (multi) cbuf[(size_t)r * a.Hp + u] = ok ? a.c0[(size_t)r * H + u]
                                                 : 0.f;
    }
  if (tid == 0) ring.init(kStreamWarps);
  fence_proxy_async();
  clk.lap(kLoads);   // the prologue: W_hh rounded, h0, c0
  prologue_barrier(a.bar, a.D * a.gBr);
  clk.lap(kWait);

  if (warp == kStreamWarps) {        // the copy warp: one thread
    if (lane == 0)
      stream_copies(ring, a.wblk + ((size_t)d * a.gN + gn) * a.Hp * LDW,
                    (size_t)KS * LDW, hblk, slot_elems, Bp, a.MB, KS, nk,
                    rot, a.T, gb0, a.gB, a.gBr, counter,
                    (unsigned long long)a.gN);
    return;
  }

  // ---- the consumer warps
  const int wn = warp % a.WGN, wm = (warp / a.WGN) % a.WGM;
  const int kw = warp / (a.WGN * a.WGM);
  const int ocw = noct / a.WGN + (wn < noct % a.WGN);   // this warp's
  const int o0 = wn * (noct / a.WGN) + min(wn, noct % a.WGN);   // octets
  const int n16 = KS / a.WGK / 16;              // k16 steps a stage
  const int g8 = lane >> 2, c2 = 2 * (lane & 3);
  // this lane's ldmatrix rows: A, row r_m of m16 tile m (its swizzle);
  // B, the W tile's columns of n8 tiles i, i + 1 (gates of one octet;
  // octets past the warp's last read its last: products never stored)
  int a_off[MT], a_swz[MT], b_off[NTW / 2];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int row = (wm * MT + m) * 16 + a_row(lane);
    a_off[m] = row * KS;
    a_swz[m] = row & 7;
  }
  const int last = max(o0 + ocw - 1, 0);
#pragma unroll
  for (int i = 0; i < NTW; i += 2) {
    const int t = i + (lane >> 4);
    b_off[i / 2] = (min(o0 + t / 4, last) * 4 + t % 4) * 8;
  }
  const int bk = (lane & 7) + 8 * ((lane >> 3) & 1);
  // (row, unit) of accumulator element (m, n8 tile i, half h) of batch
  // tile b0: row b0 + (wm MT + m) 16 + g8 + 8 h, units u, u + 1 of gate
  // i % 4
  auto unit = [&](int i) { return n0 + (o0 + i / 4) * 8 + c2; };
  auto row = [&](int b0, int m, int h) {
    return b0 + (wm * MT + m) * 16 + g8 + 8 * h;
  };

  // this thread's xw elements of step s into L2, ahead of their use
  auto prefetch_l2 = [&](int s) {
    if (kw != 0) return;
    const int t = rev ? a.T - 1 - s : s;
    for (int gb = gb0; gb < a.gB; gb += a.gBr)
      for (int m = 0; m < MT; ++m)
        for (int i = 0; i < 4 * ocw; ++i)
          for (int h = 0; h < 2; ++h) {
            const int r = row(gb * a.MB, m, h), u = unit(i);
            if (r < a.B && u < H)
              asm volatile("prefetch.global.L2 [%0];" ::"l"(
                  xw + ((size_t)t * a.B + r) * 4 * H + (size_t)(i % 4) * H +
                  u));
          }
  };
  auto load_frags = [&](const bf16* hs, const bf16* ws, int kk,
                        uint32_t (&af)[MT][4], uint32_t (&bf)[NTW][2]) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int q = (kk + a_col(lane)) >> 3;
      ldsm_x4(af[m], hs + a_off[m] + ((q ^ a_swz[m]) << 3));
    }
    const bf16* wk = ws + (kk + bk) * LDW;
#pragma unroll
    for (int i = 0; i < NTW; i += 2) {
      uint32_t q4[4];
      ldsm_x4_t(q4, wk + b_off[i / 2]);
      bf[i][0] = q4[0];
      bf[i][1] = q4[1];
      bf[i + 1][0] = q4[2];
      bf[i + 1][1] = q4[3];
    }
  };
  auto products = [&](float (&acc)[MT][NTW][4], const uint32_t (&af)[MT][4],
                      const uint32_t (&bf)[NTW][2]) {
#pragma unroll
    for (int i = 0; i < NTW; ++i)
#pragma unroll
      for (int m = 0; m < MT; ++m)
        mma16816(acc[m][i], af[m], bf[i][0], bf[i][1]);
  };

  // c of this lane's (row, unit) pairs: element (m, octet oc, 2 h + e)
  float cst[MT][OCW][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int oc = 0; oc < OCW; ++oc)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = row(gb0 * a.MB, m, h), u = unit(4 * oc) + e;
          cst[m][oc][2 * h + e] =
              !multi && kw == 0 && oc < ocw && r < a.B && u < H
                  ? a.c0[(size_t)r * H + u]
                  : 0.f;
        }

  prefetch_l2(0);
  float acc[MT][NTW][4];
  int st = 0;
  for (int s = 0; s < a.T; ++s) {
    const int t = rev ? a.T - 1 - s : s;
    bf16* h_w = hblk + (size_t)((s + 1) & 1) * slot_elems;
    for (int gb = gb0; gb < a.gB; gb += a.gBr) {
      const int b0 = gb * a.MB;
      // the accumulators start from xw[t] (K slice 0; the others from 0):
      // its loads land while the stages do
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int i = 0; i < NTW; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = row(b0, m, h), u = unit(i);
            const float* x =
                xw + ((size_t)t * a.B + r) * 4 * H + (size_t)(i % 4) * H + u;
            float2 v = make_float2(0.f, 0.f);
            if (kw == 0 && i / 4 < ocw && r < a.B) {
              if (a.vec && u + 1 < H) {
                v = __ldg(reinterpret_cast<const float2*>(x));
              } else {
                if (u < H) v.x = __ldg(x);
                if (u + 1 < H) v.y = __ldg(x + 1);
              }
            }
            acc[m][i][2 * h] = v.x;
            acc[m][i][2 * h + 1] = v.y;
          }
      if (multi && kw == 0)          // c of this batch tile, back
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int oc = 0; oc < OCW; ++oc)
            if (oc < ocw)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float2 c = *reinterpret_cast<const float2*>(
                    cbuf + (size_t)row(b0, m, h) * a.Hp + unit(4 * oc));
                cst[m][oc][2 * h] = c.x;
                cst[m][oc][2 * h + 1] = c.y;
              }
      for (int k = 0; k < nk; ++k, ++st) {
        const int slot = st % S;
        mbar_wait(ring.full + slot, (st / S) & 1);
        clk.lap(kLoads);
        const bf16* hs = ring.h(slot);
        const bf16* ws = ring.w(slot);
        const int k0 = kw * n16 * 16;
        uint32_t af0[MT][4], bf0[NTW][2], af1[MT][4], bf1[NTW][2];
        load_frags(hs, ws, k0, af0, bf0);
        if (n16 == 1) {
          products(acc, af0, bf0);
        } else {   // k16 step x + 1's fragments load while x multiplies
          for (int x = 0; x < n16; x += 2) {
            load_frags(hs, ws, k0 + 16 * (x + 1), af1, bf1);
            products(acc, af0, bf0);
            if (x + 2 < n16) load_frags(hs, ws, k0 + 16 * (x + 2), af0, bf0);
            products(acc, af1, bf1);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(ring.empty + slot);   // the slot is free
        clk.lap(kProducts);
      }

      // the K slices' partial tiles, added in K order by slice 0's warps
      if (a.WGK > 1) {
        auto at = [&](float* p, int m, int i, int h) {
          return p + (size_t)((wm * MT + m) * 16 + g8 + 8 * h) * LDR +
                 (o0 * 4 + i) * 8 + c2;
        };
        if (kw > 0) {
          float* p = red + (size_t)(kw - 1) * a.MB * LDR;
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int i = 0; i < NTW; ++i)
              if (i / 4 < ocw)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                  *reinterpret_cast<float2*>(at(p, m, i, h)) =
                      make_float2(acc[m][i][2 * h], acc[m][i][2 * h + 1]);
        }
        consumers_sync<kStreamConsumers>();
        if (kw == 0)
          for (int q = 0; q < a.WGK - 1; ++q) {
            float* p = red + (size_t)q * a.MB * LDR;
#pragma unroll
            for (int m = 0; m < MT; ++m)
#pragma unroll
              for (int i = 0; i < NTW; ++i)
                if (i / 4 < ocw)
#pragma unroll
                  for (int h = 0; h < 2; ++h) {
                    const float2 v =
                        *reinterpret_cast<const float2*>(at(p, m, i, h));
                    acc[m][i][2 * h] += v.x;
                    acc[m][i][2 * h + 1] += v.y;
                  }
          }
        consumers_sync<kStreamConsumers>();   // red is read before it is
                                              // rewritten
        clk.lap(kClusterSync);
      }
#ifndef GASR_PROBE_NO_EPILOGUE
      if (kw == 0) {                 // the cell: four gates a lane
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int oc = 0; oc < OCW; ++oc)
            if (oc < ocw)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                float hv[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const float ig = sigmoid(acc[m][4 * oc][2 * h + e]);
                  const float fg = sigmoid(acc[m][4 * oc + 1][2 * h + e]);
                  const float gg = tanhf(acc[m][4 * oc + 2][2 * h + e]);
                  const float og = sigmoid(acc[m][4 * oc + 3][2 * h + e]);
                  float& c = cst[m][oc][2 * h + e];
                  c = fg * c + ig * gg;
                  hv[e] = og * tanhf(c);
                }
                const int r = row(b0, m, h), u = unit(4 * oc);
                if (r >= a.B) continue;
#ifndef GASR_PROBE_NO_OUT
                float* o = a.out + ((size_t)t * a.B + r) * a.D * H +
                           (size_t)d * H + u;
                if (a.vec && u + 1 < H) {
                  *reinterpret_cast<float2*>(o) = make_float2(hv[0], hv[1]);
                } else {
                  if (u < H) o[0] = hv[0];
                  if (u + 1 < H) o[1] = hv[1];
                }
#endif
                *reinterpret_cast<__nv_bfloat162*>(
                    h_w + h_index(r, u, Bp, KS)) =
                    __floats2bfloat162_rn(hv[0], hv[1]);
              }
        if (multi)                   // c of this batch tile, parked
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int oc = 0; oc < OCW; ++oc)
              if (oc < ocw)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                  *reinterpret_cast<float2*>(
                      cbuf + (size_t)row(b0, m, h) * a.Hp + unit(4 * oc)) =
                      make_float2(cst[m][oc][2 * h], cst[m][oc][2 * h + 1]);
      }
#endif
      clk.lap(kEpilogue);
    }
    if (s + 1 < a.T) {
      prefetch_l2(s + 1);
      stream_arrive<kStreamConsumers>(counter);
    }
  }
  clk.flush(a.clocks);
}

typedef void (*StreamKernel)(StreamArgs);
// the instantiation for MT m16 tiles and OCW unit octets a warp
StreamKernel pick_stream(int mt, int ocw) {
  return mt == 1 && ocw == 1   ? lstm_stream_kernel<1, 1>
         : mt == 1 && ocw == 2 ? lstm_stream_kernel<1, 2>
         : mt == 2 && ocw == 1 ? lstm_stream_kernel<2, 1>
         : mt == 2 && ocw == 2 ? lstm_stream_kernel<2, 2>
                               : nullptr;
}

}  // namespace

extern "C" {

// Shared memory of one block at padded width Hp.
int lstm_scan_smem(int Hp) { return (int)smem_bytes(Hp); }

// How many blocks with smem bytes each the current card holds at once.
int lstm_scan_max_blocks(int smem) {
  if (smem > kSmemMax) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaFuncSetAttribute(lstm_scan_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, lstm_scan_kernel, kThreads, smem) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return per_sm * sms;
}

// One launch for the whole recurrence of D directions (1 or 2): direction
// d reads xw_d [T, B, 4H] and w_d [H, 4H] float32, walks backwards in time
// when bit d of rev_mask is set, and writes columns [d H, (d + 1) H) of
// out [T, B, D H]; h0, c0 [B, H] float32. Hp: H rounded up to 16; RB the
// rows of a batch group (a multiple of 32, at most 128), GY <= ceil(B /
// RB) the blocks a unit tile (each walks the groups y, y + GY, ...).
// hbf [D, 2, B, Hp] bf16, cbuf [D, B, Hp] float32 (read only where GY is
// short of the groups) and bar (D Hp / 16 GY 64-bit words, recurrence.cuh)
// are scratch.
int lstm_scan_launch(const float* xw0, const float* xw1, const float* w0,
                     const float* w1, const float* h0, const float* c0,
                     int D, int T, int B, int H, int Hp, int RB, int GY,
                     int rev_mask, float* out, bf16* hbf, float* cbuf,
                     unsigned long long* bar, unsigned long long* clocks,
                     cudaStream_t stream) {
  const int G = (B + RB - 1) / RB;
  if (D < 1 || D > 2 || Hp % UB != 0 || Hp < H || RB % MB != 0 ||
      RB > MB * CH_MAX || RB < MB || T < 1 || B < 1 || GY < 1 || GY > G)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(Hp / UB, GY, D);
  Args a{{xw0, xw1}, {w0, w1}, h0, c0, out, hbf, cbuf, bar, clocks,
         D, T, B, H, Hp, RB, G, rev_mask};
  return (int)launch_cooperative(lstm_scan_kernel, grid, kThreads,
                                 smem_bytes(Hp), 1, stream, a);
}


// The streamed design. Shared memory of a block: S ring stages of a KS-row
// W tile of NU units' four gates and an MB-row h tile, and the partial
// tiles of WGK - 1 K slices.
int lstm_stream_smem(int KS, int MB, int NU, int WGK, int S) {
  return (int)stream_smem(KS, MB, NU, WGK, S);
}

// How many blocks of the streamed design (smem bytes each) the current card
// holds at once: SMs times blocks an SM (0 when none fits).
int lstm_stream_max_blocks(int smem) {
  if (smem > kSmemMax) return 0;
  const StreamKernel kernel = pick_stream(1, 2);
  int per_sm = 0, dev = 0, sms = 0;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kStreamThreads,
                                                    smem) != cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return per_sm * sms;
}

// One launch for the recurrences of D directions (as lstm_scan_launch) on
// D gBr gN blocks: per direction gB batch tiles of MB rows (a multiple of
// 16 up to 128) walked by gBr block rows, gN unit tiles of NU units (a
// multiple of 8), K stages of KS = 64 or 128 rows (Hp: H rounded up to
// 128), warps WGM x WGN x WGK = 8, S ring stages. wblk [D, gN, Hp, 4 NU +
// 8] bf16, hblk [D, 2, Hp / KS, gB MB, KS] bf16, cbuf [D, gB MB, Hp]
// float32 (read only where gB > gBr) and bar (D gBr 64-bit words) are
// scratch, all 16-byte aligned. vec: H even and xw, out 8-byte aligned.
int lstm_stream_launch(const float* xw0, const float* xw1, const float* w0,
                       const float* w1, const float* h0, const float* c0,
                       int D, int T, int B, int H, int Hp, int KS, int MB,
                       int gB, int gBr, int NU, int gN, int WGM, int WGN,
                       int WGK, int S, int rev_mask, int vec, float* out,
                       bf16* wblk, bf16* hblk, float* cbuf,
                       unsigned long long* bar, unsigned long long* clocks,
                       cudaStream_t stream) {
  if (D < 1 || D > 2 || (KS != 64 && KS != 128) || Hp % 128 != 0 ||
      Hp < H || T < 1 || B < 1 || MB % 16 != 0 || MB < 16 || MB > 128 ||
      (size_t)gB * MB < (size_t)B || (size_t)(gB - 1) * MB >= (size_t)B ||
      gBr < 1 || gBr > gB || NU % 8 != 0 || NU < 8 ||
      (size_t)gN * NU < (size_t)Hp || (size_t)(gN - 1) * NU >= (size_t)Hp ||
      WGM < 1 || WGN < 1 || WGK < 1 ||
      WGM * WGN * WGK != kStreamWarps || (MB / 16) % WGM != 0 ||
      KS % (16 * WGK) != 0 || S < 2 || S > kStreamMaxStages ||
      (gB > gBr && cbuf == nullptr))
    return (int)cudaErrorInvalidValue;
  const int mt = MB / 16 / WGM, ocw = (NU / 8 + WGN - 1) / WGN;
  const StreamKernel kernel = pick_stream(mt, ocw);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = stream_smem(KS, MB, NU, WGK, S);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  StreamArgs a{{xw0, xw1}, {w0, w1}, h0, c0, out, wblk, hblk, cbuf, bar,
               clocks, D, T, B, H, Hp, KS, MB, gB, gBr, NU, gN, WGM, WGN,
               WGK, S, rev_mask, vec};
  return (int)launch_cooperative(kernel, dim3(D * gBr * gN), kStreamThreads,
                                 smem, 1, stream, a);
}

}  // extern "C"
