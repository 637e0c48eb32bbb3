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

}  // extern "C"
