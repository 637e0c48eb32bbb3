// Elman recurrence: out[t] = tanh(xw[t] + bf16(h_{t-1}) @ W_hh_bf16),
// float32 accumulation, forward or reverse in time, in one persistent
// launch a call.
//
// Replaces gasr_tpu/ops/pallas/rnn_scan.py::rnn_scan_pallas_raw (`_kernel`)
// with its cast pattern: h carried in float32 and rounded to bf16 only as
// the product's operand, W_hh held in bf16, products summed in float32,
// the float32 sum with xw through tanh. The output keeps xw's time index.
//
// Bound on the card: operations. At T=200, B=256, H=2048 the recurrence
// is 2*T*B*H^2 = 0.43 TFLOP of bf16 products, 0.43 ms at the tensor cores'
// 989 TFLOP/s; its bytes (xw in, out out: 0.84 GB with W_hh's 8 MB) take
// 0.25 ms at 3.35 TB/s. The steps are serial: step t needs all of h_{t-1}.
//
// Design: one cooperative launch walks every step. Clusters of kCluster =
// 8 blocks, one block an SM, 512 threads each.
//   - W_hh resident. Cluster c owns the units [c NU, (c + 1) NU); its block
//     of rank r owns the K rows [r Kb, (r + 1) Kb) of them, Kb = Hp / 8
//     (Hp: H rounded up to 128). The block rounds that W_hh slice to bf16
//     once, into shared memory as W^T (units x K, k contiguous), and keeps
//     it for the whole call. At H = 2048: 15 clusters of NU = 144 units
//     (120 blocks: the card holds 15 clusters of 8 such blocks at once),
//     74 KB of W_hh a block.
//   - The operand, shared by splitting K (why not the other way): a block
//     multiplies only its K rows, so it reads only h_{t-1}[:, r Kb ..
//     (r + 1) Kb) from L2, 128 KB a step at B = 256 and 15 MB a step over
//     the card. Blocks that each took all of K for fewer units would read
//     all of h (1 MB) each, 120 MB a step; sharing those reads by multicast
//     inside a cluster would still push 1 MB a step into every SM's shared
//     memory. The price of the K split is a sum over the cluster's 8
//     partial products: each block writes its float32 partial tile to its
//     own shared memory, the cluster meets at a cluster barrier, and block
//     r sums its MB / 8 rows of the tile from the 8 blocks (distributed
//     shared memory), in rank order, so every run sums alike.
//   - A step, per chunk of MB = 128 batch rows (64 where 128 do not fit):
//     the chunk's K slice of bf16 h_{t-1} (cp.async.cg: from L2, never a
//     stale L1 line) lands in shared memory at once; 16 warps, MB / 32
//     (32 rows) by the rest (a share of the units), multiply it by mma.sync
//     m16n8k16 (A from the staged h, B from the resident W^T, both by
//     ldmatrix; the next k16 step's fragments load while the current one
//     multiplies) into float32 accumulators. The kernel is built for 2, 4,
//     6 and 8 n8 tiles a warp and launched with the fewest that hold NU.
//     The partial tile goes to the block's buffer P once every peer has
//     summed the previous chunk's (a split cluster barrier: a block arrives
//     when its sum is done and waits only before it overwrites P), then the
//     cluster meets and the next chunk's h starts loading during the sum.
//     The sum adds xw[t] (moved into L2 by prefetch during step t - 1,
//     read as the products end), applies tanh, and writes out[t] (float32)
//     and the bf16 copy of h_t into the other slot of a two-slot ping-pong
//     buffer hbf [2, B, Hp], which the next step reads.
//   - The step barrier (recurrence.cuh: one counter in the call's own
//     scratch, a release add a block, acquired by every block) over all
//     blocks sits between steps. A block arrives once its copies of slot
//     t % 2 have landed and been multiplied and its sums are written; a
//     block writes slot t % 2 again at step t + 1, after every block has
//     passed step t's barrier.
// Where the time goes (scripts/torch_recurrence_probe.py, PERF.md): at
// B = 256, H = 2048 a step is ~24 us, a third of it the products (mma.sync
// at ~30% of the tensor cores' rate); reading the peers' partial tiles
// over distributed shared memory (~130 KB a block a step) costs ~4 us and
// the cluster barriers about a sixth; the float32 stores of out hide.
// Rows past B are zero-filled and never summed; units and K rows past H
// have zero weights and zero xw, so their h stays tanh(0) = 0 and adds
// nothing (hbf's padded columns are written as zeros). Every B is taken;
// H is limited by shared memory (rnn_scan_smem): W^T, the staged chunk
// and the partial tile must fit in 227 KB; past that the wrapper takes
// the streamed design below.
#include "recurrence.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace gasr::rec;

constexpr int kThreads = 512;   // 16 warps: MB / 32 (rows) x the rest (units)
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;     // blocks of a cluster: the K split
constexpr int NU_MAX = 192;     // units a cluster: 15 clusters hold
                                // H = 2880, past the shared memory
constexpr int NTW_MAX = 6;      // n8 tiles a warp: NU_MAX / 8 / 4; the
                                // kernel is built for NTW = 2, 4, 6
constexpr int kXPer = 2;        // unit quads a thread sums, per chunk

struct Args {
  const float* xw;     // [T, B, H]
  const float* w;      // [H, H] float32, rounded to bf16 on the way in
  const float* h0;     // [B, H]
  float* out;          // [T, B, H]
  bf16* hbf;           // [2, B, Hp] scratch
  unsigned long long* bar;     // barrier words, one a block (scratch)
  unsigned long long* clocks;   // probe builds only
  int T, B, H, Hp, Kb, NU, MB, reverse, vec;
};

__host__ __device__ inline size_t smem_w(int NU, int Kb) {
  return (size_t)NU * (Kb + 8) * sizeof(bf16);
}
__host__ __device__ inline size_t smem_h(int Kb, int MB) {
  return (size_t)MB * (Kb + 8) * sizeof(bf16);
}
__host__ __device__ inline size_t smem_bytes(int NU, int Kb, int MB) {
  return smem_w(NU, Kb) + smem_h(Kb, MB) +
         (size_t)MB * (NU + 4) * sizeof(float);
}

__device__ __forceinline__ float4 load_x(const Args& a, int t, int b,
                                         int u) {
  const float* p = a.xw + ((size_t)t * a.B + b) * a.H + u;
  if (a.vec && u < a.H) return __ldg(reinterpret_cast<const float4*>(p));
  float v[4];
  for (int e = 0; e < 4; ++e) v[e] = u + e < a.H ? __ldg(p + e) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// The fragments of one k16 step: A, this warp's 32 rows of the staged h
// (two m16 tiles); B, its nt_w n8 tiles of the resident W^T from tile j0
// (both with row stride ld).
template <int NTW>
__device__ __forceinline__ void load_frags(uint32_t (&af)[2][4],
                                           uint32_t (&bf)[NTW][2],
                                           const bf16* hs, const bf16* ws,
                                           int ld, int wm, int j0, int nt_w,
                                           int lane, int k16) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
    ldsm_x4(af[m],
            hs + (wm * 32 + m * 16 + a_row(lane)) * ld + k16 + a_col(lane));
#pragma unroll
  for (int i = 0; i < NTW; i += 2) {
    if (i + 1 < nt_w) {
      uint32_t q[4];
      ldsm_x4(q, ws + ((j0 + i) * 8 + b_row(lane)) * ld + k16 + b_col(lane));
      bf[i][0] = q[0];
      bf[i][1] = q[1];
      bf[i + 1][0] = q[2];
      bf[i + 1][1] = q[3];
    } else if (i < nt_w) {
      ldsm_x2(bf[i], ws + ((j0 + i) * 8 + (lane & 7)) * ld + k16 +
                         b_col(lane));
    }
  }
}

// NTW: the most n8 tiles a warp holds (its accumulators and fragments)
template <int NTW>
__global__ void __launch_bounds__(kThreads, 1) rnn_scan_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n0 = (blockIdx.x / kCluster) * a.NU;   // the cluster's units
  const int nu = min(a.NU, a.Hp - n0);             // a multiple of 8
  const int k0 = rank * a.Kb;                      // this block's K rows
  const int MB = a.MB, RR = MB / kCluster;         // rows a block sums
  const int LDW = a.Kb + 8;
  const int LDP = a.NU + 4;
  bf16* Ws = reinterpret_cast<bf16*>(smem);              // [NU][Kb + 8]
  bf16* hs = reinterpret_cast<bf16*>(smem + smem_w(a.NU, a.Kb));  // [MB][Kb+8]
  float* P = reinterpret_cast<float*>(smem + smem_w(a.NU, a.Kb) +
                                      smem_h(a.Kb, MB));  // [MB][NU + 4]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nwn = kWarps / (MB / 32);              // warps along the units
  const int wm = warp / nwn, wn = warp % nwn;
  const int ntiles = nu / 8;
  const int nt_w = ntiles / nwn + (wn < ntiles % nwn);
  const int j0 = wn * (ntiles / nwn) + min(wn, ntiles % nwn);  // first tile
  const int nch = (a.B + MB - 1) / MB;
  const int nq = nu / 4;                           // unit quads summed
  Clock clk;
  clk.start();

  // W_hh's slice, rounded to bf16, transposed: read along units
  for (int i = tid; i < a.NU * a.Kb; i += kThreads) {
    const int u = i % a.NU, k = i / a.NU;
    const int gu = n0 + u, gk = k0 + k;
    const float v = gu < a.H && gk < a.H ? a.w[(size_t)gk * a.H + gu] : 0.f;
    Ws[u * LDW + k] = __float2bfloat16_rn(v);
  }
  // h0 into slot 0: the elements this block sums (rows RR rank .. + RR of
  // every chunk, the cluster's units), zeros past H
  for (int c = 0; c < nch; ++c)
    for (int i = tid; i < RR * nu; i += kThreads) {
      const int b = c * MB + rank * RR + i / nu, u = n0 + i % nu;
      if (b < a.B)
        a.hbf[(size_t)b * a.Hp + u] =
            __float2bfloat16_rn(u < a.H ? a.h0[(size_t)b * a.H + u] : 0.f);
    }

  // this thread's sums in a chunk: element e = tid + j kThreads, j <
  // kXPer, is row rank RR + e / nq of the chunk and units n0 + 4 (e % nq)
  auto elem = [&](int j, int c, int& b, int& u) {
    const int e = tid + j * kThreads;
    b = c * MB + rank * RR + e / nq;
    u = n0 + 4 * (e % nq);
    return e < RR * nq && b < a.B;
  };
  // xw of step s into L2, ahead of the step that reads it: a prefetch has
  // no result, so no fence or barrier waits for it
  auto prefetch_l2 = [&](int s) {
    const int t = a.reverse ? a.T - 1 - s : s;
    for (int c = 0; c < nch; ++c)
#pragma unroll
      for (int j = 0; j < kXPer; ++j) {
        int b, u;
        if (elem(j, c, b, u) && u < a.H)
          asm volatile("prefetch.global.L2 [%0];" ::"l"(
              a.xw + ((size_t)t * a.B + b) * a.H + u));
      }
  };
  prefetch_l2(0);
  clk.lap(kLoads);   // the prologue: W_hh and h0
  prologue_barrier(a.bar, gridDim.x);
  clk.lap(kWait);

  float acc[2][NTW][4];
  for (int s = 0; s < a.T; ++s) {
    const int t = a.reverse ? a.T - 1 - s : s;
    const bf16* h_r = a.hbf + (size_t)(s & 1) * a.B * a.Hp;
    bf16* h_w = a.hbf + (size_t)((s + 1) & 1) * a.B * a.Hp;

    // chunk c's rows of bf16 h_{t-1}, this block's K slice, into hs
    auto load_h = [&](int c) {
      const bf16* src = h_r + (size_t)c * MB * a.Hp + k0;
      for (int i = tid; i < MB * (a.Kb / 8); i += kThreads) {
        const int r = i / (a.Kb / 8), cc = (i % (a.Kb / 8)) * 8;
        const bool ok = c * MB + r < a.B;
#ifndef GASR_PROBE_NO_LOADS
        cp_async16(hs + r * LDW + cc, ok ? src + (size_t)r * a.Hp + cc : src,
                   ok);
#endif
      }
      cp_async_commit();
    };
    load_h(0);
    if (s + 1 < a.T) prefetch_l2(s + 1);

    for (int c = 0; c < nch; ++c) {
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int i = 0; i < NTW; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][i][e] = 0.f;
      cp_async_wait<0>();   // the chunk has landed ...
      __syncthreads();      // ... for every thread
      clk.lap(kLoads);
      if (c * MB + wm * 32 < a.B) {   // this warp has a real row
        // fragments of k16 step k + 1 load while step k multiplies
        uint32_t af[2][2][4], bf[2][NTW][2];
        const int n16 = a.Kb / 16;
        load_frags(af[0], bf[0], hs, Ws, LDW, wm, j0, nt_w, lane, 0);
        for (int k = 0; k < n16; k += 2) {
#pragma unroll
          for (int cur = 0; cur < 2; ++cur) {
            if (k + cur >= n16) break;
            if (k + cur + 1 < n16)
              load_frags(af[cur ^ 1], bf[cur ^ 1], hs, Ws, LDW, wm, j0, nt_w,
                         lane, 16 * (k + cur + 1));
#pragma unroll
            for (int i = 0; i < NTW; ++i)
              if (i < nt_w)
#pragma unroll
                for (int m = 0; m < 2; ++m)
                  mma16816(acc[m][i], af[cur][m], bf[cur][i][0],
                           bf[cur][i][1]);
          }
        }
      }
      clk.lap(kProducts);
      // this chunk's xw (in L2 since the step before), read while the
      // cluster meets
      float4 x[kXPer];
#pragma unroll
      for (int j = 0; j < kXPer; ++j) {
        int b, u;
        x[j] = elem(j, c, b, u) ? load_x(a, t, b, u)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
      }

      // the partial tile into P, once every peer has summed the previous
      // chunk's (each arrived when it had, before its products); then the
      // cluster's sum
      if (c > 0) cluster_wait();
      const int g = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int i = 0; i < NTW; ++i)
          if (i < nt_w) {
            float* p = P + (wm * 32 + m * 16 + g) * LDP + (j0 + i) * 8 + c2;
            *reinterpret_cast<float2*>(p) =
                make_float2(acc[m][i][0], acc[m][i][1]);
            *reinterpret_cast<float2*>(p + 8 * LDP) =
                make_float2(acc[m][i][2], acc[m][i][3]);
          }
      cluster.sync();   // the partial tiles are written; hs is free
      if (c + 1 < nch) load_h(c + 1);   // lands during the sum
      clk.lap(kClusterSync);
#ifndef GASR_PROBE_NO_EPILOGUE
      // every partial this thread sums, all loads issued before any use
      float4 part[kXPer][kCluster];
#pragma unroll
      for (int j = 0; j < kXPer; ++j) {
        int b, u;
        const bool ok = elem(j, c, b, u);
        const float* mine = P + (b - c * MB) * LDP + (u - n0);
#pragma unroll
        for (int src = 0; src < kCluster; ++src)
#ifndef GASR_PROBE_NO_SUM
          part[j][src] = ok ? *reinterpret_cast<const float4*>(
                                  cluster.map_shared_rank(mine, src))
                            : make_float4(0.f, 0.f, 0.f, 0.f);
#else   // the block's own partials in place of its peers' (time only)
          part[j][src] = ok ? *reinterpret_cast<const float4*>(mine)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
#endif
      }
#pragma unroll
      for (int j = 0; j < kXPer; ++j) {
        int b, u;
        if (!elem(j, c, b, u)) continue;
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int src = 0; src < kCluster; ++src) {   // in rank order
          sum.x += part[j][src].x;
          sum.y += part[j][src].y;
          sum.z += part[j][src].z;
          sum.w += part[j][src].w;
        }
        const float h[4] = {tanhf(x[j].x + sum.x), tanhf(x[j].y + sum.y),
                            tanhf(x[j].z + sum.z), tanhf(x[j].w + sum.w)};
#ifndef GASR_PROBE_NO_OUT
        float* o = a.out + ((size_t)t * a.B + b) * a.H + u;
        if (a.vec && u < a.H) {
          *reinterpret_cast<float4*>(o) = make_float4(h[0], h[1], h[2], h[3]);
        } else {
          for (int e2 = 0; e2 < 4; ++e2)
            if (u + e2 < a.H) o[e2] = h[e2];
        }
#endif
        store_bf16x4(h_w + (size_t)b * a.Hp + u, h);
      }
#endif
      if (c + 1 < nch) cluster_arrive();   // done with the peers' P
      clk.lap(kEpilogue);
    }
    if (s + 1 < a.T) {
      step_barrier(a.bar, gridDim.x, blockIdx.x, s + 1);
      clk.lap(kWait);
    }
  }
  cluster.sync();   // no block leaves while a peer may read its P
  clk.flush(a.clocks);
}

// The instantiation that holds NU units a cluster in chunks of MB rows:
// the fewest n8 tiles a warp that cover NU / 8 tiles over the warps along
// the units (nullptr past NTW_MAX).
typedef void (*Kernel)(Args);
Kernel pick(int NU, int MB) {
  const int nwn = kWarps / (MB / 32);
  const int ntw = (NU / 8 + nwn - 1) / nwn;
  return ntw <= 2   ? rnn_scan_kernel<2>
         : ntw <= 4 ? rnn_scan_kernel<4>
         : ntw <= 6 ? rnn_scan_kernel<6>
                    : nullptr;
}

// ---- The streamed design: W_hh past shared-memory residency.
//
// One cooperative launch; blocks tile the output over batch and units
// together: a block computes a tile h_t[b0 .. b0 + MB, n0 .. n0 + NU) from
// h_{t-1}[b0 .. b0 + MB, :] and W_hh[:, n0 .. n0 + NU), so a step reads
// about gB H^2 2 + gN B H 2 bytes from L2 for gB batch tiles and gN unit
// tiles (the wrapper's `stream_plan` picks MB and NU for the fewest bytes
// a block reads). The grid is gBr x gN blocks, one an SM; where the batch
// has more tiles than gBr, block row gb0 walks the tiles gb0, gb0 + gBr,
// .. in turn each step.
//   - Layouts made for bulk copies. The prologue rounds W_hh to bf16 once
//     a call into the scratch wblk [gN][Hp][NU] (each block's columns
//     contiguous, zeros past H; NU / 8 odd, so the eight k rows of an
//     ldmatrix fall in eight bank groups), writes each block's tiles of
//     bf16 h0 into slot 0 of the ping-pong buffer hblk [2][Hp / 128][Bp]
//     [128] (a K stage's rows of a batch tile contiguous; the 16-byte chunk
//     q of row r at q ^ (r % 8), so ldmatrix reads them without bank
//     conflicts; rows past B zero in both slots), and the grid meets once.
//   - A copy warp (one thread) streams K in stages of kStreamK = 128 rows:
//     the stage's W tile [128][NU] and h tile [MB][128], each one bulk
//     copy (the tensor memory accelerator) into a ring of S stages counted
//     by full / empty mbarriers, as soon as a slot is free. Each block
//     walks K from its own first stage (gn Hp / 128 / gN), so the blocks of
//     a row do not all read the same h chunk at once. At a step's first
//     tile it issues the W copies of the first S stages, waits at the step
//     barrier (the gN blocks of its block row: the only writers and
//     readers of those rows of h), then issues the h copies.
//   - 8 consumer warps: WGM along the rows, WGN along the units, WGK along
//     each stage's K, mma.sync m16n8k16 (A by ldmatrix, B by
//     ldmatrix.trans from the k-major W tile; the next k16 step's
//     fragments load while the current one multiplies); the K slices'
//     partial tiles are summed through shared memory in K order, K slice
//     0's starting from xw[t] (prefetched into L2 during the step before,
//     loaded as a tile starts); its warps apply tanh and write out[t]
//     (float32) and bf16 h_t into the other slot of hblk; then one thread
//     arrives at the step barrier.
// Memory order: h_t is written by generic stores and read by the next
// step's bulk copies (the async proxy): every writer fences the proxies
// (fence.proxy.async.global) before the block's release, and the copy
// thread fences them after its acquire.
constexpr int kStreamConsumers = 256;                  // 8 warps
constexpr int kStreamWarps = kStreamConsumers / 32;
constexpr int kStreamThreads = kStreamConsumers + 32;  // + the copy warp
constexpr int kStreamK = 128;    // K rows a stage
constexpr int kStreamMaxStages = 8;

struct StreamArgs {
  const float* xw;     // [T, B, H]
  const float* w;      // [H, H] float32
  const float* h0;     // [B, H]
  float* out;          // [T, B, H]
  bf16* wblk;          // [gN][Hp][NU] scratch: bf16 W_hh by unit tile
  bf16* hblk;          // [2][Hp / 128][gB MB][128] scratch (swizzled)
  unsigned long long* bar;      // gBr gN words (scratch)
  unsigned long long* clocks;   // probe builds only
  int T, B, H, Hp, MB, gB, gBr, NU, gN, WGM, WGN, WGK, S, reverse, vec;
};

__host__ __device__ inline size_t stream_stage(int MB, int NU) {
  return ((size_t)MB + NU) * kStreamK * sizeof(bf16);
}
__host__ __device__ inline size_t stream_red(int MB, int NU, int WGK) {
  return (size_t)(WGK - 1) * MB * (NU + 4) * sizeof(float);
}
__host__ __device__ inline size_t stream_smem(int MB, int NU, int WGK,
                                              int S) {
  return S * stream_stage(MB, NU) + stream_red(MB, NU, WGK) +
         2 * (size_t)S * sizeof(uint64_t);
}

// element (r, u) of one slot of hblk (Bp rows)
__device__ __forceinline__ size_t h_index(int r, int u, int Bp) {
  const int k = u / kStreamK, c = u % kStreamK;
  return ((size_t)k * Bp + r) * kStreamK +
         ((((c >> 3) ^ (r & 7)) << 3) | (c & 7));
}

// the consumer warps' barrier (the copy warp does not take part)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kStreamConsumers) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// MT: m16 tiles a warp (1 or 2); NTW: n8 tiles a warp. Every warp runs
// MT x NTW products each k16 step, with no condition around them (a
// condition puts each mma.sync in a convergence region of its own, and
// they no longer overlap): a warp that owns fewer n8 tiles multiplies a
// copy of its last column into accumulators it never stores.
template <int MT, int NTW>
__global__ void __launch_bounds__(kStreamThreads, 1)
rnn_stream_kernel(StreamArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int gb0 = blockIdx.x / a.gN, gn = blockIdx.x % a.gN;
  const int n0 = gn * a.NU;
  const int nu = min(a.NU, a.Hp - n0);          // a multiple of 8
  const int Bp = a.gB * a.MB, nk = a.Hp / kStreamK, S = a.S;
  const int rot = (int)((long long)gn * nk / a.gN);   // this block's first
  const int LDR = a.NU + 4;                           // K stage
  const size_t stage_bytes = stream_stage(a.MB, a.NU);
  const size_t slot_elems = (size_t)nk * Bp * kStreamK;
  float* red = reinterpret_cast<float*>(smem + S * stage_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + S * stage_bytes + stream_red(a.MB, a.NU, a.WGK));
  uint64_t* empty = full + S;
  unsigned long long* counter = a.bar + (size_t)gb0 * a.gN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  Clock clk;
  clk.start();

  // W_hh rounded to bf16 once into wblk: groups of 8 units (16 bytes),
  // four rows at a time per block so that 8 loads of 16 bytes are in
  // flight a thread (float4 where the rows are 16-byte aligned)
  {
    const int groups = a.Hp / 8;
    const bool v4 =
        a.H % 4 == 0 && (reinterpret_cast<uintptr_t>(a.w) & 15) == 0;
    for (int k0 = blockIdx.x; k0 < a.Hp; k0 += 4 * gridDim.x)
      for (int j = tid; j < groups; j += kStreamThreads) {
        const int u = 8 * j;
        float v[4][8];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = k0 + q * gridDim.x;
          const float* wr = a.w + (size_t)k * a.H + u;
          if (k < a.H && v4 && u + 8 <= a.H) {
            const float4 lo = __ldg(reinterpret_cast<const float4*>(wr));
            const float4 hi = __ldg(reinterpret_cast<const float4*>(wr + 4));
            v[q][0] = lo.x; v[q][1] = lo.y; v[q][2] = lo.z; v[q][3] = lo.w;
            v[q][4] = hi.x; v[q][5] = hi.y; v[q][6] = hi.z; v[q][7] = hi.w;
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              v[q][e] = k < a.H && u + e < a.H ? __ldg(wr + e) : 0.f;
          }
        }
        const int gu = u / a.NU, ju = u - gu * a.NU;   // its unit tile
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = k0 + q * gridDim.x;
          if (k >= a.Hp) continue;
          uint4 pk;
          uint32_t* w32 = reinterpret_cast<uint32_t*>(&pk);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            __nv_bfloat162 b2 =
                __floats2bfloat162_rn(v[q][2 * e], v[q][2 * e + 1]);
            w32[e] = *reinterpret_cast<uint32_t*>(&b2);
          }
          *reinterpret_cast<uint4*>(
              a.wblk + ((size_t)gu * a.Hp + k) * a.NU + ju) = pk;
        }
      }
  }
  // this block's tiles of h0 into slot 0; rows past B zero in both slots
  for (int gb = gb0; gb < a.gB; gb += a.gBr)
    for (int i = tid; i < a.MB * nu; i += kStreamThreads) {
      const int r = gb * a.MB + i / nu, u = n0 + i % nu;
      const size_t e = h_index(r, u, Bp);
      a.hblk[e] = __float2bfloat16_rn(
          r < a.B && u < a.H ? a.h0[(size_t)r * a.H + u] : 0.f);
      if (r >= a.B) a.hblk[slot_elems + e] = __float2bfloat16_rn(0.f);
    }
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kStreamWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_proxy_async();
  clk.lap(kLoads);   // the prologue: W_hh rounded, h0
  prologue_barrier(a.bar, a.gBr * a.gN);
  clk.lap(kWait);

  auto stage_w = [&](int slot) {
    return reinterpret_cast<bf16*>(smem + slot * stage_bytes);
  };
  auto stage_h = [&](int slot) { return stage_w(slot) + kStreamK * a.NU; };

  if (warp == kStreamWarps) {        // the copy warp: one thread
    if (lane != 0) return;
    fence_proxy_async();
    const uint32_t w_bytes = kStreamK * a.NU * sizeof(bf16);
    const uint32_t h_bytes = a.MB * kStreamK * sizeof(bf16);
    // ring stage st (the call's running count) holds K stage k of a tile,
    // rotated: this block's k-th is rot + k
    auto issue_w = [&](int st, int k) {
      const int slot = st % S, kr = (rot + k) % nk;
      if (st >= S) mbar_wait(empty + slot, (st / S - 1) & 1);
#ifndef GASR_PROBE_NO_LOADS
      bulk_copy(stage_w(slot),
                a.wblk + ((size_t)gn * a.Hp + (size_t)kr * kStreamK) * a.NU,
                w_bytes, full + slot, false);
#endif
    };
    auto issue_h = [&](int st, int k, const bf16* h_r, int gb) {
      const int slot = st % S, kr = (rot + k) % nk;
#ifndef GASR_PROBE_NO_LOADS
      bulk_copy(stage_h(slot),
                h_r + ((size_t)kr * Bp + (size_t)gb * a.MB) * kStreamK,
                h_bytes, full + slot, true);
#else
      mbar_arrive(full + slot);
#endif
    };
    int st = 0;
    for (int s = 0; s < a.T; ++s) {
      const bf16* h_r = a.hblk + (size_t)(s & 1) * slot_elems;
      for (int gb = gb0; gb < a.gB; gb += a.gBr) {
        const int pre = (gb == gb0 && s > 0) ? min(S, nk) : 0;
        for (int k = 0; k < pre; ++k) issue_w(st + k, k);   // no h needed
        if (pre > 0) {               // the step barrier: h_{t-1} is whole
#ifndef GASR_PROBE_NO_BARRIER
          wait_word(counter, (unsigned long long)a.gN * s);
#endif
          fence_proxy_async();
        }
        for (int k = 0; k < nk; ++k) {
          if (k >= pre) issue_w(st + k, k);
          issue_h(st + k, k, h_r, gb);
        }
        st += nk;
      }
    }
    return;
  }

  // ---- the consumer warps
  const int wn = warp % a.WGN, wm = (warp / a.WGN) % a.WGM;
  const int kw = warp / (a.WGN * a.WGM);
  const int ntiles = nu / 8;
  const int nt_w = ntiles / a.WGN + (wn < ntiles % a.WGN);
  const int j0 = wn * (ntiles / a.WGN) + min(wn, ntiles % a.WGN);
  const int n16 = kStreamK / a.WGK / 16;        // k16 steps a stage
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  // this lane's ldmatrix rows: A, row r_m of m16 tile m (its swizzle);
  // B, the W tile's k row and the column of n8 tile i (tiles past the
  // warp's last read its last: products never stored)
  int a_off[MT], a_swz[MT], b_col[NTW];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int row = (wm * MT + m) * 16 + a_row(lane);
    a_off[m] = row * kStreamK;
    a_swz[m] = row & 7;
  }
#pragma unroll
  for (int i = 0; i < NTW; i += 2) {
    const int last = max(j0 + nt_w - 1, 0);
    b_col[i] = min(j0 + i + (lane >> 4), last) * 8;      // x4: tiles i, i+1
    if (i + 1 < NTW) b_col[i + 1] = min(j0 + i + 1, last) * 8;
    if (i + 1 == NTW) b_col[i] = min(j0 + i, last) * 8;  // x2: tile i
  }
  const int b_row = (lane & 7) + 8 * ((lane >> 3) & 1);

  // this thread's xw elements of step s into L2, ahead of their use
  auto prefetch_l2 = [&](int s) {
    if (kw != 0) return;
    const int t = a.reverse ? a.T - 1 - s : s;
    for (int gb = gb0; gb < a.gB; gb += a.gBr)
      for (int m = 0; m < MT; ++m)
        for (int i = 0; i < nt_w; ++i)
          for (int h = 0; h < 2; ++h) {
            const int r = gb * a.MB + (wm * MT + m) * 16 + g + 8 * h;
            const int u = n0 + (j0 + i) * 8 + c2;
            if (r < a.B && u < a.H)
              asm volatile("prefetch.global.L2 [%0];" ::"l"(
                  a.xw + ((size_t)t * a.B + r) * a.H + u));
          }
  };
  // the fragments of k16 step kk of a stage: A, this warp's rows of the h
  // tile (swizzled chunks); B, its n8 tiles of the W tile (k-major)
  auto load_frags = [&](const bf16* hs, const bf16* ws, int kk,
                        uint32_t (&af)[MT][4], uint32_t (&bf)[NTW][2]) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int q = (kk + a_col(lane)) >> 3;
      ldsm_x4(af[m], hs + a_off[m] + ((q ^ a_swz[m]) << 3));
    }
    const bf16* wk = ws + (kk + b_row) * a.NU;
#pragma unroll
    for (int i = 0; i < NTW; i += 2) {
      if (i + 1 < NTW) {
        uint32_t q4[4];
        ldsm_x4_t(q4, wk + b_col[i]);
        bf[i][0] = q4[0];
        bf[i][1] = q4[1];
        bf[i + 1][0] = q4[2];
        bf[i + 1][1] = q4[3];
      } else {
        ldsm_x2_t(bf[i], wk + b_col[i]);
      }
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

  prefetch_l2(0);
  float acc[MT][NTW][4];
  int st = 0;
  for (int s = 0; s < a.T; ++s) {
    const int t = a.reverse ? a.T - 1 - s : s;
    bf16* h_w = a.hblk + (size_t)((s + 1) & 1) * slot_elems;
    for (int gb = gb0; gb < a.gB; gb += a.gBr) {
      const int b0 = gb * a.MB;
      // the accumulators start from xw[t] (K slice 0; the others from 0):
      // its loads land while the stages do, off the step's critical path
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int i = 0; i < NTW; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = b0 + (wm * MT + m) * 16 + g + 8 * h;
            const int u = n0 + (j0 + i) * 8 + c2;
            const float* x = a.xw + ((size_t)t * a.B + r) * a.H + u;
            float2 v = make_float2(0.f, 0.f);
            if (kw == 0 && i < nt_w && r < a.B) {
              if (a.vec && u + 1 < a.H) {
                v = __ldg(reinterpret_cast<const float2*>(x));
              } else {
                if (u < a.H) v.x = __ldg(x);
                if (u + 1 < a.H) v.y = __ldg(x + 1);
              }
            }
            acc[m][i][2 * h] = v.x;
            acc[m][i][2 * h + 1] = v.y;
          }
      for (int k = 0; k < nk; ++k, ++st) {
        const int slot = st % S;
        mbar_wait(full + slot, (st / S) & 1);
        clk.lap(kLoads);
        const bf16* hs = stage_h(slot);
        const bf16* ws = stage_w(slot);
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
        if (lane == 0) mbar_arrive(empty + slot);   // the slot is free
        clk.lap(kProducts);
      }

      // the K slices' partial tiles, summed in K order by slice 0's warps
      if (a.WGK > 1) {
        if (kw > 0) {
          float* p = red + (size_t)(kw - 1) * a.MB * LDR;
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int i = 0; i < NTW; ++i)
              if (i < nt_w)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                  *reinterpret_cast<float2*>(
                      p + ((wm * MT + m) * 16 + g + 8 * h) * LDR +
                      (j0 + i) * 8 + c2) =
                      make_float2(acc[m][i][2 * h], acc[m][i][2 * h + 1]);
        }
        consumers_sync();
        if (kw == 0)
          for (int q = 0; q < a.WGK - 1; ++q) {
            const float* p = red + (size_t)q * a.MB * LDR;
#pragma unroll
            for (int m = 0; m < MT; ++m)
#pragma unroll
              for (int i = 0; i < NTW; ++i)
                if (i < nt_w)
#pragma unroll
                  for (int h = 0; h < 2; ++h) {
                    const float2 v = *reinterpret_cast<const float2*>(
                        p + ((wm * MT + m) * 16 + g + 8 * h) * LDR +
                        (j0 + i) * 8 + c2);
                    acc[m][i][2 * h] += v.x;
                    acc[m][i][2 * h + 1] += v.y;
                  }
          }
        consumers_sync();            // red is read before it is rewritten
        clk.lap(kClusterSync);
      }
#ifndef GASR_PROBE_NO_EPILOGUE
      if (kw == 0) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int i = 0; i < NTW; ++i)
            if (i < nt_w)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int r = b0 + (wm * MT + m) * 16 + g + 8 * h;
                const int u = n0 + (j0 + i) * 8 + c2;
                if (r >= a.B) continue;
                const size_t o = ((size_t)t * a.B + r) * a.H + u;
                const float y0 = tanhf(acc[m][i][2 * h]);
                const float y1 = tanhf(acc[m][i][2 * h + 1]);
#ifndef GASR_PROBE_NO_OUT
                if (a.vec && u + 1 < a.H) {
                  *reinterpret_cast<float2*>(a.out + o) =
                      make_float2(y0, y1);
                } else {
                  if (u < a.H) a.out[o] = y0;
                  if (u + 1 < a.H) a.out[o + 1] = y1;
                }
#endif
                *reinterpret_cast<__nv_bfloat162*>(h_w +
                                                   h_index(r, u, Bp)) =
                    __floats2bfloat162_rn(y0, y1);
              }
      }
#endif
      clk.lap(kEpilogue);
    }
    if (s + 1 < a.T) {
      prefetch_l2(s + 1);
      fence_proxy_async();           // h_t, for the next step's copies
      consumers_sync();
      if (tid == 0) {                // the block's arrival
        __threadfence();
#ifndef GASR_PROBE_NO_BARRIER
        asm volatile("red.release.gpu.global.add.u64 [%0], 1;" ::"l"(
                         counter)
                     : "memory");
#endif
      }
    }
  }
  clk.flush(a.clocks);
}

typedef void (*StreamKernel)(StreamArgs);
// the instantiation for MT m16 tiles and at most ntw n8 tiles a warp
template <int MT>
StreamKernel pick_ntw(int ntw) {
  switch (ntw) {
    case 1: return rnn_stream_kernel<MT, 1>;
    case 2: return rnn_stream_kernel<MT, 2>;
    case 3: return rnn_stream_kernel<MT, 3>;
    case 4: return rnn_stream_kernel<MT, 4>;
    case 5: return rnn_stream_kernel<MT, 5>;
    case 6: return rnn_stream_kernel<MT, 6>;
    case 7: return rnn_stream_kernel<MT, 7>;
    case 8: return rnn_stream_kernel<MT, 8>;
    default: return nullptr;
  }
}
StreamKernel pick_stream(int mt, int ntw) {
  return mt == 1 ? pick_ntw<1>(ntw) : mt == 2 ? pick_ntw<2>(ntw) : nullptr;
}

}  // namespace

extern "C" {

// Shared memory of one block for a cluster of NU units, K slices of Kb and
// chunks of MB rows.
int rnn_scan_smem(int NU, int Kb, int MB) {
  return (int)smem_bytes(NU, Kb, MB);
}

// How many clusters of kCluster blocks with smem bytes each, of the
// instantiation for NU units a cluster and MB-row chunks, the current card
// holds at once (0 when it cannot hold one).
int rnn_scan_max_clusters(int NU, int MB, int smem) {
  if (smem > kSmemMax || (MB != 64 && MB != 128)) return 0;
  const Kernel kernel = pick(NU, MB);
  if (kernel == nullptr ||
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, (void*)kernel, &cfg) !=
      cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

// One launch for the whole recurrence on G clusters of NU units (Hp: H
// rounded up to 128; Kb = Hp / 8; chunks of MB = 64 or 128 rows). hbf
// [2, B, Hp] bf16 and bar (G kCluster 64-bit words, recurrence.cuh) are
// scratch. vec: H % 4 == 0 and xw, out 16-byte aligned.
int rnn_scan_launch(const float* xw, const float* w, const float* h0, int T,
                    int B, int H, int Hp, int NU, int G, int MB, int reverse,
                    int vec, float* out, bf16* hbf,
                    unsigned long long* bar, unsigned long long* clocks,
                    cudaStream_t stream) {
  if (Hp % 128 != 0 || Hp < H || NU % 8 != 0 || NU > NU_MAX ||
      (size_t)G * NU < (size_t)Hp || (MB != 64 && MB != 128) || T < 1 ||
      B < 1 || G * kCluster > kThreads)
    return (int)cudaErrorInvalidValue;
  Args a{xw, w, h0, out, hbf, bar, clocks, T, B, H, Hp,
         Hp / kCluster, NU, MB, reverse, vec};
  const Kernel kernel = pick(NU, MB);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return (int)launch_cooperative(kernel, dim3(G * kCluster), kThreads,
                                 smem_bytes(NU, a.Kb, MB), kCluster, stream,
                                 a);
}


// The streamed design. Shared memory of a block: S ring stages of an MB-row
// h tile and an NU-unit W tile, and the partial tiles of WGK - 1 K slices.
int rnn_stream_smem(int MB, int NU, int WGK, int S) {
  return (int)stream_smem(MB, NU, WGK, S);
}

// How many blocks of the streamed design (smem bytes each) the current card
// holds at once: SMs times blocks an SM (0 when none fits).
int rnn_stream_max_blocks(int smem) {
  if (smem > kSmemMax) return 0;
  const StreamKernel kernel = pick_stream(2, 8);
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

// One launch for the whole recurrence on gBr x gN blocks (gB batch tiles
// of MB rows, a multiple of 16 up to 128, walked by gBr block rows; unit
// tiles of NU, a multiple of 8; warps WGM x WGN x WGK = 8; S ring stages).
// wblk [gN, Hp, NU] bf16, hblk [2, Hp / 128, gB MB, 128] bf16 and bar (gBr
// gN 64-bit words) are scratch, all 16-byte aligned. vec: H even and xw,
// out 8-byte aligned.
int rnn_stream_launch(const float* xw, const float* w, const float* h0,
                      int T, int B, int H, int Hp, int MB, int gB, int gBr,
                      int NU, int gN, int WGM, int WGN, int WGK, int S,
                      int reverse, int vec, float* out, bf16* wblk,
                      bf16* hblk, unsigned long long* bar,
                      unsigned long long* clocks, cudaStream_t stream) {
  if (Hp % kStreamK != 0 || Hp < H || T < 1 || B < 1 || MB % 16 != 0 ||
      MB < 16 || MB > 128 || (size_t)gB * MB < (size_t)B ||
      (size_t)(gB - 1) * MB >= (size_t)B || gBr < 1 || gBr > gB ||
      NU % 8 != 0 ||
      (size_t)gN * NU < (size_t)Hp || (size_t)(gN - 1) * NU >= (size_t)Hp ||
      WGM * WGN * WGK != kStreamWarps || (MB / 16) % WGM != 0 ||
      MB / 16 / WGM > 2 || kStreamK % (16 * WGK) != 0 || S < 2 ||
      S > kStreamMaxStages)
    return (int)cudaErrorInvalidValue;
  const int ntw = (NU / 8 + WGN - 1) / WGN;
  const StreamKernel kernel = pick_stream(MB / 16 / WGM, ntw);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = stream_smem(MB, NU, WGK, S);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  StreamArgs a{xw, w, h0, out, wblk, hblk, bar, clocks, T, B, H, Hp, MB,
               gB, gBr, NU, gN, WGM, WGN, WGK, S, reverse, vec};
  return (int)launch_cooperative(kernel, dim3(gBr * gN), kStreamThreads,
                                 smem, 1, stream, a);
}

}  // extern "C"
