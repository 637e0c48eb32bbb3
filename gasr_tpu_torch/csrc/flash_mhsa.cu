// Rel-pos multi-head self-attention, forward: an online softmax over key
// tiles with the Transformer-XL position term read from a band of the
// relative-position projection (no rel-shift tensor, no O(T^2) tensor in
// device memory).
//
// Replaces gasr_tpu/ops/pallas/flash_mhsa.py::flash_mhsa_rel (`_kernel`).
// The TPU kernel factorizes the sinusoid bias by angle addition only
// because Mosaic cannot gather across 128-lane vregs; here the shift is
// an index. Per (batch b, head h) and query t:
//   qu = bf16(q + u), qv = bf16(q + vb)
//   bd(t, s) = qv_t . R_h[(T-1) - (t - s)]   (R: [2T-1, H*dh] bf16, from
//                                             the wrapper)
//   score(t, s) = (qu_t . k_s + bd(t, s)) / sqrt(dh); keys s >= lengths[b]
//   are masked; out(t) = softmax(score) . v      (bf16 or float32)
// Every product is a bf16 product summed in float32. The softmax is the
// online one: the unnormalised p~ = exp(score - running max) is rounded
// to bf16 before its product with v and the sum is divided out at the end.
// flash_ref rounds the normalised attention instead; both are 2^-8
// relative, inside the 0.02 * max(1, max|ref|) bound the JAX package holds
// its kernel to. A length of 0 averages v over the T keys (flash_ref's
// rule); lengths above T act as T.
//
// Bound on the card: device memory. At conformer_l (B=64, H=8, T=300,
// dh=64) q, k, v in and the output out are 79.7 MB with wr (0.024 ms at
// 3.35 TB/s); the products the function needs are 18 GFLOP (0.018 ms at
// 989 TFLOP/s).
// Design: one block of 4 warps per (64 queries, h, b); warp w owns query
// rows 16w..16w+15 and keeps their qu and qv as mma A fragments in
// registers. A loop over 64-key tiles, skipping the tiles wholly at or
// past lengths[b], runs:
//   - the band: row r of warp w at key tile kt needs R rows
//     jb0 + 64 kt + 48 - 16 w + (15 - r + key), jb0 = T-1-t0-63, so each
//     warp multiplies its qv rows by an 80-row window of R
//     (16 x 80 x dh) and the tile's bd is that product read at column
//     key + 15 - r: the skew, done with warp shuffles inside each row's
//     four lanes (each lane sends the element its reader needs);
//   - qu . K^T (64 x 64 x dh), bd added, scaled, masked;
//   - the online softmax in registers (running max and sum per row) and
//     bf16(p~) . V (64 x dh x 64) into a float32 accumulator that is
//     rescaled by exp(m_old - m_new).
// K and V (two stages) and the R rows (a ring of three 64-row chunks: the
// windows of tile kt lie in chunks kt and kt + 1) reach shared memory by
// cp.async, one commit group a tile: the next tile's copies run under
// this tile's products. Rows past the tensor (keys or queries at or past
// T, R rows outside [0, 2T-1)) arrive as zeros (src-size 0), and so do
// the columns dh..DK-1 that pad the head width to a multiple of 16
// (zeroed once). q, k and v are read through their strides (the
// [T, B, 3D] qkv product's permuted views need no copy). Products:
// mma.sync m16n8k16 bf16 with float32 sums, B fragments by ldmatrix (V
// transposed), p~ handed from the score accumulators to the A operand in
// registers. Shared memory does not grow with T: 65 KB a block at
// dh <= 64, three blocks an SM. (A first version kept each warp's band in
// a float32 ring in shared memory and read it skewed: at 109 KB a block
// two fit an SM, and it was slower.) What holds it back now
// (`scripts/torch_flash_probe.py`: clock64 counts of the phases, and a
// build without the loop's copies): the L2 traffic of the tiles (each of
// a head's query tiles reads all its K and V) and the first tile's wait.
// Not wgmma: its shared-memory operand descriptors and a warpgroup-wide
// 64-row product are a redesign of their own, left for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 64;            // queries a block
constexpr int kBK = 64;            // keys a tile, R rows a chunk
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ bf16 rnd(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, float32 sums
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One asynchronous copy of vec bf16 values (vec = 8, 4 or 2: 16, 8 or 4
// bytes); ok = false fills the destination with zeros and reads nothing.
// vec = 1 (a stride or pointer off 4 bytes) copies synchronously.
__device__ __forceinline__ void copy_async(bf16* dst, const bf16* src,
                                           bool ok, int vec) {
  const uint32_t d = smem_addr(dst);
  switch (vec) {
    case 8:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                   "l"(src), "r"(ok ? 16 : 0));
      break;
    case 4:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                   "l"(src), "r"(ok ? 8 : 0));
      break;
    case 2:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                   "l"(src), "r"(ok ? 4 : 0));
      break;
    default:
      *dst = ok ? *src : rnd(0.f);
  }
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared memory of a block at head width DK (dh padded to 16): two
// stages of K and V [64][DK + 8] bf16; a ring of three 64-row R chunks
// [64][DK + 8] bf16 (the query tile is staged in the third before R
// chunk 2 arrives); u and vb [2][DK] float32.
template <int DK>
struct Smem {
  static constexpr int ld = DK + 8;                   // bf16 a row
  static constexpr int tile = kBK * ld;               // bf16 a 64-row tile
  static constexpr size_t bytes =
      (size_t)7 * tile * sizeof(bf16) + (size_t)2 * DK * sizeof(float);
};

// Copies rows [r0, r0 + 64) of a [rows_valid, dh] matrix at src (row
// stride `stride` elements, unit column stride) into a [64][ld] tile;
// rows outside [0, rows_valid) become zeros.
template <int DK>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int r0,
                                          int rows_valid, int dh, int vec) {
  constexpr int per = DK / 8;   // 16-byte copies a row of DK
  if (vec == 8 && kThreads % per == 0) {
    // the common case: each thread copies one column chunk of rows
    // r, r + step, ...; its source advances by step rows
    constexpr int step = kThreads / per;
    const int r = threadIdx.x / per, c = (threadIdx.x % per) * 8;
    if (c >= dh) return;
    const bf16* s = src + (long long)(r0 + r) * stride + c;
    bf16* d = dst + r * Smem<DK>::ld + c;
#pragma unroll
    for (int i = 0; i < kBK / step; ++i) {
      const int row = r0 + r + i * step;
      const bool ok = row >= 0 && row < rows_valid;
      copy_async(d + i * step * Smem<DK>::ld,
                 ok ? s + i * step * stride : src, ok, 8);
    }
    return;
  }
  const int per_row = dh / vec;
  for (int i = threadIdx.x; i < kBK * per_row; i += kThreads) {
    const int r = i / per_row, c = (i % per_row) * vec;
    const int row = r0 + r;
    const bool ok = row >= 0 && row < rows_valid;
    copy_async(dst + r * Smem<DK>::ld + c,
               ok ? src + (long long)row * stride + c : src, ok, vec);
  }
}

template <int DK>
__global__ void __launch_bounds__(kThreads, DK <= 64 ? 3 : 1)
flash_mhsa_rel_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ R,
                      const float* __restrict__ u,
                      const float* __restrict__ vb,
                      const int* __restrict__ lengths, void* __restrict__ out,
                      int B, int H, int T, int dh, long long sq_b,
                      long long sq_h, long long sq_t, long long sk_b,
                      long long sk_h, long long sk_t, long long sv_b,
                      long long sv_h, long long sv_t, float scale,
                      int out_f32, int vec) {
  using S = Smem<DK>;
  constexpr int LD = S::ld;
  constexpr int KS = DK / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* kv_s = reinterpret_cast<bf16*>(smem);   // 2 x (K, V) [64][LD]
  bf16* r_ring = kv_s + 4 * S::tile;            // 3 x R chunk [64][LD]
  float* uv_s = reinterpret_cast<float*>(r_ring + 3 * S::tile);  // [2][DK]

  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c4 = lane & 3;
  const int D = H * dh;

  const int len = lengths[b];
  const bool uniform = len <= 0;       // no valid key: average v over T
  const int Tk = uniform ? T : min(len, T);
  const int nk = (Tk + kBK - 1) / kBK;       // key tiles that hold a key
  const int jb0 = (T - 1) - t0 - (kBQ - 1);  // R row of chunk 0's row 0
  const int n_r = 2 * T - 1;

  const bf16* kb = k + b * sk_b + h * sk_h;
  const bf16* vbh = v + b * sv_b + h * sv_h;
  const bf16* Rh = R + (long long)h * dh;
  auto k_s = [&](int m) { return kv_s + (2 * (m & 1)) * S::tile; };
  auto v_s = [&](int m) { return kv_s + (2 * (m & 1) + 1) * S::tile; };
  auto r_s = [&](int m) { return r_ring + (m % 3) * S::tile; };
  // group m: K and V of key tile m, R chunk m + 1
  auto issue = [&](int m) {
    load_tile<DK>(k_s(m), kb, sk_t, m * kBK, T, dh, vec);
    load_tile<DK>(v_s(m), vbh, sv_t, m * kBK, T, dh, vec);
    load_tile<DK>(r_s(m + 1), Rh, D, jb0 + (m + 1) * kBK, n_r, dh, vec);
  };

  // zero what the copies leave alone (columns dh..DK-1)
  if (dh < DK) {
    uint4* z = reinterpret_cast<uint4*>(kv_s);
    for (int i = threadIdx.x; i < 7 * S::tile / 8; i += kThreads)
      z[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }
  // prologue copies, first: the query tile (into R slot 2) and R chunk 0,
  // then group 0; group 1 once the query tile is in registers
  load_tile<DK>(r_s(2), q + b * sq_b + h * sq_h, sq_t, t0, T, dh, vec);
  load_tile<DK>(r_s(0), Rh, D, jb0, n_r, dh, vec);
  commit();
  issue(0);
  commit();
  // bf16(u), bf16(vb) while the copies fly
  for (int i = threadIdx.x; i < 2 * DK; i += kThreads) {
    const int c = i % DK;
    const float* src = i < DK ? u : vb;
    uv_s[i] = c < dh ? f32(rnd(src[h * dh + c])) : 0.f;
  }

  // per-thread ldmatrix row / column offsets (elements)
  const int a_row = 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int a_col = 8 * (lane >> 4);
  const int b_row = (lane & 7) + 8 * (lane >> 4);     // K / R: key rows
  const int b_col = 8 * ((lane >> 3) & 1);
  const int v_row = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int v_col = 8 * (lane >> 4);

  wait_group<1>();
  __syncthreads();
  // qu = bf16(q + u), qv = bf16(q + vb) as A fragments: registers a0..a3
  // hold columns 16 ks + 2 c4 (+1) (a0, a1) and + 8 (a2, a3)
  uint32_t qu_f[KS][4], qv_f[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, smem_addr(r_s(2) + a_row * LD + 16 * ks + a_col));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = 16 * ks + 2 * c4 + 8 * (i >> 1);
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&a[i]));
      __nv_bfloat162 pu = __floats2bfloat162_rn(x.x + uv_s[c],
                                                x.y + uv_s[c + 1]);
      __nv_bfloat162 pv = __floats2bfloat162_rn(x.x + uv_s[DK + c],
                                                x.y + uv_s[DK + c + 1]);
      qu_f[ks][i] = *reinterpret_cast<uint32_t*>(&pu);
      qv_f[ks][i] = *reinterpret_cast<uint32_t*>(&pv);
    }
  }
  __syncthreads();              // every warp has its query rows
  if (nk > 1) issue(1);
  commit();

  float o[DK / 8][4];
#pragma unroll
  for (int j = 0; j < DK / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const float sl2 = scale * kLog2e;

  // The skew. Warp w's band for key tile kt is qv . R rows
  // jb0 + 64 kt + 48 - 16 w + [0, 80): x[n][.] holds its columns 8 n ..
  // 8 n + 7. Row r (0..15 in the warp) reads column key + 15 - r of it.
  // Output (row g or g + 8, key 8 j + 2 c4 + e) comes from lane
  // 4 g + src_c4 of the same row group, element src_e of n-tile
  // j + (y >> 3), y = 2 c4 + e + d, d = 15 - g (row g) or 7 - g (row g + 8).
  // A lane sends what its reader needs: the reader's y, from the inverse
  // of c4 -> src_c4, picks the n-tile.
  int src_lane[2][2], send_hi[2][2], send_e[2][2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = (hi ? 7 : 15) - g;
      const int y = 2 * c4 + e + d;                 // as a reader
      src_lane[hi][e] = 4 * g + ((y & 7) >> 1);
      const int se = (e + d) & 1;                   // element read
      // as a sender: the reader rc4 with ((2 rc4 + e + d) & 7) >> 1 == c4
      const int rc4 = ((2 * c4 + se - e - d) & 7) >> 1;
      const int ry = 2 * rc4 + e + d;
      send_hi[hi][e] = (ry >> 3) - (hi ? 0 : 1);    // n-tile j + base + 0/1
      send_e[hi][e] = se;
    }

  for (int kt = 0; kt < nk; ++kt) {
    wait_group<1>();            // group kt; group kt + 1 may be in flight
    __syncthreads();
    // the band: 80 R rows from chunks kt and kt + 1 of the ring
    float x[10][4];
#pragma unroll
    for (int n = 0; n < 10; ++n) x[n][0] = x[n][1] = x[n][2] = x[n][3] = 0.f;
    const int rho0 = 64 * kt + 48 - 16 * warp;
#pragma unroll
    for (int jp = 0; jp < 5; ++jp) {
      const int rho = rho0 + 16 * jp + b_row;
      const bf16* rrow = r_s(rho >> 6) + (rho & 63) * LD + b_col;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t bb[4];
        ldsm_x4(bb, smem_addr(rrow + 16 * ks));
        mma16816(x[2 * jp], qv_f[ks], bb[0], bb[1]);
        mma16816(x[2 * jp + 1], qv_f[ks], bb[2], bb[3]);
      }
    }
    // qu . K^T
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const bf16* kt_s = k_s(kt);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bb[4];
        ldsm_x4(bb, smem_addr(kt_s + (16 * jp + b_row) * LD + 16 * ks +
                              b_col));
        mma16816(s[2 * jp], qu_f[ks], bb[0], bb[1]);
        mma16816(s[2 * jp + 1], qu_f[ks], bb[2], bb[3]);
      }
    // + bd by the skew, scale (in log2 units), mask; row maxima
    const bool edge = uniform || (kt + 1) * kBK > Tk;   // a key to mask
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int base = hi ? j : j + 1;
          const int n0 = base, n1 = base + 1;
          const int ri = 2 * hi;
          const float lo0 = send_e[hi][e] ? x[n0][ri + 1] : x[n0][ri];
          const float lo1 = send_e[hi][e] ? x[n1][ri + 1] : x[n1][ri];
          const float sent = send_hi[hi][e] ? lo1 : lo0;
          const float bd = __shfl_sync(~0u, sent, src_lane[hi][e]);
          const int key = 8 * j + 2 * c4 + e;
          float xv = (s[j][ri + e] + bd) * sl2;
          if (edge) {
            if (uniform) xv = 0.f;
            if (kt * kBK + key >= Tk) xv = -INFINITY;
          }
          s[j][ri + e] = xv;
          mx[hi] = fmaxf(mx[hi], xv);
        }
    float corr[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(~0u, mx[hi], 1));
      mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(~0u, mx[hi], 2));
      const float m_new = fmaxf(m_run[hi], mx[hi]);
      corr[hi] = exp2f(m_run[hi] - m_new);
      m_run[hi] = m_new;
      l_run[hi] *= corr[hi];
    }
    // p~ = exp2(x - m), summed in float32, rounded to bf16 as A fragments
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = exp2f(s[j][0] - m_run[0]);
      const float p1 = exp2f(s[j][1] - m_run[0]);
      const float p2 = exp2f(s[j][2] - m_run[1]);
      const float p3 = exp2f(s[j][3] - m_run[1]);
      l_run[0] += p0 + p1;
      l_run[1] += p2 + p3;
      __nv_bfloat162 lo = __floats2bfloat162_rn(p0, p1);
      __nv_bfloat162 hi = __floats2bfloat162_rn(p2, p3);
      pa[j >> 1][2 * (j & 1)] = *reinterpret_cast<uint32_t*>(&lo);
      pa[j >> 1][2 * (j & 1) + 1] = *reinterpret_cast<uint32_t*>(&hi);
    }
#pragma unroll
    for (int j = 0; j < DK / 8; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }
    const bf16* vt = v_s(kt);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int dp = 0; dp < DK / 16; ++dp) {
        uint32_t bb[4];
        ldsm_x4_t(bb, smem_addr(vt + (16 * ks + v_row) * LD + 16 * dp +
                                v_col));
        mma16816(o[2 * dp], pa[ks], bb[0], bb[1]);
        mma16816(o[2 * dp + 1], pa[ks], bb[2], bb[3]);
      }
    __syncthreads();              // every warp is done with K, V of kt and
                                  // with R chunk kt
    if (kt + 2 < nk) issue(kt + 2);
    commit();
  }

  // out = o / l, rows t < T, columns d < dh; out is [T, B, H, dh]
  const int r_loc[2] = {16 * warp + g, 16 * warp + g + 8};
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    l_run[hi] += __shfl_xor_sync(~0u, l_run[hi], 1);
    l_run[hi] += __shfl_xor_sync(~0u, l_run[hi], 2);
    const float inv = 1.f / l_run[hi];
    const int t = t0 + r_loc[hi];
    if (t >= T) continue;
    const long long row = (((long long)t * B + b) * H + h) * dh;
#pragma unroll
    for (int j = 0; j < DK / 8; ++j) {
      const int d = 8 * j + 2 * c4;
      const float x0 = o[j][2 * hi] * inv, x1 = o[j][2 * hi + 1] * inv;
      if (out_f32) {
        float* dst = static_cast<float*>(out) + row + d;
        if (d < dh) dst[0] = x0;
        if (d + 1 < dh) dst[1] = x1;
      } else {
        bf16* dst = static_cast<bf16*>(out) + row + d;
        if (d < dh) dst[0] = rnd(x0);
        if (d + 1 < dh) dst[1] = rnd(x1);
      }
    }
  }
}

struct Strides {
  long long q_b, q_h, q_t, k_b, k_h, k_t, v_b, v_h, v_t;
};

template <int DK>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* R,
           const float* u, const float* vb, const int* lengths, void* out,
           int B, int H, int T, int dh, const Strides& st, float scale,
           int out_f32, int vec, cudaStream_t stream) {
  const size_t smem = Smem<DK>::bytes;
  // the shared-memory opt-in, once a device
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !opted[dev]) {
    err = cudaFuncSetAttribute(flash_mhsa_rel_kernel<DK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) opted[dev] = true;
  }
  const dim3 grid((T + kBQ - 1) / kBQ, H, B);
  flash_mhsa_rel_kernel<DK><<<grid, kThreads, smem, stream>>>(
      q, k, v, R, u, vb, lengths, out, B, H, T, dh, st.q_b, st.q_h, st.q_t,
      st.k_b, st.k_h, st.k_t, st.v_b, st.v_h, st.v_t, scale, out_f32, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: [B, H, T, dh] bf16 with element strides (q_b, q_h, q_t),
// (k_b, k_h, k_t), (v_b, v_h, v_t) over b, h, t and unit stride over dh;
// R: [2T-1, H*dh] bf16, contiguous; u, vb: [H, dh] float32, contiguous;
// lengths: [B] int32; out: [T, B, H, dh] float32 (out_f32) or bf16,
// contiguous. vec (8, 4, 2 or 1) divides dh, every stride and every
// pointer's offset in elements: the width of each asynchronous copy.
// 1 <= dh <= 128.
extern "C" int flash_mhsa_rel_launch(
    const bf16* q, const bf16* k, const bf16* v, const bf16* R,
    const float* u, const float* vb, const int* lengths, void* out, int B,
    int H, int T, int dh, long long q_b, long long q_h, long long q_t,
    long long k_b, long long k_h, long long k_t, long long v_b,
    long long v_h, long long v_t, float scale, int out_f32, int vec,
    cudaStream_t stream) {
  if (T < 1 || dh < 1 || dh > 128 || dh % vec ||
      (vec != 1 && vec != 2 && vec != 4 && vec != 8))
    return (int)cudaErrorInvalidValue;
  const Strides st{q_b, q_h, q_t, k_b, k_h, k_t, v_b, v_h, v_t};
  if (dh <= 32)
    return launch<32>(q, k, v, R, u, vb, lengths, out, B, H, T, dh, st,
                      scale, out_f32, vec, stream);
  if (dh <= 48)
    return launch<48>(q, k, v, R, u, vb, lengths, out, B, H, T, dh, st,
                      scale, out_f32, vec, stream);
  if (dh <= 64)
    return launch<64>(q, k, v, R, u, vb, lengths, out, B, H, T, dh, st,
                      scale, out_f32, vec, stream);
  return launch<128>(q, k, v, R, u, vb, lengths, out, B, H, T, dh, st,
                     scale, out_f32, vec, stream);
}
