// Rel-pos multi-head self-attention, forward, with the sinusoid position
// bias factorized by angle addition (no rel-shift, no O(T^2) tensor in
// device memory).
//
// Replaces gasr_tpu/ops/pallas/flash_mhsa.py::flash_mhsa_rel (`_kernel`).
// Per (batch b, head h) and query t:
//   qu = bf16(q + u), qv = bf16(q + vb)
//   us = bf16(qv . ws_h), uc = bf16(qv . wc_h)                  [D/2]
//   A  = bf16(bf16(us sin(wt)) + bf16(uc cos(wt)))
//   Bm = bf16(bf16(uc sin(wt)) - bf16(us cos(wt)))
//   score(t, s) = (qu . k_s + A . cos(ws) + Bm . sin(ws)) / sqrt(dh)
//   keys s >= lengths[b] get -1e30; p = softmax over the T keys (float32),
//   rounded to bf16; out(t) = p . v                  (bf16 or float32)
// Every product is a bf16 product summed in float32 (the rounding points
// of gasr_tpu's flash_ref). The wrapper (ops/cuda/flash_mhsa.py) pads T
// to Tp and dh, D/2 to dhp, halfp (multiples of 16) with zeros and builds
// the per-head ws/wc and the cos/sin tables [Tp, halfp].
//
// Bound on the card: operations. At conformer_l (B=64, H=8, T=300, dh=64,
// D=512) one call is ~69 GFLOP of bf16 products, 0.07 ms at 989 TFLOP/s;
// q, k, v and the output are ~20 MB, 0.006 ms at 3.35 TB/s. The position
// term (A, Bm against the tables, depth D = 512 per query-key pair) is
// 70% of the products.
// Design (simple and right first): one 256-thread block per (b, h, tile
// of BQ = 64, 32 or 16 queries, the largest whose shared memory fits).
// WMMA bf16 tensor-core products (16x16x16 fragments, float32
// accumulators). The block keeps q+u and q+vb, then A and Bm, in shared
// memory; each warp takes 16-key columns and sums the whole score depth
// (dh from k, D/2 + D/2 from the tables) for all BQ queries, reading k
// and the tables straight from L2; the full [BQ, T] float32 score rows
// stay in shared memory for an exact two-pass softmax (max and sum, then
// the normalized bf16 attention, as flash_ref rounds it); P @ V follows.
// Nothing of size T^2 leaves the SM.
// Redesign for later: wgmma with the key tiles and tables staged by TMA
// and an online softmax, so that no block holds whole score rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr float kNeg = -1e30f;
constexpr size_t kSmemLimit = 232448;   // bytes a block may use (H100)

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    FragBRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
    FragBCol;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__device__ __forceinline__ float f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ bf16 rnd(float x) { return __float2bfloat16(x); }
// x rounded to bf16 and back
__device__ __forceinline__ float r16(float x) { return f32(rnd(x)); }

// Shared memory layout of a block of BQ queries: q+u and q+vb; A and B,
// later the bf16 attention; the float32 scores, earlier and later the
// per-warp staging.
struct Layout {
  int qs_ld, ab_ld, p_ld, s_ld;
  size_t qs_bytes, ab_bytes, s_bytes;
  __host__ __device__ Layout(int bq, int Tp, int dhp, int halfp) {
    qs_ld = dhp + 8;
    ab_ld = halfp + 8;
    p_ld = Tp + 8;
    s_ld = Tp + 4;
    qs_bytes = (size_t)2 * bq * qs_ld * sizeof(bf16);
    const size_t ab = (size_t)2 * bq * ab_ld * sizeof(bf16);
    const size_t p = (size_t)bq * p_ld * sizeof(bf16);
    ab_bytes = ab > p ? ab : p;
    const size_t s = (size_t)bq * s_ld * sizeof(float);
    const size_t stage = (size_t)kWarps * 2 * 256 * sizeof(float);
    s_bytes = s > stage ? s : stage;
  }
  __host__ __device__ size_t total() const {
    return qs_bytes + ab_bytes + s_bytes;
  }
};

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

template <int BQ>
__global__ void __launch_bounds__(kThreads)
flash_mhsa_rel_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ ws,
                      const bf16* __restrict__ wc, const bf16* __restrict__ cs,
                      const bf16* __restrict__ sn, const bf16* __restrict__ u,
                      const bf16* __restrict__ vb,
                      const int* __restrict__ lengths, int H, int T, int dh,
                      int Tp, int dhp, int halfp, float scale, int out_f32,
                      void* __restrict__ out) {
  constexpr int RT = BQ / 16;          // 16-row query tiles per block
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(BQ, Tp, dhp, halfp);
  bf16* qu_s = reinterpret_cast<bf16*>(smem);              // [BQ][qs_ld]
  bf16* qv_s = qu_s + BQ * L.qs_ld;
  bf16* a_s = reinterpret_cast<bf16*>(smem + L.qs_bytes);  // [BQ][ab_ld]
  bf16* b_s = a_s + BQ * L.ab_ld;
  bf16* p_s = a_s;            // [BQ][p_ld] bf16 attention, after the scores
  float* s_s = reinterpret_cast<float*>(smem + L.qs_bytes + L.ab_bytes);
  // s_s holds [BQ][s_ld] scores; before them, and after the softmax, each
  // warp's 2 x 16 x 16 float staging

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t bh = (size_t)b * H + h;
  const bf16* qb = q + bh * Tp * dhp;
  const bf16* kb = k + bh * Tp * dhp;
  const bf16* vbh = v + bh * Tp * dhp;
  float* stage = s_s + warp * 512;

  // 1. q + u and q + vb (rows past Tp are zero queries, never written)
  for (int i = threadIdx.x; i < BQ * dhp; i += kThreads) {
    const int r = i / dhp, c = i % dhp;
    const float x = q0 + r < Tp ? f32(qb[(size_t)(q0 + r) * dhp + c]) : 0.f;
    qu_s[r * L.qs_ld + c] = rnd(x + f32(u[h * dhp + c]));
    qv_s[r * L.qs_ld + c] = rnd(x + f32(vb[h * dhp + c]));
  }
  __syncthreads();

  // 2. us, uc by 16 x 16 tiles, then A and Bm elementwise
  const int ntf = halfp / 16;
  const bf16* wsh = ws + (size_t)h * dhp * halfp;
  const bf16* wch = wc + (size_t)h * dhp * halfp;
  for (int tile = warp; tile < RT * ntf; tile += kWarps) {
    const int rt = tile / ntf, ft = tile % ntf;
    FragC cu, cc;
    wmma::fill_fragment(cu, 0.f);
    wmma::fill_fragment(cc, 0.f);
    for (int kk = 0; kk < dhp; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, qv_s + rt * 16 * L.qs_ld + kk, L.qs_ld);
      FragBRow bs, bc;
      wmma::load_matrix_sync(bs, wsh + (size_t)kk * halfp + ft * 16, halfp);
      wmma::load_matrix_sync(bc, wch + (size_t)kk * halfp + ft * 16, halfp);
      wmma::mma_sync(cu, a, bs, cu);
      wmma::mma_sync(cc, a, bc, cc);
    }
    wmma::store_matrix_sync(stage, cu, 16, wmma::mem_row_major);
    wmma::store_matrix_sync(stage + 256, cc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e / 16, fi = ft * 16 + e % 16;
      const int t = q0 + rt * 16 + r;
      const float s = t < Tp ? f32(sn[(size_t)t * halfp + fi]) : 0.f;
      const float c = t < Tp ? f32(cs[(size_t)t * halfp + fi]) : 0.f;
      const float us = r16(stage[e]), uc = r16(stage[256 + e]);
      const int o = (rt * 16 + r) * L.ab_ld + fi;
      a_s[o] = rnd(r16(us * s) + r16(uc * c));
      b_s[o] = rnd(r16(uc * s) - r16(us * c));
    }
    __syncwarp();
  }
  __syncthreads();

  // 3. scores: each warp a 16-key column for all BQ queries, depth dh
  //    (qu . k) then D/2 + D/2 (A . cos, Bm . sin)
  for (int kt = warp; kt < Tp / 16; kt += kWarps) {
    FragC acc[RT];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) wmma::fill_fragment(acc[rt], 0.f);
    for (int kk = 0; kk < dhp; kk += 16) {
      FragBCol bk;
      wmma::load_matrix_sync(bk, kb + (size_t)kt * 16 * dhp + kk, dhp);
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) {
        FragA a;
        wmma::load_matrix_sync(a, qu_s + rt * 16 * L.qs_ld + kk, L.qs_ld);
        wmma::mma_sync(acc[rt], a, bk, acc[rt]);
      }
    }
    for (int ff = 0; ff < halfp; ff += 16) {
      FragBCol bc, bs;
      wmma::load_matrix_sync(bc, cs + (size_t)kt * 16 * halfp + ff, halfp);
      wmma::load_matrix_sync(bs, sn + (size_t)kt * 16 * halfp + ff, halfp);
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) {
        FragA a;
        wmma::load_matrix_sync(a, a_s + rt * 16 * L.ab_ld + ff, L.ab_ld);
        wmma::mma_sync(acc[rt], a, bc, acc[rt]);
        wmma::load_matrix_sync(a, b_s + rt * 16 * L.ab_ld + ff, L.ab_ld);
        wmma::mma_sync(acc[rt], a, bs, acc[rt]);
      }
    }
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
      wmma::store_matrix_sync(s_s + rt * 16 * L.s_ld + kt * 16, acc[rt],
                              L.s_ld, wmma::mem_row_major);
  }
  __syncthreads();

  // 4. softmax over the T real keys, one row per warp at a time; padded
  //    keys (T <= s < Tp) get probability 0
  const int len = lengths[b];
  for (int r = warp; r < BQ; r += kWarps) {
    float* row = s_s + r * L.s_ld;
    float m = -INFINITY;
    for (int s = lane; s < T; s += 32) {
      const float x = s < len ? row[s] * scale : kNeg;
      row[s] = x;
      m = fmaxf(m, x);
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int s = lane; s < T; s += 32) {
      const float e = expf(row[s] - m);
      row[s] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    bf16* prow = p_s + r * L.p_ld;
    for (int s = lane; s < Tp; s += 32)
      prow[s] = s < T ? rnd(row[s] / sum) : rnd(0.f);
  }
  __syncthreads();

  // 5. out = P . V by 16 x 16 tiles
  const int ntd = dhp / 16;
  for (int tile = warp; tile < RT * ntd; tile += kWarps) {
    const int rt = tile / ntd, dt = tile % ntd;
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    for (int ks = 0; ks < Tp; ks += 16) {
      FragA a;
      wmma::load_matrix_sync(a, p_s + rt * 16 * L.p_ld + ks, L.p_ld);
      FragBRow bv;
      wmma::load_matrix_sync(bv, vbh + (size_t)ks * dhp + dt * 16, dhp);
      wmma::mma_sync(acc, a, bv, acc);
    }
    wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int t = q0 + rt * 16 + e / 16, d = dt * 16 + e % 16;
      if (t < T && d < dh) {
        const size_t o = (bh * T + t) * dh + d;
        if (out_f32)
          static_cast<float*>(out)[o] = stage[e];
        else
          static_cast<bf16*>(out)[o] = rnd(stage[e]);
      }
    }
    __syncwarp();
  }
}

template <int BQ>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* ws,
           const bf16* wc, const bf16* cs, const bf16* sn, const bf16* u,
           const bf16* vb, const int* lengths, int B, int H, int T, int dh,
           int Tp, int dhp, int halfp, float scale, int out_f32, void* out,
           cudaStream_t stream) {
  const size_t smem = Layout(BQ, Tp, dhp, halfp).total();
  cudaError_t err = cudaFuncSetAttribute(
      flash_mhsa_rel_kernel<BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tp + BQ - 1) / BQ, H, B);
  flash_mhsa_rel_kernel<BQ><<<grid, kThreads, smem, stream>>>(
      q, k, v, ws, wc, cs, sn, u, vb, lengths, H, T, dh, Tp, dhp, halfp,
      scale, out_f32, out);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: [B, H, Tp, dhp] bf16; ws, wc: [H, dhp, halfp] bf16; cs, sn:
// [Tp, halfp] bf16; u, vb: [H, dhp] bf16; lengths: [B] int32; out:
// [B, H, T, dh] float32 (out_f32) or bf16. Tp, dhp, halfp multiples of 16;
// every pointer 32-byte aligned. The query tile is the largest of 64, 32
// and 16 rows whose shared memory fits a block; with none, the launch is
// refused.
extern "C" int flash_mhsa_rel_launch(
    const bf16* q, const bf16* k, const bf16* v, const bf16* ws,
    const bf16* wc, const bf16* cs, const bf16* sn, const bf16* u,
    const bf16* vb, const int* lengths, int B, int H, int T, int dh, int Tp,
    int dhp, int halfp, float scale, int out_f32, void* out,
    cudaStream_t stream) {
  if (Tp % 16 || dhp % 16 || halfp % 16 || T > Tp || dh > dhp)
    return (int)cudaErrorInvalidValue;
  int bq = 64;
  while (bq >= 16 && Layout(bq, Tp, dhp, halfp).total() > kSmemLimit) bq /= 2;
  switch (bq) {
    case 64:
      return launch<64>(q, k, v, ws, wc, cs, sn, u, vb, lengths, B, H, T, dh,
                        Tp, dhp, halfp, scale, out_f32, out, stream);
    case 32:
      return launch<32>(q, k, v, ws, wc, cs, sn, u, vb, lengths, B, H, T, dh,
                        Tp, dhp, halfp, scale, out_f32, out, stream);
    case 16:
      return launch<16>(q, k, v, ws, wc, cs, sn, u, vb, lengths, B, H, T, dh,
                        Tp, dhp, halfp, scale, out_f32, out, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
