// Fused conformer stem: conv2 (3x3, stride 2, d -> d) + bias + clip [0, 20]
// -> bf16 -> freq-major sub_proj + bias, over conv1's output h1.
//
// Replaces gasr_tpu/ops/pallas/stem.py::fused_stem (`_kernel`):
//   out[b, t2, :] = bp + sum_f2 bf16(clip(b2 + sum_{di,dj,c}
//                   h1[b, 2t2+di, 2f2+dj, c] w2[di, dj, c, :], 0, 20)) wp[f2]
// h1 [B, T1, F1, d] bf16 (T1 = T/2, F1 = F/2, both even); taps at
// 2t2+di = T1 or 2f2+dj = F1 are lax "SAME" high padding and read zero.
// w2 [9, d, d] bf16 (tap 3 di + dj, c_in, c_out), b2 [d] float32, wp
// [F2 d, dout] bf16 (row f2 d + c), bp [dout] float32 (already rounded to
// bf16 by the wrapper, as stem_ref's linear rounds it). bf16 products,
// float32 sums; conv2's output is rounded to bf16 after the clip and never
// leaves the SM.
//
// Bound on the card: operations. At conformer_l (B=64, T=1200, F=80,
// d=dout=512) conv2 is 384,000 outputs x 512 x 4608 x 2 = 1.81 TFLOP and
// sub_proj 0.20 TFLOP: ~2.03 ms at 989 TFLOP/s. Reading h1 (1.57 GB) takes
// 0.47 ms at 3.35 TB/s.
// Design (simple and right first): one 256-thread block per (b, 16 rows of
// t2). It walks f2 in groups of 4: for each group, conv2 is an implicit
// GEMM of M = 64 rows (16 t2 x 4 f2), K = 9 d (tap by tap, read from h1
// at stride 2 with the padding taps as zeros), N = d in passes of 128
// channels, with WMMA bf16 tensor-core products (16x16x16 fragments,
// float32 accumulators; 8 warps of 32 x 32) and 32-deep K slices
// through two shared-memory buffers, the next slice held in registers
// while the warps multiply the current one. Each pass's epilogue adds b2,
// clips and rounds into a [64, d] bf16 tile in shared memory; then each
// warp accumulates its dout/8 columns of tile[f2] @ wp[f2] for the
// group's f2 into float32 fragments that live in registers across all
// groups. w2 (4.7 MB) and wp (10.5 MB) stream from L2: each block rereads
// w2 once per group of f2, the price of the small M.
// Redesign for later: wgmma with TMA-staged weights and a larger M per
// block (or a cluster sharing w2 slices), so each weight byte feeds more
// rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;      // 8 warps
constexpr int TT = 16;             // t2 rows per block
constexpr int FG = 4;              // f2 per group
constexpr int BM = TT * FG;        // conv2 GEMM rows per group
constexpr int NC = 128;            // conv2 output channels per pass
constexpr int BK = 32;             // K slice
constexpr int A_LD = BK + 8;
constexpr int B_LD = NC + 8;
constexpr int C_LD = NC + 4;
constexpr int A_TILE = BM * A_LD;  // bf16 elements per buffer
constexpr int B_TILE = BK * B_LD;
constexpr int B_VEC = BK * NC / 8 / kThreads;   // 16-byte chunks per thread
constexpr size_t kLoopBytes = 2 * (A_TILE + B_TILE) * sizeof(bf16);
constexpr size_t kEpiBytes = BM * C_LD * sizeof(float);
constexpr size_t kRegion0 = kLoopBytes > kEpiBytes ? kLoopBytes : kEpiBytes;
static_assert(BM * BK / 8 == kThreads, "one A chunk per thread");

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

size_t smem_bytes(int d) {
  return kRegion0 + (size_t)BM * (d + 8) * sizeof(bf16);
}

struct Slice {
  uint4 a;
  uint4 b[B_VEC];
};

// K slice s of a pass: tap s / (d / BK), channels c0 .. c0 + BK - 1
__device__ __forceinline__ void load_slice(Slice& sl, const bf16* h1,
                                           const bf16* w2, int b, int t0,
                                           int f0, int T1, int F1, int d,
                                           int n0, int s) {
  const int per_tap = d / BK;
  const int tap = s / per_tap, c0 = (s % per_tap) * BK;
  const int di = tap / 3, dj = tap % 3;
  const int T2 = T1 / 2, F2 = F1 / 2;
  {
    const int r = threadIdx.x / (BK / 8), cq = (threadIdx.x % (BK / 8)) * 8;
    const int t2 = t0 + r % TT, f2 = f0 + r / TT;
    const int ti = 2 * t2 + di, fi = 2 * f2 + dj;
    sl.a = (t2 < T2 && f2 < F2 && ti < T1 && fi < F1)
               ? *reinterpret_cast<const uint4*>(
                     h1 + (((size_t)b * T1 + ti) * F1 + fi) * d + c0 + cq)
               : make_uint4(0u, 0u, 0u, 0u);
  }
  for (int q = 0; q < B_VEC; ++q) {
    const int i = threadIdx.x + q * kThreads;
    const int r = i / (NC / 8), c = (i % (NC / 8)) * 8;
    sl.b[q] = *reinterpret_cast<const uint4*>(
        w2 + ((size_t)tap * d + c0 + r) * d + n0 + c);
  }
}

__device__ __forceinline__ void store_slice(const Slice& sl, bf16* As,
                                            bf16* Bs) {
  {
    const int r = threadIdx.x / (BK / 8), cq = (threadIdx.x % (BK / 8)) * 8;
    *reinterpret_cast<uint4*>(As + r * A_LD + cq) = sl.a;
  }
  for (int q = 0; q < B_VEC; ++q) {
    const int i = threadIdx.x + q * kThreads;
    const int r = i / (NC / 8), c = (i % (NC / 8)) * 8;
    *reinterpret_cast<uint4*>(Bs + r * B_LD + c) = sl.b[q];
  }
}

// NF: 16-column output fragments per warp (dout = 128 NF)
template <int NF>
__global__ void __launch_bounds__(kThreads)
fused_stem_kernel(const bf16* __restrict__ h1, const bf16* __restrict__ w2,
                  const float* __restrict__ b2, const bf16* __restrict__ wp,
                  const float* __restrict__ bp, int T1, int F1, int d,
                  int out_f32, void* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);        // [2][A_TILE]
  bf16* Bs = As + 2 * A_TILE;                      // [2][B_TILE]
  float* Cs = reinterpret_cast<float*>(smem);      // [BM][C_LD], epilogues
  bf16* Hs = reinterpret_cast<bf16*>(smem + kRegion0);   // [BM][d + 8]
  const int h_ld = d + 8;
  const int dout = 128 * NF;

  const int b = blockIdx.y, t0 = blockIdx.x * TT;
  const int T2 = T1 / 2, F2 = F1 / 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 4) * 32, wn = (warp % 4) * 32;   // conv2 warp tile
  const int col0 = warp * 16 * NF;                        // sub_proj columns
  const int nk = 9 * (d / BK);

  FragC oacc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(oacc[j], 0.f);

  for (int f0 = 0; f0 < F2; f0 += FG) {
    for (int n0 = 0; n0 < d; n0 += NC) {
      FragC acc[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
      Slice sl;
      load_slice(sl, h1, w2, b, t0, f0, T1, F1, d, n0, 0);
      store_slice(sl, As, Bs);
      __syncthreads();
      for (int ks = 0; ks < nk; ++ks) {
        const int cur = ks & 1;
        if (ks + 1 < nk)
          load_slice(sl, h1, w2, b, t0, f0, T1, F1, d, n0, ks + 1);
        const bf16* a_s = As + cur * A_TILE;
        const bf16* b_s = Bs + cur * B_TILE;
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          FragA a[2];
          FragB bw[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(a[i], a_s + (wm + 16 * i) * A_LD + kk,
                                   A_LD);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::load_matrix_sync(bw[j], b_s + kk * B_LD + wn + 16 * j,
                                   B_LD);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              wmma::mma_sync(acc[i][j], a[i], bw[j], acc[i][j]);
        }
        if (ks + 1 < nk)
          store_slice(sl, As + (cur ^ 1) * A_TILE, Bs + (cur ^ 1) * B_TILE);
        __syncthreads();
      }
      // epilogue of the pass: + b2, clip, bf16 into Hs (each warp its own
      // 32 x 32, through Cs, which overlays the now idle slice buffers)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::store_matrix_sync(Cs + (wm + 16 * i) * C_LD + wn + 16 * j,
                                  acc[i][j], C_LD, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 32 * 32; e += 32) {
        const int r = wm + e / 32, c = wn + e % 32;
        const float y = Cs[r * C_LD + c] + b2[n0 + c];
        Hs[r * h_ld + n0 + c] = __float2bfloat16(fminf(fmaxf(y, 0.f), 20.f));
      }
      __syncthreads();
    }
    // sub_proj for the group's f2: rows fg * 16 .. of Hs are f2 = f0 + fg
    for (int fg = 0; fg < FG && f0 + fg < F2; ++fg) {
      const bf16* wpf = wp + (size_t)(f0 + fg) * d * dout;
      for (int kk = 0; kk < d; kk += 16) {
        FragA a;
        wmma::load_matrix_sync(a, Hs + fg * 16 * h_ld + kk, h_ld);
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          FragB bw;
          wmma::load_matrix_sync(bw, wpf + (size_t)kk * dout + col0 + 16 * j,
                                 dout);
          wmma::mma_sync(oacc[j], a, bw, oacc[j]);
        }
      }
    }
    __syncthreads();
  }

  // + bp, rows t2 < T2, through each warp's 16 x 16 staging in Cs
  float* stage = Cs + warp * 256;
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    wmma::store_matrix_sync(stage, oacc[j], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int t2 = t0 + e / 16, n = col0 + 16 * j + e % 16;
      if (t2 < T2) {
        const float y = stage[e] + bp[n];
        const size_t o = ((size_t)b * T2 + t2) * dout + n;
        if (out_f32)
          static_cast<float*>(out)[o] = y;
        else
          static_cast<bf16*>(out)[o] = __float2bfloat16(y);
      }
    }
    __syncwarp();
  }
}

template <int NF>
int launch(const bf16* h1, const bf16* w2, const float* b2, const bf16* wp,
           const float* bp, int B, int T1, int F1, int d, int out_f32,
           void* out, cudaStream_t stream) {
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      fused_stem_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T1 / 2 + TT - 1) / TT, B);
  fused_stem_kernel<NF><<<grid, kThreads, smem, stream>>>(
      h1, w2, b2, wp, bp, T1, F1, d, out_f32, out);
  return (int)cudaGetLastError();
}

}  // namespace

// h1 [B, T1, F1, d] bf16, w2 [9, d, d] bf16, b2 [d] float32, wp
// [(F1/2) d, dout] bf16, bp [dout] float32; out [B, T1/2, dout] float32
// (out_f32) or bf16. T1, F1 even; d a multiple of 128 up to 1024; dout a
// multiple of 128 up to 1024; every pointer 16-byte aligned.
extern "C" int fused_stem_launch(const bf16* h1, const bf16* w2,
                                 const float* b2, const bf16* wp,
                                 const float* bp, int B, int T1, int F1,
                                 int d, int dout, int out_f32, void* out,
                                 cudaStream_t stream) {
  if (T1 % 2 || F1 % 2 || d % 128 || d > 1024 || dout % 128 || dout > 1024)
    return (int)cudaErrorInvalidValue;
  switch (dout / 128) {
#define GASR_STEM_CASE(nf) \
  case nf:                 \
    return launch<nf>(h1, w2, b2, wp, bp, B, T1, F1, d, out_f32, out, stream);
    GASR_STEM_CASE(1)
    GASR_STEM_CASE(2)
    GASR_STEM_CASE(3)
    GASR_STEM_CASE(4)
    GASR_STEM_CASE(5)
    GASR_STEM_CASE(6)
    GASR_STEM_CASE(7)
    GASR_STEM_CASE(8)
#undef GASR_STEM_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
