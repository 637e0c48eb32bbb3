// Elman recurrence: out[t] = tanh(xw[t] + bf16(h_{t-1}) @ W_hh_bf16),
// float32 accumulation, forward or reverse in time.
//
// Replaces gasr_tpu/ops/pallas/rnn_scan.py::rnn_scan_pallas_raw (`_kernel`)
// with its cast pattern: h rounded to bf16, W_hh held in bf16, products
// summed in float32, the float32 sum with xw through tanh.
//
// Bound on the card: operations. At T=200, B=256, H=2048 the recurrence
// is 2*T*B*H^2 = 0.43 TFLOP of bf16 products, 0.43 ms at the tensor cores'
// 989 TFLOP/s; its bytes (xw in, out out: 0.84 GB with W_hh's 8 MB) take
// 0.25 ms at 3.35 TB/s. The steps are serial: step t needs all of h_{t-1}.
// Design (simple and right first): one launch per time step of a fused
// GEMM + tanh kernel. Each 256-thread block computes a 64 x 64 tile of
// h_t with WMMA bf16 tensor-core products (16x16x16 fragments, float32
// accumulators; 8 warps of 16 x 32 each). It walks the reduction in
// 64-wide slices through two shared-memory buffers: while the warps
// multiply one slice, each thread already holds the next slice of h_{t-1}
// (rounded to bf16 on the way in) and W_hh in registers, loaded with
// 16-byte accesses. The epilogue adds xw[t] and applies tanh. Rows past B
// and columns past H are masked, so every B is taken; H must be a multiple
// of 8 (16-byte rows), which the wrapper ensures by zero padding. W_hh
// (8 MB) stays in the 50 MB L2 across steps but is re-read every step.
// Redesign for later: a persistent grid-synchronised kernel that keeps
// W_hh resident in the SMs' shared memory (8 MB over 132 SMs is ~62 KB
// each) and h in L2, with wgmma and TMA, removing the per-step launches.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64;          // batch rows per block
constexpr int BN = 64;          // hidden columns per block
constexpr int BK = 64;          // reduction slice per stage
constexpr int kThreads = 256;   // 8 warps, each 16 x 32
constexpr int A_LD = BK + 8;    // padded leading dims: multiples of 8 for
constexpr int B_LD = BN + 8;    // bf16 WMMA loads, of 4 for float stores,
constexpr int C_LD = BN + 4;    // and 16-byte aligned rows
constexpr int A_TILE = BM * A_LD;   // bf16 elements per buffer
constexpr int B_TILE = BK * B_LD;
constexpr int A_VEC = BM * BK / 4 / kThreads;   // float4 of h per thread
constexpr int B_VEC = BK * BN / 8 / kThreads;   // 8 x bf16 of W per thread
constexpr size_t kLoopBytes = 2 * (A_TILE + B_TILE) * sizeof(__nv_bfloat16);
constexpr size_t kEpiBytes = BM * C_LD * sizeof(float);
constexpr size_t kSmemBytes = kLoopBytes > kEpiBytes ? kLoopBytes : kEpiBytes;

struct Slice {
  float4 a[A_VEC];
  uint4 b[B_VEC];
};

__device__ __forceinline__ void load_slice(Slice& s, const float* h_prev,
                                           const __nv_bfloat16* w, int B,
                                           int H, int m0, int n0, int k0) {
  for (int q = 0; q < A_VEC; ++q) {
    const int i = threadIdx.x + q * kThreads;
    const int r = i / (BK / 4), c = (i % (BK / 4)) * 4;
    s.a[q] = (m0 + r < B && k0 + c < H)
                 ? *reinterpret_cast<const float4*>(
                       h_prev + (size_t)(m0 + r) * H + k0 + c)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int q = 0; q < B_VEC; ++q) {
    const int i = threadIdx.x + q * kThreads;
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    s.b[q] = (k0 + r < H && n0 + c < H)
                 ? *reinterpret_cast<const uint4*>(
                       w + (size_t)(k0 + r) * H + n0 + c)
                 : make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ void store_slice(const Slice& s,
                                            __nv_bfloat16* As,
                                            __nv_bfloat16* Bs) {
  for (int q = 0; q < A_VEC; ++q) {
    const int i = threadIdx.x + q * kThreads;
    const int r = i / (BK / 4), c = (i % (BK / 4)) * 4;
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(As + r * A_LD + c);
    dst[0] = __floats2bfloat162_rn(s.a[q].x, s.a[q].y);
    dst[1] = __floats2bfloat162_rn(s.a[q].z, s.a[q].w);
  }
  for (int q = 0; q < B_VEC; ++q) {
    const int i = threadIdx.x + q * kThreads;
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    *reinterpret_cast<uint4*>(Bs + r * B_LD + c) = s.b[q];
  }
}

__global__ void __launch_bounds__(kThreads)
rnn_step_kernel(const float* __restrict__ xw_t,
                const __nv_bfloat16* __restrict__ w,
                const float* __restrict__ h_prev, int B, int H,
                float* __restrict__ out_t) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);   // [2][A_TILE]
  __nv_bfloat16* Bs = As + 2 * A_TILE;                          // [2][B_TILE]
  float* Cs = reinterpret_cast<float*>(smem);   // epilogue, after the loop

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 16;
  const int wn = (warp % 2) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);

  Slice s;
  load_slice(s, h_prev, w, B, H, m0, n0, 0);
  store_slice(s, As, Bs);
  __syncthreads();
  const int nk = (H + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) load_slice(s, h_prev, w, B, H, m0, n0, (kt + 1) * BK);
    const __nv_bfloat16* a_s = As + cur * A_TILE;
    const __nv_bfloat16* b_s = Bs + cur * B_TILE;
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::load_matrix_sync(a, a_s + wm * A_LD + kk, A_LD);
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bf;
        wmma::load_matrix_sync(bf, b_s + kk * B_LD + wn + 16 * j, B_LD);
        wmma::mma_sync(acc[j], a, bf, acc[j]);
      }
    }
    if (kt + 1 < nk)
      store_slice(s, As + (cur ^ 1) * A_TILE, Bs + (cur ^ 1) * B_TILE);
    __syncthreads();
  }

  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(Cs + wm * C_LD + wn + 16 * j, acc[j], C_LD,
                            wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN / 4; i += kThreads) {
    const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
    if (m0 + r < B && n0 + c < H) {
      const size_t o = (size_t)(m0 + r) * H + n0 + c;
      const float4 x = *reinterpret_cast<const float4*>(xw_t + o);
      const float* cs = Cs + r * C_LD + c;
      *reinterpret_cast<float4*>(out_t + o) =
          make_float4(tanhf(x.x + cs[0]), tanhf(x.y + cs[1]),
                      tanhf(x.z + cs[2]), tanhf(x.w + cs[3]));
    }
  }
}

}  // namespace

// H must be a multiple of 8 and every pointer 16-byte aligned.
extern "C" int rnn_scan_launch(const float* xw, const __nv_bfloat16* w,
                               const float* h0, int T, int B, int H,
                               int reverse, float* out, cudaStream_t stream) {
  if (H % 8 != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((H + BN - 1) / BN, (B + BM - 1) / BM);
  const size_t step = (size_t)B * H;
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const float* h_prev =
        s == 0 ? h0 : out + (size_t)(reverse ? t + 1 : t - 1) * step;
    rnn_step_kernel<<<grid, kThreads, 0, stream>>>(xw + t * step, w, h_prev,
                                                   B, H, out + t * step);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
