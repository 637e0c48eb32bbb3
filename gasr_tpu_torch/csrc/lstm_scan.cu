// LSTM recurrence, gates i, f, g, o:
//   pre = xw[t] + bf16(h_{t-1}) @ W_hh_bf16   (float32 accumulation)
//   c = sigmoid(f) * c + sigmoid(i) * tanh(g),  h = sigmoid(o) * tanh(c)
// forward or reverse in time, one or two directions per launch.
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
// costs is the chain of steps, not either bound.
// Design (simple and right first): one launch per time step covering every
// direction (blockIdx.z; a bidirectional layer's reverse direction walks T
// backwards in the same launches, halving the serial steps). A 128-thread
// block owns 16 batch rows x 16 hidden units [j0, j0 + 16) of one direction
// and multiplies against the four column slices g*H + [j0, j0 + 16) of W_hh,
// so i, f, g and o of a unit land in the same block: warp g computes gate g
// as one 16 x 16 WMMA bf16 fragment with float32 accumulators. The reduction
// walks 64-wide slices through an 8-stage cp.async ring in shared memory
// (16-byte copies, zero-filled past B and H; 90 KB, two blocks per SM), so
// at H=512 seven of the eight slices are in flight at once. Each
// thread loads its units' xw[t] and c before the loop, so those reads
// overlap the product. The epilogue adds xw[t],
// applies the gates, updates c in place (a [D, B, H] float32 buffer that
// only the owning block reads and writes), writes h to the output and a
// bf16 copy of h to a ping-pong buffer [D, 2, B, H], which the next step
// reads as its operand. At DS2 (B=32, H=512) a step has 2 x 32 x 2 = 128
// blocks; at the BiLSTM (B=16, H=256) 64. H must be a multiple of 16, which
// the wrapper ensures by zero padding: a padded unit has zero xw and zero W
// rows and columns, so its gates are 1/2, 1/2, 0, 1/2, its c and h stay 0,
// and it adds nothing to any real unit's sum.
// Redesign for later: a persistent kernel that keeps W_hh resident in
// shared memory (2 MB bf16 per direction at H=512, ~16 KB per SM over 132
// SMs) with a grid-wide step barrier and wgmma, removing per-step launches.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BM = 16;          // batch rows per block
constexpr int BN = 16;          // hidden units per block
constexpr int NC = 4 * BN;      // W_hh columns per block (4 gates)
constexpr int BK = 64;          // reduction slice per stage
constexpr int kStages = 8;      // cp.async ring depth
constexpr int kThreads = 128;   // 4 warps: warp g computes gate g
constexpr int A_LD = BK + 8;    // padded leading dims: multiples of 8 for
constexpr int B_LD = NC + 8;    // bf16 WMMA loads, of 4 for float stores,
constexpr int C_LD = NC + 4;    // and 16-byte aligned rows
constexpr int A_TILE = BM * A_LD;   // bf16 elements per stage
constexpr int B_TILE = BK * B_LD;
constexpr int A_VEC = BM * BK / 8 / kThreads;   // 16-byte copies per thread
constexpr int B_VEC = BK * NC / 8 / kThreads;
constexpr int kPer = BM * BN / kThreads;        // epilogue units per thread
constexpr size_t kLoopBytes =
    kStages * (A_TILE + B_TILE) * sizeof(__nv_bfloat16);
constexpr size_t kEpiBytes = BM * C_LD * sizeof(float);
constexpr size_t kSmemBytes = kLoopBytes > kEpiBytes ? kLoopBytes : kEpiBytes;
static_assert(A_VEC == 1 && B_VEC * 8 * kThreads == BK * NC,
              "tile copies must divide evenly among the threads");
static_assert(kSmemBytes <= 113 * 1024, "two blocks per SM");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;   // 0 bytes read: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// one stage: h_prev[m0:m0+16, k0:k0+64] and W_hh[k0:k0+64, the 4 x 16
// columns g*H + j0 + u]
__device__ __forceinline__ void load_stage(__nv_bfloat16* As,
                                           __nv_bfloat16* Bs,
                                           const __nv_bfloat16* h_prev,
                                           const __nv_bfloat16* w, int B,
                                           int H, int m0, int j0, int k0) {
  {
    const int r = threadIdx.x / (BK / 8), c = (threadIdx.x % (BK / 8)) * 8;
    const bool ok = m0 + r < B && k0 + c < H;
    cp_async16(As + r * A_LD + c,
               ok ? h_prev + (size_t)(m0 + r) * H + k0 + c : h_prev, ok);
  }
  for (int q = 0; q < B_VEC; ++q) {
    const int i = threadIdx.x + q * kThreads;
    const int r = i / (NC / 8), cv = (i % (NC / 8)) * 8;
    const bool ok = k0 + r < H;
    const size_t col = (size_t)(cv / BN) * H + j0 + cv % BN;
    cp_async16(Bs + r * B_LD + cv,
               ok ? w + (size_t)(k0 + r) * 4 * H + col : w, ok);
  }
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(kThreads)
lstm_step_kernel(const float* __restrict__ xw0, const float* __restrict__ xw1,
                 const __nv_bfloat16* __restrict__ w0,
                 const __nv_bfloat16* __restrict__ w1,
                 __nv_bfloat16* __restrict__ hbf, float* __restrict__ c_all,
                 int D, int T, int B, int H, int step, int rev_mask,
                 float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [S][A_TILE]
  __nv_bfloat16* Bs = As + kStages * A_TILE;                     // [S][B_TILE]
  float* Cs = reinterpret_cast<float*>(smem);   // epilogue, after the loop

  const int d = blockIdx.z;
  const int t = ((rev_mask >> d) & 1) ? T - 1 - step : step;
  const int j0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const size_t state = (size_t)B * H;
  const __nv_bfloat16* w = d ? w1 : w0;
  const float* xw_t = (d ? xw1 : xw0) + (size_t)t * B * 4 * H;
  const __nv_bfloat16* h_prev = hbf + (2 * d + (step & 1)) * state;
  __nv_bfloat16* h_next = hbf + (2 * d + ((step + 1) & 1)) * state;
  float* c = c_all + d * state;
  float* out_t = out + (size_t)t * B * D * H + (size_t)d * H;  // row D * H

  const int g = threadIdx.x / 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.0f);

  const int nk = (H + BK - 1) / BK;
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      load_stage(As + s * A_TILE, Bs + s * B_TILE, h_prev, w, B, H, m0, j0,
                 s * BK);
    cp_async_commit();   // empty groups keep the wait count uniform
  }
  // this thread's epilogue operands, read while the slices are in flight
  float xg[kPer][4], cv[kPer];
  for (int q = 0; q < kPer; ++q) {
    const int i = threadIdx.x + q * kThreads;
    const int b = m0 + i / BN, j = j0 + i % BN;
    if (b >= B) continue;
    const float* x = xw_t + (size_t)b * 4 * H + j;
    for (int gi = 0; gi < 4; ++gi) xg[q][gi] = x[gi * H];
    cv[q] = c[(size_t)b * H + j];
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();   // slice kt has landed
    __syncthreads();                // ... for every thread; slice kt-1 done
    const int nxt = kt + kStages - 1;
    if (nxt < nk)
      load_stage(As + (nxt % kStages) * A_TILE, Bs + (nxt % kStages) * B_TILE,
                 h_prev, w, B, H, m0, j0, nxt * BK);
    cp_async_commit();
    const __nv_bfloat16* a_s = As + (kt % kStages) * A_TILE;
    const __nv_bfloat16* b_s = Bs + (kt % kStages) * B_TILE;
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b;
      wmma::load_matrix_sync(a, a_s + kk, A_LD);
      wmma::load_matrix_sync(b, b_s + kk * B_LD + g * BN, B_LD);
      wmma::mma_sync(acc, a, b, acc);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  wmma::store_matrix_sync(Cs + g * BN, acc, C_LD, wmma::mem_row_major);
  __syncthreads();

  for (int q = 0; q < kPer; ++q) {
    const int i = threadIdx.x + q * kThreads;
    const int r = i / BN, u = i % BN;
    const int b = m0 + r;
    if (b >= B) continue;
    const int j = j0 + u;
    const float* cs = Cs + r * C_LD + u;
    const float ig = sigmoid(xg[q][0] + cs[0]);
    const float fg = sigmoid(xg[q][1] + cs[BN]);
    const float gg = tanhf(xg[q][2] + cs[2 * BN]);
    const float og = sigmoid(xg[q][3] + cs[3 * BN]);
    const size_t o = (size_t)b * H + j;
    const float cn = fg * cv[q] + ig * gg;
    const float hn = og * tanhf(cn);
    c[o] = cn;
    h_next[o] = __float2bfloat16_rn(hn);
    out_t[(size_t)b * D * H + j] = hn;
  }
}

}  // namespace

// D directions (1 or 2): direction d reads xw_d [T, B, 4H] float32 and
// w_d [H, 4H] bf16, walks backwards in time when bit d of rev_mask is set,
// and writes its h into columns [d*H, (d+1)*H) of out [T, B, D*H]. hbf
// [D, 2, B, H] bf16 holds bf16(h0) in its first half of each direction;
// c [D, B, H] float32 holds c0 and is updated in place. H must be a
// multiple of 16 and every pointer 16-byte aligned. One launch per step.
extern "C" int lstm_scan_launch(const float* xw0, const float* xw1,
                                const __nv_bfloat16* w0,
                                const __nv_bfloat16* w1, __nv_bfloat16* hbf,
                                float* c, int D, int T, int B, int H,
                                int rev_mask, float* out,
                                cudaStream_t stream) {
  if (H % BN != 0 || D < 1 || D > 2) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      lstm_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H / BN, (B + BM - 1) / BM, D);
  for (int s = 0; s < T; ++s) {
    lstm_step_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
        xw0, xw1, w0, w1, hbf, c, D, T, B, H, s, rev_mask, out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
