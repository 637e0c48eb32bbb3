// The epilogue of a block linear on the bf16 serving path: the float32
// bias add, the rounding to bf16 and the swish, GLU or GELU after it, in
// one pass over the float32 product that cuBLAS wrote.
//
// Replaces no Pallas kernel: the JAX package's linears and activations are
// plain jnp (gasr_tpu/models/conformer.py, `_lin`, `jax.nn.sigmoid`), and
// the port's plain version (ops/cuda/bias_act.py::bias_act_plain) is the
// same chain as eager kernels: the bias add in the generic broadcast
// kernel, the cast, then six bf16 passes for a swish or a GLU. This file
// computes the same function with the same float32 expressions, rounded to
// bf16 where the eager passes round, for y float32 [rows, n] and b float32
// [n]:
//   t     = bf16(y + float(bf16(b)))
//   none:   out = t
//   swish:  out = bf16(t * s(t))
//   glu:    out[:, j] = bf16(t[:, j] * s(t[:, j + n/2]))     [rows, n/2]
//   gelu:   out = bf16((t * 0.5) * (1 + erf(t * sqrt(1/2))))
//   s(u)  = bf16(1 / bf16(1 + bf16(exp(-u))))
// s is the plain version's `1.0 / (1.0 + torch.exp(-u))`: neg, exp, the add,
// then `Tensor.__rdiv__`, which is reciprocal and `* 1.0` (exact). Each step
// is one IEEE float32 operation rounded to nearest: expf (not __expf), the
// reciprocal by __frcp_rn (correctly rounded, so the bits of 1.0f / d), and
// -fmad=false, so the product t * s is not fused into anything. The gelu
// form is `F.gelu(t)` (approximate="none") as PyTorch's CUDA kernel
// computes it on a bf16 tensor: in float32, erff, the products and the sum
// in that order, rounded to bf16 once (wav2vec 2.0's feed-forward). The
// output is bit-equal to the plain version's.
//
// Bound on the card: bytes. An output element costs 4 bytes of y read and 2
// written, 10 for glu (both halves read); [24000, 4096] swish moves 0.59 GB,
// 176 us at 3.35 TB/s. The eager chain moves ~40 bytes an element.
//
// Design.
//   - A thread owns one group of 8 output columns for the whole launch: it
//     reads its bias (16 values for glu) once through the read-only path,
//     rounds it once and keeps it in registers.
//   - A block is 256 threads laid out as `by` rows of `bx` column groups
//     (a warp's threads read neighbouring addresses: a row's groups, then
//     the next row's); gridDim.x blocks across the column groups,
//     gridDim.y down the rows, as many blocks as the card holds at once,
//     each striding over the rows.
//   - Per row: two 16-byte loads of y (four for glu: the same columns of
//     both halves), one 16-byte store of 8 bf16. A thread issues the loads
//     of kRows rows before any arithmetic, so that enough bytes are in
//     flight to cover the memory's latency.
//   - y is read once: streaming loads (evict first).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 2;         // rows a thread loads before computing

enum Act { kNone = 0, kSwish = 1, kGlu = 2, kGelu = 3 };

// float(M_SQRT1_2), PyTorch's kAlpha
constexpr float kSqrtHalf = 0.70710678118654752440f;

__device__ __forceinline__ float round_bf16(float f) {
  return __bfloat162float(__float2bfloat16_rn(f));
}
__device__ __forceinline__ uint32_t pack(float a, float b) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(a))
       | ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}
__device__ __forceinline__ void unpack8(const float4& a, const float4& e,
                                        float* f) {
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = e.x; f[5] = e.y; f[6] = e.z; f[7] = e.w;
}

// jax.nn.sigmoid's 1 / (1 + exp(-u)) as the eager bf16 passes round it
__device__ __forceinline__ float sigmoid_bf16(float u) {
  const float e = round_bf16(expf(-u));
  const float d = round_bf16(1.0f + e);
  return round_bf16(__frcp_rn(d));
}

template <int kAct>
__global__ void __launch_bounds__(kThreads)
bias_act_kernel(const float* __restrict__ y, const float* __restrict__ b,
                __nv_bfloat16* __restrict__ out, long long rows, int n,
                int groups, int bx, int by) {
  const int ty = threadIdx.x / bx;
  const int c = blockIdx.x * bx + (threadIdx.x - ty * bx);
  if (ty >= by || c >= groups) return;
  const int col = c * 8;
  const int half = n >> 1;
  const int n_out = kAct == kGlu ? half : n;
  float bt[8], bg[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    bt[q] = round_bf16(__ldg(b + col + q));
    if (kAct == kGlu) bg[q] = round_bf16(__ldg(b + half + col + q));
  }
  const long long step = (long long)gridDim.y * by * kRows;
  for (long long r0 = (long long)blockIdx.y * by * kRows + ty; r0 < rows;
       r0 += step) {
    float4 v[kRows][2], w[kRows][2];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const long long r = r0 + (long long)u * by;
      if (r < rows) {
        const float4* p = reinterpret_cast<const float4*>(y + r * n + col);
        v[u][0] = __ldcs(p);
        v[u][1] = __ldcs(p + 1);
        if (kAct == kGlu) {
          const float4* g = reinterpret_cast<const float4*>(y + r * n + half
                                                            + col);
          w[u][0] = __ldcs(g);
          w[u][1] = __ldcs(g + 1);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const long long r = r0 + (long long)u * by;
      if (r < rows) {
        float t[8], o[8];
        unpack8(v[u][0], v[u][1], t);
#pragma unroll
        for (int q = 0; q < 8; ++q) t[q] = round_bf16(t[q] + bt[q]);
        if (kAct == kNone) {
#pragma unroll
          for (int q = 0; q < 8; ++q) o[q] = t[q];
        } else if (kAct == kSwish) {
#pragma unroll
          for (int q = 0; q < 8; ++q) o[q] = t[q] * sigmoid_bf16(t[q]);
        } else if (kAct == kGelu) {
#pragma unroll
          for (int q = 0; q < 8; ++q)
            o[q] = t[q] * 0.5f * (1.0f + erff(t[q] * kSqrtHalf));
        } else {
          float g[8];
          unpack8(w[u][0], w[u][1], g);
#pragma unroll
          for (int q = 0; q < 8; ++q)
            o[q] = t[q] * sigmoid_bf16(round_bf16(g[q] + bg[q]));
        }
        *reinterpret_cast<uint4*>(out + r * n_out + col) =
            make_uint4(pack(o[0], o[1]), pack(o[2], o[3]), pack(o[4], o[5]),
                       pack(o[6], o[7]));
      }
    }
  }
}

// bx column groups a block row and `chunks` blocks across: the split of the
// `groups` column groups that leaves the fewest of a block's threads idle
void split(int groups, int* chunks, int* bx, int* by) {
  const int first = (groups + kThreads - 1) / kThreads;
  double best = -1.0;
  for (int k = first; k < first + 8; ++k) {
    const int x = (groups + k - 1) / k;
    const int yy = kThreads / x;
    const double used = (double)groups / ((double)k * x) * x * yy / kThreads;
    if (used > best) {
      best = used;
      *chunks = k;
      *bx = x;
      *by = yy;
    }
  }
}

template <int kAct>
cudaError_t launch(const float* y, const float* b, __nv_bfloat16* out,
                   long long rows, int n, cudaStream_t stream) {
  // blocks the card holds at once, asked once a kernel
  static int cap = 0;
  if (cap == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bias_act_kernel<kAct>, kThreads, 0);
    cap = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int groups = (kAct == kGlu ? n / 2 : n) / 8;
  int chunks = 1, bx = 1, by = 1;
  split(groups, &chunks, &bx, &by);
  const long long per_block = (long long)by * kRows;
  const long long want = (rows + per_block - 1) / per_block;
  long long gy = cap / chunks;
  if (gy < 1) gy = 1;
  if (gy > want) gy = want;
  if (gy > 65535) gy = 65535;
  bias_act_kernel<kAct><<<dim3(chunks, (unsigned)gy), kThreads, 0, stream>>>(
      y, b, out, rows, n, groups, bx, by);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y float32 [rows, n] contiguous, b float32 [n] contiguous, out bf16 [rows,
// n] (act 0 none, 1 swish, 3 gelu) or [rows, n / 2] (act 2 glu) contiguous; n a
// multiple of 8 (16 for glu); y and out 16-byte aligned.
int bias_act_launch(const void* y, const void* b, void* out, long long rows,
                    int n, int act, int device, void* stream) {
  if (act < kNone || act > kGelu || n <= 0 ||
      n % (act == kGlu ? 16 : 8) != 0 || rows < 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  int prev = -1;
  cudaGetDevice(&prev);
  if (prev != device) cudaSetDevice(device);
  const float* yf = static_cast<const float*>(y);
  const float* bf = static_cast<const float*>(b);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (act == kSwish)
    err = launch<kSwish>(yf, bf, o, rows, n, st);
  else if (act == kGlu)
    err = launch<kGlu>(yf, bf, o, rows, n, st);
  else if (act == kGelu)
    err = launch<kGelu>(yf, bf, o, rows, n, st);
  else
    err = launch<kNone>(yf, bf, o, rows, n, st);
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

}  // extern "C"
