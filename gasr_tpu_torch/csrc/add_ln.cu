// The conformer block's residual add and the LayerNorm after it, in one
// pass over each row of the bf16 residual stream.
//
// Replaces no Pallas kernel: the JAX package's LayerNorm is plain jnp
// (gasr_tpu/models/conformer.py, `_ln`), and the port's plain version
// (ops/cuda/add_ln.py::add_ln_plain) is the same chain of eager kernels,
// about ten a norm with the residual add in front. This file computes the
// same function with the same float32 expressions, in the same order, for
// x bf16 [rows, d], an optional branch output y (bf16 or float32) and its
// scale s, and the norm's g, b float32 [d]:
//   t   = bf16(s * bf16(y))               (`0.5 * ffn`, `a.to(bf16)`, ...)
//   x'  = bf16(x + t)                     (x' = x where there is no y)
//   mu  = sum(x') / d,  var = sum((x' - mu)^2) / d
//   h   = bf16((x' - mu) * rsqrt(var + 1e-5) * g + b)
// mu and var are two passes over the row held in registers, not one pass
// of E[x^2] - mu^2, which rounds otherwise. The sums are taken in another
// order than PyTorch's reduction, so h may differ from the plain version
// in the last bf16 bit where a sum's last float32 bit moves it; x' is
// bit-equal.
//
// Bound on the card: bytes. A row reads x (2 d bytes) and y (2 d or 4 d)
// and writes x' and h (2 d each): rows x d x 6-10 bytes, e.g. 24,000 rows
// of d = 1024 move 0.20-0.25 GB, ~60-73 us at 3.35 TB/s. The eager chain
// moves about 68 bytes an element through ten launches; this is one.
//
// Design.
//   - One warp a row, kWarps rows a block at a time, a grid-stride loop
//     over the rows with as many blocks as the card holds at once.
//   - A lane takes 8 consecutive elements at a time (16-byte loads of x
//     and y, 16-byte stores of x' and h), chunks lane, lane + 32, ...: NV
//     chunks a lane, the whole row in registers, so x' is never read back.
//   - Each of the two sums: the lane's elements in order, then a butterfly
//     of warp shuffles, after which every lane holds the same bits.
//   - Rows are addressed through two leading strides (row r = i n1 + j at
//     i s0 + j s1), so the residual stream's transposed [T, B, d] view is
//     read in place; x' and h are written as contiguous rows.
//   - Built with -fmad=false: products and sums round one by one, as the
//     plain version's separate tensor ops do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;        // rows a block at a time
constexpr int kMaxChunks = 4;    // NV at most: d <= 4 * 8 * 32 = 1024
constexpr float kEps = 1e-5f;

__device__ __forceinline__ float lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ float round_bf16(float f) {
  return __bfloat162float(__float2bfloat16_rn(f));
}
__device__ __forceinline__ uint32_t pack(float a, float b) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(a))
       | ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}
__device__ __forceinline__ void unpack8(const uint4& q, float* f) {
  f[0] = lo(q.x); f[1] = hi(q.x); f[2] = lo(q.y); f[3] = hi(q.y);
  f[4] = lo(q.z); f[5] = hi(q.z); f[6] = lo(q.w); f[7] = hi(q.w);
}
__device__ __forceinline__ uint4 pack8(const float* f) {
  return make_uint4(pack(f[0], f[1]), pack(f[2], f[3]), pack(f[4], f[5]),
                    pack(f[6], f[7]));
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// kY: 0 no y, 1 bf16 y, 2 float32 y
template <int NV, int kY>
__global__ void __launch_bounds__(kWarps * 32)
add_ln_kernel(const __nv_bfloat16* __restrict__ x, long long xs0,
              long long xs1, const void* __restrict__ y, long long ys0,
              long long ys1, float s, const float* __restrict__ g,
              const float* __restrict__ b, __nv_bfloat16* __restrict__ xo,
              __nv_bfloat16* __restrict__ h, long long rows, int n1, int d) {
  const int lane = threadIdx.x & 31;
  const int chunks = d >> 3;
  const float inv_d = 1.0f / (float)d;
  for (long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       r < rows; r += (long long)gridDim.x * kWarps) {
    const long long i = r / n1, j = r - i * n1;
    const __nv_bfloat16* xr = x + i * xs0 + j * xs1;
    float v[NV * 8];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = lane + 32 * k;
      if (c < chunks) {
        unpack8(*reinterpret_cast<const uint4*>(xr + c * 8), v + 8 * k);
        if (kY != 0) {
          float t[8];
          if (kY == 1) {
            const __nv_bfloat16* yr =
                static_cast<const __nv_bfloat16*>(y) + i * ys0 + j * ys1;
            unpack8(*reinterpret_cast<const uint4*>(yr + c * 8), t);
          } else {
            const float* yr = static_cast<const float*>(y) + i * ys0
                              + j * ys1 + c * 8;
            const float4 a = *reinterpret_cast<const float4*>(yr);
            const float4 e = *reinterpret_cast<const float4*>(yr + 4);
            t[0] = round_bf16(a.x); t[1] = round_bf16(a.y);
            t[2] = round_bf16(a.z); t[3] = round_bf16(a.w);
            t[4] = round_bf16(e.x); t[5] = round_bf16(e.y);
            t[6] = round_bf16(e.z); t[7] = round_bf16(e.w);
          }
#pragma unroll
          for (int q = 0; q < 8; ++q)
            v[8 * k + q] = round_bf16(v[8 * k + q] + round_bf16(s * t[q]));
          if (xo != nullptr)
            *reinterpret_cast<uint4*>(xo + r * d + c * 8) = pack8(v + 8 * k);
        }
      }
    }
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < NV; ++k)
      if (lane + 32 * k < chunks)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc += v[8 * k + q];
    const float mu = warp_sum(acc) * inv_d;
    acc = 0.0f;
#pragma unroll
    for (int k = 0; k < NV; ++k)
      if (lane + 32 * k < chunks)
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float e = v[8 * k + q] - mu;
          acc += e * e;
        }
    const float var = warp_sum(acc) * inv_d;
    const float rs = rsqrtf(var + kEps);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = lane + 32 * k;
      if (c < chunks) {
        float o[8];
        const float4 g0 = __ldg(reinterpret_cast<const float4*>(g + c * 8));
        const float4 g1 =
            __ldg(reinterpret_cast<const float4*>(g + c * 8 + 4));
        const float4 b0 = __ldg(reinterpret_cast<const float4*>(b + c * 8));
        const float4 b1 =
            __ldg(reinterpret_cast<const float4*>(b + c * 8 + 4));
        const float gg[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
        const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int q = 0; q < 8; ++q)
          o[q] = (v[8 * k + q] - mu) * rs * gg[q] + bb[q];
        *reinterpret_cast<uint4*>(h + r * d + c * 8) = pack8(o);
      }
    }
  }
}

template <int NV, int kY>
cudaError_t launch(const void* x, long long xs0, long long xs1,
                   const void* y, long long ys0, long long ys1, float s,
                   const void* g, const void* b, void* xo, void* h,
                   long long rows, int n1, int d, cudaStream_t stream) {
  // blocks the card holds at once, asked once a kernel
  static int cap = 0;
  if (cap == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, add_ln_kernel<NV, kY>, kWarps * 32, 0);
    cap = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long want = (rows + kWarps - 1) / kWarps;
  const int grid = (int)(want < cap ? want : cap);
  add_ln_kernel<NV, kY><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), xs0, xs1, y, ys0, ys1, s,
      static_cast<const float*>(g), static_cast<const float*>(b),
      static_cast<__nv_bfloat16*>(xo), static_cast<__nv_bfloat16*>(h), rows,
      n1, d);
  return cudaGetLastError();
}

template <int NV>
cudaError_t launch_y(int ykind, const void* x, long long xs0, long long xs1,
                     const void* y, long long ys0, long long ys1, float s,
                     const void* g, const void* b, void* xo, void* h,
                     long long rows, int n1, int d, cudaStream_t stream) {
  if (ykind == 1)
    return launch<NV, 1>(x, xs0, xs1, y, ys0, ys1, s, g, b, xo, h, rows, n1,
                         d, stream);
  if (ykind == 2)
    return launch<NV, 2>(x, xs0, xs1, y, ys0, ys1, s, g, b, xo, h, rows, n1,
                         d, stream);
  return launch<NV, 0>(x, xs0, xs1, y, ys0, ys1, s, g, b, xo, h, rows, n1, d,
                       stream);
}

}  // namespace

extern "C" {

// x [n0, n1, d] bf16 at x + i xs0 + j xs1 (elements; unit stride in d);
// y likewise (ykind 0: none, 1: bf16, 2: float32); g, b float32 [d]; xo
// (may be null: x' not written) and h contiguous bf16 [n0 n1, d]. d a
// multiple of 8 up to 1024; every pointer and row stride 16-byte aligned.
int add_ln_launch(const void* x, long long xs0, long long xs1, const void* y,
                  long long ys0, long long ys1, int ykind, float s,
                  const void* g, const void* b, void* xo, void* h, int n0,
                  int n1, int d, int device, void* stream) {
  if (d <= 0 || d % 8 != 0 || d > kMaxChunks * 8 * 32 || n1 <= 0 ||
      n0 < 0)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)n0 * n1;
  if (rows == 0) return 0;
  int prev = -1;
  cudaGetDevice(&prev);
  if (prev != device) cudaSetDevice(device);
  const int nv = (d / 8 + 31) / 32;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define ADD_LN_NV(N)                                                          \
  case N:                                                                     \
    err = launch_y<N>(ykind, x, xs0, xs1, y, ys0, ys1, s, g, b, xo, h, rows, \
                      n1, d, st);                                             \
    break;
  switch (nv) {
    ADD_LN_NV(1) ADD_LN_NV(2) ADD_LN_NV(3) ADD_LN_NV(4)
    default: err = cudaErrorInvalidValue;
  }
#undef ADD_LN_NV
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

}  // extern "C"
