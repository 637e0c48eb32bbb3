// wav2vec 2.0's positional convolution on the bf16 serving path, with its
// bias add and exact GELU, in one launch: an implicit GEMM a (frame tile,
// group, utterance) on the tensor cores.
//
// Replaces no Pallas kernel: wav2vec 2.0 is the port's own model family
// (models/wav2vec2.py, no JAX counterpart). It replaces the eager chain of
// the model's `model.pos_conv` span: the padded copy of h, cuDNN's grouped
// convolution (`precomputed_convolve_sgemm`, no tensor cores), the bias
// add, the slice that drops the last frame and F.gelu. For h bf16 [B, T,
// D] (D = 64 G), the group g = o / 64 and lo the left padding (K / 2):
//   s[b, t, o] = bf16(sum_{k < K} sum_{c < 64} h[b, t + k - lo, 64 g + c]
//                     * w[k, c, o])        (rows outside [0, T) are zero;
//                                           the sum in float32)
//   y[b, t, o] = bf16(float(s) + float(bias[o]))            (`.add_(b)`)
//   gelu:  out = bf16((y * 0.5) * (1 + erf(y * sqrt(1/2))))  (F.gelu)
//   none:  out = y
// for t < T only. Given the same float32 sums, the epilogue is bit-equal
// to the eager `.add_(b)` and F.gelu (bias_act.cu's GELU expression);
// only the order of the float32 sum differs from cuDNN's.
//
// Bound on the card: operations. At wav2vec2_batch (B 64, T 999, D 1024,
// K 128, 16 groups) the products are 2 x 63,936 x 128 x 64 x 1024 = 1.073
// TFLOP, 1.085 ms at 989 TFLOP/s; h and the output are 131 MB each and
// the weight 16.8 MB: 0.083 ms at 3.35 TB/s.
//
// Design. One block a (512 frames, group, utterance), 2048 blocks at the
// cell's shape; 2 consumer warpgroups of 256 frames each and a copy warp.
//   - The products run transposed, out^T [64 o][256 t] = sum over the K
//     taps of W_k^T [64 o][64 c] . X_k [64 c][256 t], as wgmma m64n256k16
//     with both operands in shared memory: N = 256 frames, where the
//     group's 64 output channels alone would give N = 64, whose operands
//     would cost as many shared-memory bytes as the products take cycles.
//   - The input window, rows t0 - lo .. t0 + 512 + K - lo - 2 of the
//     group's 64 channels, is staged once (cp.async, zeros outside [0,
//     T): no padded copy in device memory) in the tensor cores' layout
//     without swizzle: eight planes of 8 channels, each row of a plane 16
//     bytes, the rows contiguous. In that layout a core matrix is 8
//     consecutive rows, so X_k, the window shifted by k rows, is the same
//     descriptor with its start 16 k bytes later (a swizzled layout cannot
//     shift by one row: its pattern follows the address).
//   - The weight reaches the kernel in the same layout, [G][K][8 planes]
//     [64 o][8 c] (the wrapper's one permuted copy of the [K, 64, D]
//     weight, 16.8 MB), so a stage of two taps is one contiguous 16 KB
//     bulk copy (the tensor memory accelerator) into a ring of six,
//     tracked by full / empty mbarriers; the copy warp refills a slot as
//     soon as both warpgroups release it. Each block reads its group's
//     weight (1 MB) once from L2, for 512 frames.
//   - A warpgroup issues a stage's 8 products (two taps, four 16-channel
//     steps), commits them, and waits for the previous stage's group
//     before releasing its slot: one stage of products always in flight.
//     float32 accumulators, 128 a thread.
//   - The epilogue rounds, adds the bias, takes the GELU, and stages the
//     [512 t][64 o] tile in shared memory (over the ring) for 16-byte
//     rows of the output; frames at or past T are not written.
// Shared memory at K = 128: the ring 96 KB, the window 639 x 128 bytes
// (80 KB): 176 KB, one block an SM. Odd K arrives padded to even by the
// wrapper with a zero tap.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kC = 64;                    // channels a group, in and out
constexpr int kN = 256;                   // frames a consumer warpgroup
constexpr int kConsumers = 2;             // consumer warpgroups
constexpr int kTile = kN * kConsumers;    // frames a block
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kThreads = kConsumerThreads + 32;   // + the copy warp
constexpr int kTapBytes = kC * kC * 2;    // one tap's 64 x 64 bf16
constexpr int kStageTaps = 2;
constexpr int kStageBytes = kStageTaps * kTapBytes;
constexpr int kStages = 6;
constexpr int kMaxTaps = 512;             // the window then fills the SM
constexpr int kLdOut = kC + 8;            // bf16 a staged output row
constexpr float kSqrtHalf = 0.70710678118654752440f;   // PyTorch's kAlpha

// the ring, the window (8 planes of R rows of 16 bytes), the barriers
size_t smem_bytes(int K) {
  return (size_t)kStages * kStageBytes + (size_t)8 * (kTile + K - 1) * 16 +
         2 * kStages * sizeof(uint64_t);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ float round_bf16(float f) {
  return __bfloat162float(__float2bfloat16_rn(f));
}

// 16 bytes global -> shared; ok = false writes zeros and reads nothing
__device__ __forceinline__ void copy16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// until the phase of bar with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes at src (contiguous) into dst by the tensor memory accelerator,
// counted by bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  const uint32_t f = smem_addr(bar);
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(f),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(f)
      : "memory");
}

// orders this thread's shared-memory accesses through the generic proxy
// (st.shared, cp.async) with those of the tensor cores (the async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Descriptor of a K-major operand without swizzle: core matrices of 8
// rows x 16 bytes; lbo the bytes between the two 8-element halves of the
// 16-deep K step, sbo those between groups of 8 rows (128: rows
// contiguous). The start need only be 16-byte aligned.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// d (64 x 256 float32, the warpgroup's accumulator fragment) += A (64 x
// 16 bf16, by da) . B (16 x 256 bf16, by db), both K-major
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// keeps the compiler from moving accesses to registers that asynchronous
// products write across this point
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the consumer warpgroups' barrier (the copy warp takes no part)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
}

// the rounded sum, the bias add and (gelu) the exact GELU, as the eager
// passes round them
template <bool kGelu>
__device__ __forceinline__ bf16 finish(float acc, float bias) {
  const float y = round_bf16(round_bf16(acc) + bias);
  if (!kGelu) return __float2bfloat16_rn(y);
  return __float2bfloat16_rn(y * 0.5f * (1.0f + erff(y * kSqrtHalf)));
}

template <bool kGelu>
__global__ void __launch_bounds__(kThreads, 1)
pos_conv_kernel(const bf16* __restrict__ h, const bf16* __restrict__ wp,
                const bf16* __restrict__ bias, bf16* __restrict__ out,
                int T, int D, int K, int lo) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int R = kTile + K - 1;              // window rows
  const uint32_t plane = (uint32_t)R * 16;  // bytes a plane of 8 channels
  unsigned char* ring = smem;
  unsigned char* xs = smem + kStages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(xs + 8 * plane);
  uint64_t* empty = full + kStages;

  const int t0 = blockIdx.x * kTile, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int n_stages = K / kStageTaps;
  const unsigned char* wg_src =
      reinterpret_cast<const unsigned char*>(wp) + (size_t)g * K * kTapBytes;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kConsumerThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const bool copier = tid == kConsumerThreads;
  if (copier)
    for (int s = 0; s < n_stages && s < kStages; ++s)
      bulk_load(ring + s * kStageBytes, wg_src + (size_t)s * kStageBytes,
                kStageBytes, full + s);

  // the window: row r is frame t0 - lo + r; 8 threads a row, one plane
  // each, so that a warp reads 4 rows' 512 contiguous bytes
  const bf16* hb = h + (size_t)b * T * D + g * kC;
  for (int i = tid; i < R * 8; i += kThreads) {
    const int r = i >> 3, kc = i & 7;
    const int t = t0 - lo + r;
    const bool ok = t >= 0 && t < T;
    copy16(xs + kc * plane + r * 16, ok ? hb + (size_t)t * D + kc * 8 : hb,
           ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  fence_async_shared();
  __syncthreads();

  if (tid >= kConsumerThreads) {
    if (copier)
      for (int s = kStages; s < n_stages; ++s) {
        const int slot = s % kStages;
        mbar_wait(empty + slot, (s / kStages - 1) & 1);
        bulk_load(ring + slot * kStageBytes,
                  wg_src + (size_t)s * kStageBytes, kStageBytes,
                  full + slot);
      }
    return;
  }

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.f;
  const uint32_t ring_s = smem_addr(ring);
  // this warpgroup's first frame: window row wg * kN at tap 0
  const uint32_t x0 = smem_addr(xs) + (uint32_t)(wg * kN) * 16;
  for (int s = 0; s < n_stages; ++s) {
    const int slot = s % kStages;
    mbar_wait(full + slot, (s / kStages) & 1);
    wgmma_fence();
    const uint32_t w_s = ring_s + slot * kStageBytes;
#pragma unroll
    for (int tp = 0; tp < kStageTaps; ++tp) {
      const uint32_t xk = x0 + (uint32_t)(s * kStageTaps + tp) * 16;
#pragma unroll
      for (int ks = 0; ks < kC / 16; ++ks)
        wgmma_ss(d, desc(w_s + tp * kTapBytes + ks * 2 * 1024, 1024, 128),
                 desc(xk + ks * 2 * plane, plane, 128));
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (s > 0) {
      // the previous stage's products are done: its slot is free
      __syncwarp();
      if (lane == 0)
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                         smem_addr(empty + (s - 1) % kStages))
                     : "memory");
    }
  }
  wgmma_wait<0>();
  fence_acc(d);
  fence_async_shared();
  consumers_sync();   // every product is done: the ring is free

  // accumulator (row o = 16 warp + lane / 4 (+ 8), column t = 8 i + 2
  // (lane % 4) (+ 1)) -> staged [t][o]
  bf16* st = reinterpret_cast<bf16*>(ring);
  const int o = 16 * warp + (lane >> 2);
  const float b_lo = __bfloat162float(bias[g * kC + o]);
  const float b_hi = __bfloat162float(bias[g * kC + o + 8]);
#pragma unroll
  for (int i = 0; i < kN / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = wg * kN + 8 * i + 2 * (lane & 3) + e;
      st[n * kLdOut + o] = finish<kGelu>(d[4 * i + e], b_lo);
      st[n * kLdOut + o + 8] = finish<kGelu>(d[4 * i + 2 + e], b_hi);
    }
  consumers_sync();
  // the frames before T, 16 bytes a thread a step
  bf16* ob = out + (size_t)b * T * D + g * kC;
  const int rows = min(kTile, T - t0);
  for (int i = tid; i < rows * 8; i += kConsumerThreads) {
    const int n = i >> 3, c8 = i & 7;
    *reinterpret_cast<uint4*>(ob + (size_t)(t0 + n) * D + c8 * 8) =
        *reinterpret_cast<const uint4*>(st + n * kLdOut + c8 * 8);
  }
}

template <bool kGelu>
cudaError_t launch(const bf16* h, const bf16* wp, const bf16* bias,
                   bf16* out, int B, int T, int D, int K, int lo,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      pos_conv_kernel<kGelu>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(kMaxTaps));
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kTile - 1) / kTile, D / kC, B);
  pos_conv_kernel<kGelu><<<grid, kThreads, smem_bytes(K), stream>>>(
      h, wp, bias, out, T, D, K, lo);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// h bf16 [B, T, D] contiguous, wp bf16 [D / 64][K][8][64][8] contiguous
// (the weight [K, 64, D] permuted: wp[g, k, c / 8, o, c % 8] = w[k, c, 64 g
// + o]; K even, at most 512), bias bf16 [D], out bf16 [B, T, D]
// contiguous; lo in [0, K) the frames of zero padding before h; act 1 adds
// the GELU after the bias, 0 not.
int pos_conv_launch(const void* h, const void* wp, const void* bias,
                    void* out, int B, int T, int D, int K, int lo, int act,
                    int device, void* stream) {
  if (B <= 0 || T <= 0 || D <= 0 || D % kC || K <= 0 || K % kStageTaps ||
      K > kMaxTaps || lo < 0 || lo >= K || B > 65535 || D / kC > 65535)
    return (int)cudaErrorInvalidValue;
  int prev = -1;
  cudaGetDevice(&prev);
  if (prev != device) cudaSetDevice(device);
  const bf16* hb = static_cast<const bf16*>(h);
  const bf16* wb = static_cast<const bf16*>(wp);
  const bf16* bb = static_cast<const bf16*>(bias);
  bf16* ob = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      act ? launch<true>(hb, wb, bb, ob, B, T, D, K, lo, st)
          : launch<false>(hb, wb, bb, ob, B, T, D, K, lo, st);
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

}  // extern "C"
