// Fused conformer stem, redesigned for Hopper: conv1 (3x3, stride 2,
// 1 -> d) + bias + clip computed inside the conv2 kernel from x, conv2
// (3x3, stride 2, d -> d) + bias + clip as an implicit GEMM, then the
// freq-major sub_proj + bias as a GEMM kernel of its own.
//
// Replaces gasr_tpu/ops/pallas/stem.py::fused_stem (`_kernel`, with
// `_conv1_planes` in front of it):
//   h1[b, ti, fi, c] = bf16(clip(b1[c] + sum_{ki,kj} bf16(x)[b, 2ti+ki,
//                      2fi+kj] bf16(w1)[ki, kj, c], 0, 20))
//   h2[b, t2, f2, n] = bf16(clip(b2[n] + sum_{di,dj,c} h1[b, 2t2+di,
//                      2f2+dj, c] w2[di, dj, c, n], 0, 20))
//   out[b, t2, :]    = bp + sum_{f2} h2[b, t2, f2, :] wp[f2 d .. f2 d + d)
// lax "SAME" pads the high edge by one at k = 3, s = 2 on an even size,
// in both convolutions: conv1's taps at x row T or column F read zero x,
// and conv2's taps at h1 row T1 = T/2 or column F1 = F/2 read zero h1
// (not clip(b1 + 0), which computing h1 at the pad would give). bf16
// products, float32 sums; b1 and b2 are added in float32, bp arrives
// rounded to bf16 (stem_ref's `linear` rounds its bias).
//
// Bound on the card: operations. At conformer_l (B=64, T=1200, F=80,
// d=dout=512) conv2 is 384,000 rows x 4608 x 512 x 2 = 1.81 TFLOP,
// sub_proj 19,200 x 10,240 x 512 x 2 = 0.20 TFLOP, conv1 0.014 TFLOP:
// 2.05 ms at 989 TFLOP/s. x, the weights and the output are 0.03 ms of
// device memory; h1 (1.57 GB) never reaches it, and h2 (393 MB, the
// round trip between the two kernels) costs ~0.23 ms at 3.35 TB/s.
//
// Design (times: NVIDIA H100, scripts/torch_stem_probe.py; PERF.md).
// stem_conv_kernel: one block per (BM = 128 conv2 rows, BN = 256 output
// channels, 128 where d is not a multiple of 256; b), 12 warps in three
// roles. conv2's columns f2 are cut into windows of at most 24 (one
// window up to F = 96; F = 128 two of 16, F = 512 six of 21 or 22); the
// rows of a window are (t2, f2) flattened within one b, m = t2 fw + f2 -
// fa, so a tile covers t2 in [ta, tb] and needs h1 rows 2ta .. 2tb + 2 (R
// = 2(tb - ta) + 3, at most 17 at fw = 20) and the window's columns 2 fa
// .. 2 (fa + fw): the region, at most 735 positions at any F, so the
// shared memory does not grow with F (the window's last column is
// computed again by the next window). K = 9 d runs as 32-channel chunks,
// each chunk's nine taps in turn, one tap a stage.
//   - Setup: the im2col of the x under the region (x read through its
//     strides, rounded to bf16; x row T and column F are zeros), [P][16]
//     bf16 as 8 x 8 core matrices, and a table of each position's place
//     in the region (kZero at conv2's pad).
//   - The region of a chunk (R x (2 fw + 1) positions x 32 channels, bf16)
//     is conv1 by mma.sync m16n8k16 on that im2col (9 taps padded to 16)
//     + b1, clipped, in two shared-memory buffers; the row at T1 and the
//     column at F1 are written as zeros, never computed. Chunk 0 by the
//     8 consumer warps before the loop, chunks 1.. by 3 conv1 warps while
//     the consumers multiply the previous chunk, two m16 tiles in flight
//     a warp; mbarriers hand a buffer over (full: 96 conv1 threads;
//     empty: the 8 consumer warps after their last tap of it). Computing
//     h1 costs less than reading it: a build that loads a precomputed h1
//     from device memory in its place is 5x slower.
//   - The region keeps each row's columns split by parity (even, then
//     odd), so the stride-2 taps 2 f2 + dj of consecutive f2 are
//     consecutive positions, 80 bytes apart (32 channels + 8 of padding):
//     the eight rows of each ldmatrix hit eight bank groups.
//   - One copy warp stages w2 by bulk copies (the tensor memory
//     accelerator, one 16 KB block a stage, laid out by the wrapper in the
//     tensor cores' 64-byte swizzle) into a ring of 5 stages (6 or 4
//     where the shared memory allows), tracked by full / empty mbarriers,
//     each stage as soon as its slot is free.
//   - Two consumer warpgroups, 64 rows x BN each: wgmma m64nBNk16 with A
//     from registers (each warp's 16 rows loaded by ldmatrix at stride 2
//     from the region: the taps fit no shared-memory descriptor) and B
//     from the staged w2 by descriptor, float32 accumulators (128 a
//     thread at BN = 256); one commit group a tap, the previous tap's
//     wait, two alternating register sets for A. ptxas serializes these
//     wgmma (its C7513 notice: A registers written between products), so
//     a tap's products and its loads do not overlap within a warpgroup.
//   - The epilogue adds b2, clips, rounds to bf16 and writes h2 [B, T2,
//     F2, d] (16-byte rows staged in shared memory), which is [B T2, F2 d]
//     freq-major: sub_proj's A as it is.
// stem_proj_kernel: out [B T2, dout] = h2 @ wp + bp, 128 x 256 (or 128)
// tiles, 8 warps: A rows by cp.async, wp blocks (staged and swizzled like
// w2) by bulk copies, a ring of 6 stages of 32, wgmma as above, float32
// or bf16 out. Every wp byte is read once a 128-row tile, from shared
// memory. A cluster of blocks sharing each w2 stage by multicast (each w2
// byte for 256 or 512 rows) was slower here: the blocks wait for each
// other at every stage.
// Shared memory (d = 512, any F): the ring 5 x 16 KB, two regions of
// 735 x 80 bytes, the im2col 23 KB, the table: 221 KB, one block an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;      // 2 warpgroups of 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kConv1Warps = 3;     // stem_conv's conv1 warps
constexpr int kConvThreads = kThreads + 32 + 32 * kConv1Warps;   // + its
                                                  // copy warp: 3 warpgroups
constexpr int BM = 128;            // rows a block: 64 a warpgroup
constexpr int CK = 32;             // K a stage: channels of a chunk
constexpr int LDA = CK + 8;        // bf16 a region position / A row
constexpr int kProjStages = 6;     // sub_proj's ring
constexpr int kSmemMax = 232448;   // a block's shared memory on sm_90
constexpr int kZero = 0x40000000;  // position-table flag: conv2's zero pad

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

// The ring of S stages in shared memory. Stage t sits in slot t % S, in
// phase t / S of its barriers. full[i] completes when the stage's bytes
// have landed: the arrival, with the byte count, of the thread that
// copies the B block in bulk (the tensor memory accelerator), plus, where
// A is staged too (a_copies), one arrival of every thread once its
// cp.async copies of A have landed. empty[i] completes when every
// consumer warp is done with the slot (its warpgroup's products that
// read it have finished). stem_conv's copy warp refills a slot as soon
// as it is free; stem_proj's threads copy L = S - 2 stages ahead, so the
// wait for a free slot (stage t - S read) leaves them a stage of slack.
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  int S;
  __device__ void init(bool a_copies) const {
    if (threadIdx.x == 0) {
      for (int i = 0; i < S; ++i) {
        mbar_init(full + i, a_copies ? kThreads + 1 : 1);
        mbar_init(empty + i, kWarps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  __device__ __forceinline__ void wait_free(int t) const {
    if (t >= S) mbar_wait(empty + t % S, (t / S - 1) & 1);
  }
  // this thread's arrival once its earlier cp.async copies have landed
  __device__ __forceinline__ void arrive_copies(int t) const {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                     "r"(smem_addr(full + t % S))
                 : "memory");
  }
  // thread 0: bytes at src (contiguous) into dst, counted by full
  __device__ __forceinline__ void load_b(int t, void* dst, const void* src,
                                         uint32_t bytes) const {
    const uint32_t f = smem_addr(full + t % S);
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
  __device__ __forceinline__ void wait(int s) const {
    mbar_wait(full + s % S, (s / S) & 1);
  }
  __device__ __forceinline__ void release(int s) const {
    __syncwarp();
    if (threadIdx.x % 32 == 0)
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                       smem_addr(empty + s % S))
                   : "memory");
  }
};

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

// Descriptor of a w2 / wp block (32 deep, BN wide) in the 64-byte swizzle
// the tensor cores read without bank conflicts: row n holds its 32 k as
// four 16-byte chunks, chunk c at c ^ ((n % 8) / 2), 8 rows a 512-byte
// atom (stride byte offset 512; blocks aligned to 512 bytes).
__device__ __forceinline__ uint64_t b_desc(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(512 >> 4) << 32) | (2ull << 62);
}

// d (64 x 256 float32, the warpgroup's accumulator fragment) += a (this
// warp's 16 x 16 bf16 rows, mma.m16n8k16's A layout) . B (16 x N bf16,
// K-major core matrices in shared memory, by desc)
__device__ __forceinline__ void wgmma_n256(float* d, const uint32_t* a,
                                          uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
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
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (64 x 128 float32, the warpgroup's accumulator fragment) += a (this
// warp's 16 x 16 bf16 rows, mma.m16n8k16's A layout) . B (16 x N bf16,
// K-major core matrices in shared memory, by desc)
__device__ __forceinline__ void wgmma_n128(float* d, const uint32_t* a,
                                          uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma(float* d, const uint32_t* a,
                                      uint64_t desc) {
  if constexpr (BN == 256)
    wgmma_n256(d, a, desc);
  else
    wgmma_n128(d, a, desc);
}

// keeps the compiler from moving accesses to registers that asynchronous
// products read or write across this point (and from reusing them for
// other values before it)
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_a(uint32_t (&a)[2][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// the consumer warps' barrier (stem_conv's copy warp does not take part)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

__device__ __forceinline__ float clip20(float y) {
  return fminf(fmaxf(y, 0.f), 20.f);
}

// f2 windows. conv2's columns f2 are cut into NW windows of fw = F2 / NW
// or F2 / NW + 1 consecutive columns (the first F2 % NW windows one more),
// NW = ceil(F2 / kWindowMax) (the wrapper's `f2_windows`). A window's rows
// are (t2, f2 - fa) flattened, m = t2 fw + f2 - fa, cut into tiles of BM
// rows; a tile covers t2 in [ta, tb] and needs h1 rows 2 ta .. 2 tb + 2
// and the window's h1 columns 2 fa .. 2 (fa + fw): its region of R (2 fw
// + 1) positions, at most kRegionMax for any fw in [2, kWindowMax] and
// any T. The shared memory is therefore the same at every F.
constexpr int kWindowMax = 24;

// Most h1 region positions of a tile of a window of fw columns (T
// unbounded): (2 span + 3) rows of 2 fw + 1.
__host__ __device__ constexpr int region_positions(int fw) {
  return (2 * ((fw - 1 + BM - 1) / fw) + 3) * (2 * fw + 1);
}

__host__ __device__ constexpr int region_max(int lo, int hi) {
  int most = 0;
  for (int fw = lo; fw <= hi; ++fw)
    most = region_positions(fw) > most ? region_positions(fw) : most;
  return most;
}

constexpr int kRegionMax = region_max(2, kWindowMax);   // 735
constexpr int kRegion16 = (kRegionMax + 15) / 16 * 16;

// Geometry of a block: window w of NW (first column fa, fw columns) and
// its row tile m0 .. m0 + BM - 1.
struct Tile {
  int fa, fw;        // the window's first f2 and its columns
  int m0, ta, R;     // first row, first t2, h1 region rows (2 ta ..)
};

__device__ __forceinline__ Tile tile_of(int y, int tiles, int NW, int T2,
                                        int F2) {
  const int w = y / tiles, q = F2 / NW, rem = F2 % NW;
  const int fw = q + (w < rem), fa = w * q + min(w, rem);
  const int m0 = (y % tiles) * BM;
  const int ta = m0 / fw;
  const int tb = min((m0 + BM - 1) / fw, T2 - 1);
  return {fa, fw, m0, ta, 2 * (tb - ta) + 3};
}

// Shared memory of stem_conv_kernel: the w2 ring [S][CK x BN] bf16, two
// regions [kRegionMax][LDA] bf16, the im2col of x [kRegion16][16] bf16,
// the position table [kRegion16] int, the barriers (the ring's, the
// regions' full and empty). The epilogue's h2 staging [BM][BN + 8] bf16
// overlays the ring and the regions. No term depends on T or F.
__host__ __device__ constexpr size_t conv_smem(int BN, int S) {
  return (size_t)S * CK * BN * sizeof(bf16) +
         2 * (size_t)kRegionMax * LDA * sizeof(bf16) +
         (size_t)kRegion16 * 16 * sizeof(bf16) + kRegion16 * sizeof(int) +
         (2 * S + 4) * sizeof(uint64_t);
}

__host__ __device__ constexpr int conv_stages(int BN) {
  return conv_smem(BN, 6) <= (size_t)kSmemMax
             ? 6
             : (conv_smem(BN, 5) <= (size_t)kSmemMax ? 5 : 4);
}
static_assert(conv_smem(256, conv_stages(256)) <= (size_t)kSmemMax,
              "stem_conv_kernel's shared memory");

template <int BN>
__global__ void __launch_bounds__(kConvThreads, 1)
stem_conv_kernel(const float* __restrict__ x, long long sx_b, long long sx_t,
                 long long sx_f, const bf16* __restrict__ w1t,
                 const float* __restrict__ b1, const bf16* __restrict__ w2s,
                 const float* __restrict__ b2, bf16* __restrict__ h2, int T,
                 int F, int d, int NW, int tiles) {
  constexpr int kStage = CK * BN;    // bf16 a w2 stage
  constexpr int S = conv_stages(BN);
  constexpr int P_max = kRegionMax, P16_max = kRegion16;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int T1 = T / 2, F1 = F / 2, T2 = T / 4, F2 = F / 4;
  const Tile tl = tile_of(blockIdx.y, tiles, NW, T2, F2);
  const int PW = 2 * tl.fw + 1;      // region positions a row
  const int HE = tl.fw + 1;          // even columns 0, 2, .., 2 fw first
  const int rows = T2 * tl.fw;       // conv2 rows of the window of one b
  const int n0 = blockIdx.x * BN, m0 = tl.m0, b = blockIdx.z;
  if (m0 >= rows) return;            // a narrower window's spare tile
  const int P = tl.R * PW, NT = (P + 15) / 16;

  bf16* ring = reinterpret_cast<bf16*>(smem);              // [S][kStage]
  bf16* region = ring + S * kStage;                        // [2][P_max][LDA]
  bf16* xa = region + 2 * P_max * LDA;                     // [P16][16]
  int* table = reinterpret_cast<int*>(xa + P16_max * 16);  // [P16]
  uint64_t* bars = reinterpret_cast<uint64_t*>(table + P16_max);
  const Ring rg{bars, bars + S, S};
  uint64_t* reg_full = bars + 2 * S;   // [2]: the conv1 warps' threads
  uint64_t* reg_empty = reg_full + 2;  // [2]: the 8 consumer warps
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nc = d / CK, n_stages = 9 * nc;

  rg.init(false);
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(reg_full + i, 32 * kConv1Warps);
      mbar_init(reg_empty + i, kWarps);
    }
  }
  // im2col of the x under the region: position p = r PW + c (h1 row
  // 2 ta + r, column 2 fa + c) holds bf16(x[4 ta + 2r + ki, 4 fa + 2c +
  // kj]) at k = 3 ki + kj < 9 (x row T and column F: the zero pad), zeros
  // at k >= 9,
  // as K-major 8 x 8 core matrices (row p's halves k 0-7 and 8-15 at
  // ((p / 8) 2 + half) 128 + (p % 8) 16 bytes: the eight rows of an
  // ldmatrix are 128 contiguous bytes). table[p]: where the position sits
  // in a region (row r, even columns first), kZero at conv2's pad (h1 row
  // T1 or column F1), -1 past the tile's positions.
  const float* xb = x + b * sx_b;
  for (int p = tid; p < NT * 16 && tid < kThreads; p += kThreads) {
    const int r = p / PW, c = p % PW;
    uint32_t v[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
    const bool pad = 2 * tl.ta + r >= T1 || 2 * tl.fa + c >= F1;
    if (p < P && !pad) {
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const int t = 4 * tl.ta + 2 * r + k / 3;
        const int f = 4 * tl.fa + 2 * c + k % 3;
        const float xv = (t < T && f < F) ? xb[t * sx_t + f * sx_f] : 0.f;
        v[k / 2] |= (uint32_t)__bfloat16_as_ushort(__float2bfloat16(xv))
                    << (16 * (k % 2));
      }
    }
    uint4* row = reinterpret_cast<uint4*>(xa + (p / 8) * 128 + (p % 8) * 8);
    row[0] = make_uint4(v[0], v[1], v[2], v[3]);
    row[8] = make_uint4(v[4], v[5], v[6], v[7]);
    table[p] = p < P ? (r * PW + ((c & 1) ? HE + c / 2 : c / 2)) |
                           (pad ? kZero : 0)
                     : -1;
  }

  // conv1 of a chunk by mma.sync: im2col [16 positions x 16] . w1t
  // [16 x 32 channels] per m16 tile; this lane's B fragments and biases
  // of the chunk's four n8 tiles
  uint32_t wb[4][2];
  float bb[4][2];
  auto load_w1 = [&](int cc) {
    const int c0 = cc * CK;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t* wr = reinterpret_cast<const uint32_t*>(
          w1t + (size_t)(c0 + 8 * j + lane / 4) * 16);
      wb[j][0] = wr[lane % 4];
      wb[j][1] = wr[4 + lane % 4];
      bb[j][0] = b1[c0 + 8 * j + 2 * (lane % 4)];
      bb[j][1] = b1[c0 + 8 * j + 2 * (lane % 4) + 1];
    }
  };
  // m16 tiles tt0, tt0 + step, .. of chunk cc's region into buffer buf
  // (w1 and b1 of chunk cc loaded), two at a time (independent products
  // and stores in flight together)
  auto produce = [&](bf16* buf, int cc, int tt0, int step) {
    for (int tt = tt0; tt < NT; tt += 2 * step) {
      uint32_t a[2][4];
      int et[2][2];
      float cj[2][4][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int xrow = 16 * min(tt + u * step, NT - 1) + lane % 16;
        ldsm_x4(a[u], smem_addr(xa + (xrow / 8) * 128 + (lane / 16) * 64 +
                                (xrow % 8) * 8));
        // a second tile past the last is a copy of it, not stored
        const bool own = tt + u * step < NT;
        et[u][0] = own ? table[16 * (tt + u * step) + lane / 4] : -1;
        et[u][1] = own ? table[16 * (tt + u * step) + lane / 4 + 8] : -1;
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) cj[u][j][e] = 0.f;
          mma16816(cj[u][j], a[u], wb[j][0], wb[j][1]);
        }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* c = cj[u][j];
          const int ch = 8 * j + 2 * (lane % 4);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = et[u][h];
            if (e < 0) continue;
            float y0 = 0.f, y1 = 0.f;
            if (!(e & kZero)) {   // conv1 at this position: + b1, clip
              y0 = clip20(c[2 * h] + bb[j][0]);
              y1 = clip20(c[2 * h + 1] + bb[j][1]);
            }   // else: conv2's zero pad (h1 row T1 or column F1)
            *reinterpret_cast<__nv_bfloat162*>(buf + (e & ~kZero) * LDA +
                                               ch) =
                __floats2bfloat162_rn(y0, y1);
          }
        }
    }
  };

  // stage t = 9 cc + tap of this column tile: w2[tap, cc CK .., n0 ..]
  // swizzled (the wrapper's `conv_w2_stages`)
  const bf16* w2n = w2s + (long long)blockIdx.x * n_stages * kStage;
  __syncthreads();                   // barriers, im2col and table ready
  if (warp == kWarps) {              // the copy warp: every stage as soon
    if (lane == 0)                   // as its slot is free
      for (int t = 0; t < n_stages; ++t) {
        rg.wait_free(t);
        rg.load_b(t, ring + (t % S) * kStage, w2n + (long long)t * kStage,
                  kStage * (int)sizeof(bf16));
      }
    return;
  }
  if (warp > kWarps) {               // the conv1 warps: chunk cc's region
    for (int cc = 1; cc < nc; ++cc) {   // once its buffer is free
      if (cc >= 2) mbar_wait(reg_empty + (cc & 1), ((cc >> 1) - 1) & 1);
      load_w1(cc);
      produce(region + (cc & 1) * P_max * LDA, cc, warp - kWarps - 1,
              kConv1Warps);
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                       smem_addr(reg_full + (cc & 1)))
                   : "memory");
    }
    return;
  }
  // the consumer warps: chunk 0's region first
  load_w1(0);
  produce(region, 0, warp, kWarps);
  consumers_sync();

  // this lane's A row (warpgroup warp / 4 holds rows 64 (warp / 4) ..,
  // each warp 16 of them): its region position at tap (0, 0)
  const int a_row = 64 * (warp / 4) + 16 * (warp % 4) + lane % 16;
  const int a_m = min(m0 + a_row, rows - 1);
  const int a_pos = 2 * (a_m / tl.fw - tl.ta) * PW + a_m % tl.fw;
  const int a_col = (lane / 16) * 8;

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  // one tap: A (this warp's 16 rows x 32 channels) from the region into
  // registers a, two wgmma of 64 x BN x 16 a warpgroup; the registers of
  // a stay untouched until the products are done (the stages alternate
  // two sets), and the slot of stage s - 1 is released once its products
  // are done
  auto tap_step = [&](int s, uint32_t (&a)[2][4],
                      uint32_t (&a_prev)[2][4]) {
    const int cc = s / 9, tap = s % 9;
    if (tap == 0 && cc > 0)          // region cc is whole
      mbar_wait(reg_full + (cc & 1), ((cc - 1) >> 1) & 1);
    rg.wait(s);
    const bf16* reg = region + (cc & 1) * P_max * LDA;
    const int di = tap / 3, dj = tap % 3;
    const int pos = a_pos + di * PW + (dj == 1 ? HE : dj / 2);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      ldsm_x4(a[ks], smem_addr(reg + pos * LDA + 16 * ks + a_col));
    if (tap == 8) {                  // this warp is done with region cc
      __syncwarp();
      if (lane == 0)
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                         smem_addr(reg_empty + (cc & 1)))
                     : "memory");
    }
    const bf16* ws = ring + (s % S) * kStage;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      wgmma<BN>(acc, a[ks], b_desc(ws + 16 * ks));
    wgmma_commit();
    wgmma_wait<1>();                 // stage s - 1's products are done
    fence_a(a_prev);                 // (their A registers stay untouched
    if (s > 0) rg.release(s - 1);    // until here)
  };
  uint32_t a0[2][4] = {}, a1[2][4] = {};
  for (int s = 0; s < n_stages; s += 2) {
    tap_step(s, a0, a1);
    if (s + 1 < n_stages) tap_step(s + 1, a1, a0);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // + b2, clip, bf16, staged in shared memory [BM][BN + 8] (over the ring
  // and the regions), then 16-byte rows of h2 (window row t2 fw + j is h2
  // row (b T2 + t2) F2 + fa + j)
  consumers_sync();
  constexpr int SLD = BN + 8;
  bf16* st = reinterpret_cast<bf16*>(smem);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = 8 * j + 2 * (lane % 4);
    const float c0 = b2[n0 + n], c1 = b2[n0 + n + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = a_row - lane % 16 + lane / 4 + 8 * h;
      *reinterpret_cast<__nv_bfloat162*>(st + m * SLD + n) =
          __floats2bfloat162_rn(clip20(acc[4 * j + 2 * h] + c0),
                                clip20(acc[4 * j + 2 * h + 1] + c1));
    }
  }
  consumers_sync();
  for (int i = tid; i < BM * (BN / 8); i += kThreads) {
    const int m = i / (BN / 8), c = (i % (BN / 8)) * 8;
    const int mw = m0 + m;
    if (mw < rows) {
      const long long row = ((long long)b * T2 + mw / tl.fw) * F2 + tl.fa +
                            mw % tl.fw;
      *reinterpret_cast<uint4*>(h2 + row * d + n0 + c) =
          *reinterpret_cast<const uint4*>(st + m * SLD + c);
    }
  }
}

template <int BN>
constexpr size_t proj_smem() {
  return (size_t)kProjStages * (BM * LDA + CK * BN) * sizeof(bf16) +
         2 * kProjStages * sizeof(uint64_t);
}

// out [M, N] = A [M, K] @ wp + bias; wp staged by the wrapper
// (`proj_wp_stages`): stage t of column tile n0 / BN is wp[32 t .., n0 ..]
// in the 64-byte swizzle (at 512-byte aligned offsets of the ring). K a
// multiple of CK.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
stem_proj_kernel(const bf16* __restrict__ A, const bf16* __restrict__ wps,
                 const float* __restrict__ bias, int M, int K, int N,
                 int out_f32, void* __restrict__ out) {
  constexpr int kStage = BM * LDA + CK * BN;   // bf16: A [BM][LDA], then B
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + kProjStages * kStage);
  const Ring rg{bars, bars + kProjStages, kProjStages};
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_stages = K / CK, L = kProjStages - 2;
  const bf16* wpn = wps + (long long)blockIdx.x * n_stages * CK * BN;

  // every thread: its A copies of stage t; thread 0 also B's bulk copy
  auto load = [&](int t) {
    rg.wait_free(t);
    bf16* as = ring + (t % kProjStages) * kStage;
#pragma unroll
    for (int q = 0; q < BM * CK / 8 / kThreads; ++q) {
      const int i = tid + q * kThreads;
      const int r = i / (CK / 8), c = (i % (CK / 8)) * 8;
      const bool ok = m0 + r < M;
      copy16(as + r * LDA + c,
             A + (ok ? (long long)(m0 + r) * K + t * CK + c : 0), ok);
    }
    rg.arrive_copies(t);
    if (tid == 0)
      rg.load_b(t, as + BM * LDA, wpn + (long long)t * CK * BN,
                CK * BN * (int)sizeof(bf16));
  };
  rg.init(true);
  __syncthreads();
  for (int t = 0; t < L && t < n_stages; ++t) load(t);

  const int a_row = 64 * (warp / 4) + 16 * (warp % 4) + lane % 16;
  const int a_col = (lane / 16) * 8;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  auto k_step = [&](int s, uint32_t (&a)[2][4], uint32_t (&a_prev)[2][4]) {
    if (s + L < n_stages) load(s + L);
    rg.wait(s);
    const bf16* as = ring + (s % kProjStages) * kStage;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      ldsm_x4(a[ks], smem_addr(as + a_row * LDA + 16 * ks + a_col));
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      wgmma<BN>(acc, a[ks], b_desc(as + BM * LDA + 16 * ks));
    wgmma_commit();
    wgmma_wait<1>();
    fence_a(a_prev);
    if (s > 0) rg.release(s - 1);
  };
  uint32_t a0[2][4] = {}, a1[2][4] = {};
  for (int s = 0; s < n_stages; s += 2) {
    k_step(s, a0, a1);
    if (s + 1 < n_stages) k_step(s + 1, a1, a0);
  }
  wgmma_wait<0>();
  fence_acc(acc);

#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * (lane % 4);
    const float c0 = bias[n], c1 = bias[n + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + a_row - lane % 16 + lane / 4 + 8 * h;
      if (m >= M) continue;
      const float y0 = acc[4 * j + 2 * h] + c0;
      const float y1 = acc[4 * j + 2 * h + 1] + c1;
      const long long o = (long long)m * N + n;
      if (out_f32)
        *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
            make_float2(y0, y1);
      else
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + o) =
            __floats2bfloat162_rn(y0, y1);
    }
  }
}

template <int BN>
int conv_launch(const float* x, long long sx_b, long long sx_t,
                long long sx_f, const bf16* w1t, const float* b1,
                const bf16* w2s, const float* b2, bf16* h2, int B, int T,
                int F, int d, int NW, cudaStream_t stream) {
  constexpr size_t smem = conv_smem(BN, conv_stages(BN));
  cudaError_t err = cudaFuncSetAttribute(
      stem_conv_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  // tiles a window: those of the widest (the narrower skip their spare)
  const int F2 = F / 4, fw_max = F2 / NW + (F2 % NW > 0);
  const int tiles = ((T / 4) * fw_max + BM - 1) / BM;
  const dim3 grid(d / BN, NW * tiles, B);
  stem_conv_kernel<BN><<<grid, kConvThreads, smem, stream>>>(
      x, sx_b, sx_t, sx_f, w1t, b1, w2s, b2, h2, T, F, d, NW, tiles);
  return (int)cudaGetLastError();
}

template <int BN>
int proj_launch(const bf16* A, const bf16* wps, const float* bias, int M,
                int K, int N, int out_f32, void* out, cudaStream_t stream) {
  constexpr size_t smem = proj_smem<BN>();
  cudaError_t err = cudaFuncSetAttribute(
      stem_proj_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  stem_proj_kernel<BN><<<grid, kThreads, smem, stream>>>(A, wps, bias, M, K,
                                                         N, out_f32, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory of a stem_conv_kernel block at width d, in bytes: the
// same at every T and F.
extern "C" int stem_conv_smem(int d) {
  return (int)(d % 256 ? conv_smem(128, conv_stages(128))
                       : conv_smem(256, conv_stages(256)));
}

// The most f2 columns a window holds (the wrapper's NW = ceil(F2 / it)).
extern "C" int stem_window_max() { return kWindowMax; }

// conv1 + conv2: x [B, T, F] float32 (strides in elements), w1t [d, 16]
// bf16 (channel, tap 3 ki + kj; taps 9..15 zero), b1 [d] float32, w2s
// the staged w2 (`conv_w2_stages`), b2 [d] float32 -> h2 [B, T/4, F/4, d]
// bf16, in NW f2 windows of 2 .. kWindowMax columns. T, F multiples of 4,
// T, F >= 8, d a multiple of 128 up to 1024; w1t, w2s and h2 16-byte
// aligned.
extern "C" int stem_conv_launch(const float* x, long long sx_b,
                                long long sx_t, long long sx_f,
                                const bf16* w1t, const float* b1,
                                const bf16* w2s, const float* b2, bf16* h2,
                                int B, int T, int F, int d, int NW,
                                cudaStream_t stream) {
  if (T % 4 || F % 4 || T < 8 || F < 8 || d % 128 || d > 1024 || NW < 1 ||
      F / 4 / NW < 2 || F / 4 / NW + (F / 4 % NW > 0) > kWindowMax)
    return (int)cudaErrorInvalidValue;
  return d % 256 ? conv_launch<128>(x, sx_b, sx_t, sx_f, w1t, b1, w2s, b2,
                                    h2, B, T, F, d, NW, stream)
                 : conv_launch<256>(x, sx_b, sx_t, sx_f, w1t, b1, w2s, b2,
                                    h2, B, T, F, d, NW, stream);
}

// sub_proj: h2 [M, K] bf16 (M = B T2, K = F2 d) @ wp + bp [N] float32 ->
// out [M, N] float32 (out_f32) or bf16; wps the staged wp
// (`proj_wp_stages`). K a multiple of 32, N of 128; every pointer 16-byte
// aligned.
extern "C" int stem_proj_launch(const bf16* h2, const bf16* wps,
                                const float* bp, int M, int K, int N,
                                int out_f32, void* out, cudaStream_t stream) {
  if (K % CK || N % 128) return (int)cudaErrorInvalidValue;
  return N % 256 ? proj_launch<128>(h2, wps, bp, M, K, N, out_f32, out,
                                    stream)
                 : proj_launch<256>(h2, wps, bp, M, K, N, out_f32, out,
                                    stream);
}
