// Pieces shared by the persistent recurrence kernels (the resident and
// streamed designs of rnn_scan.cu and lstm_scan.cu): 16-byte asynchronous
// copies, ldmatrix, mma.sync bf16, the step barrier between the blocks of
// a grid (or of one LSTM direction, or one block row of a streamed
// design), and the streamed designs' ring of K stages with its copy warp.
//
// Step barrier. Each call brings its own barrier words (`bar`: scratch
// from the caller, uninitialised). The prologue zeroes them (block 0) and
// ends in one grid-wide sync (cooperative groups), which publishes the
// zeros, h0 and the resident weights before any block arrives. Barrier k
// (k >= 1, after step k - 1) of the n blocks sharing a counter: every
// thread of a block reaches a block barrier; thread 0 fences and adds one
// to the counter (red.release.gpu), spins on it with ld.acquire.gpu until
// it reaches n k, and a block barrier lets the block's threads go on.
// Nothing outlives the call, so nothing is reset and two calls never share
// a word. The probe's -DGASR_PROBE_FLAGS build takes the other design: a
// flag a block (st.release.gpu of k), every flag polled by one thread of
// each block (scripts/torch_recurrence_probe.py times both).
//
// Memory order. What a block wrote before the barrier (h_t, as bf16 in the
// ping-pong buffer) is ordered before its release by the block barrier and
// the fence; a block that acquired the counter reads it after. Those reads
// go through cp.async.cg, which reads L2 and never L1, so no line of an
// earlier step cached in an SM's L1 can be read in its place.
//
// Co-residency: a block spins until every other block has arrived, so all
// of them must be resident at once. The kernels are launched cooperatively
// (cudaLaunchAttributeCooperative), which refuses a grid the card cannot
// hold at once rather than run it.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gasr {
namespace rec {

typedef __nv_bfloat16 bf16;

constexpr int kSmemMax = 232448;   // a block's shared memory on sm_90

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared through L2 (.cg); ok = false writes zeros and
// reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// the transposing forms: an 8 x 8 matrix stored k-major (rows k, units
// contiguous) gives mma16816's B fragment of those 8 k and 8 units
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, float32 sums
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
#ifndef GASR_PROBE_NO_MMA
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
#endif
}

// ldmatrix lane offsets (elements) of a 16 x 16 A tile (row-major, rows
// of a staged h chunk) and of two 8-row B tiles (W^T rows: units, k
// contiguous), as mma16816 takes them
__device__ __forceinline__ int a_row(int lane) {
  return (lane & 7) + 8 * ((lane >> 3) & 1);
}
__device__ __forceinline__ int a_col(int lane) { return 8 * (lane >> 4); }
__device__ __forceinline__ int b_row(int lane) {
  return (lane & 7) + 8 * (lane >> 4);
}
__device__ __forceinline__ int b_col(int lane) {
  return 8 * ((lane >> 3) & 1);
}

// h[0..3] rounded to bf16 into 8 bytes at p
__device__ __forceinline__ void store_bf16x4(bf16* p, const float* h) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(h[0], h[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(h[2], h[3]);
  uint2 pk;
  pk.x = *reinterpret_cast<uint32_t*>(&lo);
  pk.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = pk;
}

// mbarriers in shared memory and bulk copies (the tensor memory
// accelerator) into shared memory, counted by an mbarrier (the streamed
// designs' ring)
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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// bytes at src (contiguous, 16-byte aligned, a multiple of 16) into dst,
// counted by bar's transaction count; `arrive`: this copy also arrives
// (the phase's one arrival), else it only adds its bytes to the count
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar,
                                          bool arrive) {
  const uint32_t b = smem_addr(bar);
  if (arrive)
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
        "r"(bytes)
        : "memory");
  else
    asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(b),
                 "r"(bytes)
                 : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire_gpu(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_gpu(unsigned long long* p,
                                               unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// A wait at the step barrier longer than this (~20 s at the H100's clock)
// traps: the launch then fails with an error instead of hanging the card.
constexpr long long kWaitCycles = 1ll << 35;

// The two halves of a cluster barrier, to be called in turn by every
// thread of every block of the cluster: the arrive (release) can come as
// soon as the block is done with what its peers wait for, the wait
// (acquire) as late as the block needs theirs.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One thread: until the word reaches the target (acquire)
__device__ __forceinline__ void wait_word(const unsigned long long* word,
                                          unsigned long long target) {
  const long long t0 = clock64();
  while (ld_acquire_gpu(word) < target)
    if (clock64() - t0 > kWaitCycles) __trap();
}

// The call's prologue barrier: block 0 zeroes the `words` barrier words,
// then the whole grid meets (publishing the zeros and every block's
// prologue stores). Needs a cooperative launch.
__device__ __forceinline__ void prologue_barrier(unsigned long long* bar,
                                                 int words) {
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0)
    for (int i = threadIdx.x; i < words; i += blockDim.x) bar[i] = 0;
  __threadfence();
  cooperative_groups::this_grid().sync();
}

// Step barrier k >= 1 of the n blocks that share the counter at bar (the
// flags at bar[0, n) in the probe's flag build); this block is number `me`
// of them. Every thread of each block calls it.
__device__ __forceinline__ void step_barrier(unsigned long long* bar, int n,
                                             int me, int k) {
  __syncthreads();
#ifndef GASR_PROBE_NO_BARRIER
#ifdef GASR_PROBE_FLAGS
  if (threadIdx.x == 0) {
    __threadfence();
    st_release_gpu(bar + me, (unsigned long long)k);
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    wait_word(bar + i, (unsigned long long)k);
#else
  if (threadIdx.x == 0) {
    __threadfence();
    asm volatile("red.release.gpu.global.add.u64 [%0], 1;" ::"l"(bar)
                 : "memory");
    wait_word(bar, (unsigned long long)n * k);
  }
#endif
  __syncthreads();
#endif
}

// ---- The streamed designs (rnn_scan.cu's rnn_stream_kernel and
// lstm_scan.cu's lstm_stream_kernel): W_hh past shared-memory residency,
// rounded to bf16 once a call into a scratch that every step streams from
// L2 in K stages of KS rows.
//
// h_{t-1} lives in a ping-pong scratch whose slot is [Hp / KS][Bp][KS]: a
// K stage's rows of a batch tile contiguous (one bulk copy), the 16-byte
// chunk q of row r at q ^ (r % 8), so that ldmatrix reads the eight rows
// of a fragment without bank conflicts (KS = 64 or 128). Element (r, u):
__device__ __forceinline__ size_t h_index(int r, int u, int Bp, int KS) {
  const int k = u / KS, c = u % KS;
  return ((size_t)k * Bp + r) * KS + ((((c >> 3) ^ (r & 7)) << 3) | (c & 7));
}

// The consumer warps' barrier (named barrier 1; the copy warp does not
// take part)
template <int N>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
}

// h_t is written by generic stores and read by the next step's bulk copies
// (the async proxy): every writer fences the proxies before the block's
// release, and the copy thread fences them after its acquire.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// The ring of S stages in shared memory, each a W tile (w_bytes) then an
// h tile, counted by full (one arrival and the copies' bytes) and empty
// (one arrival a consumer warp) mbarriers.
struct Ring {
  unsigned char* base;
  size_t stage_bytes;
  uint32_t w_bytes, h_bytes;
  int S;
  uint64_t* full;
  uint64_t* empty;
  __device__ bf16* w(int slot) const {
    return reinterpret_cast<bf16*>(base + slot * stage_bytes);
  }
  __device__ bf16* h(int slot) const {
    return reinterpret_cast<bf16*>(base + slot * stage_bytes + w_bytes);
  }
  // thread 0, in the prologue (before the grid meets)
  __device__ void init(int consumer_warps) const {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, consumer_warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

// The copy warp's one thread: every K stage of every batch tile of every
// step into the ring, in the order the consumers take them. The block's
// W tiles: stage k at wsrc + k w_stage (elements); the h tiles: slot s % 2
// of hblk (slot_elems each, Bp rows), batch tile gb at rows gb MB. The
// block walks the batch tiles gb0, gb0 + gBr, .. < gB each step and K from
// its own first stage rot (then around, nk stages). At a step's first tile
// it issues the W copies of the first S stages (they need no h), waits at
// the step barrier (counter >= per_step s: every writer of these rows has
// written h_{t-1}), then issues the h copies.
__device__ __forceinline__ void stream_copies(
    const Ring& ring, const bf16* wsrc, size_t w_stage, const bf16* hblk,
    size_t slot_elems, int Bp, int MB, int KS, int nk, int rot, int T,
    int gb0, int gB, int gBr, const unsigned long long* counter,
    unsigned long long per_step) {
  fence_proxy_async();
  const int S = ring.S;
  // ring stage st (the call's running count) holds K stage k of a tile
  auto issue_w = [&](int st, int k) {
    const int slot = st % S, kr = (rot + k) % nk;
    if (st >= S) mbar_wait(ring.empty + slot, (st / S - 1) & 1);
#ifndef GASR_PROBE_NO_LOADS
    bulk_copy(ring.w(slot), wsrc + (size_t)kr * w_stage, ring.w_bytes,
              ring.full + slot, false);
#endif
  };
  auto issue_h = [&](int st, int k, const bf16* h_r, int gb) {
    const int slot = st % S, kr = (rot + k) % nk;
#ifndef GASR_PROBE_NO_LOADS
    bulk_copy(ring.h(slot), h_r + ((size_t)kr * Bp + (size_t)gb * MB) * KS,
              ring.h_bytes, ring.full + slot, true);
#else
    mbar_arrive(ring.full + slot);
#endif
  };
  int st = 0;
  for (int s = 0; s < T; ++s) {
    const bf16* h_r = hblk + (size_t)(s & 1) * slot_elems;
    for (int gb = gb0; gb < gB; gb += gBr) {
      const int pre = (gb == gb0 && s > 0) ? min(S, nk) : 0;
      for (int k = 0; k < pre; ++k) issue_w(st + k, k);   // no h needed
      if (pre > 0) {                 // the step barrier: h_{t-1} is whole
#ifndef GASR_PROBE_NO_BARRIER
        wait_word(counter, per_step * s);
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
}

// A consumer block's arrival at the step barrier of the streamed designs,
// after its h_t is written (every consumer thread calls it)
template <int N>
__device__ __forceinline__ void stream_arrive(unsigned long long* counter) {
  fence_proxy_async();               // h_t, for the next step's copies
  consumers_sync<N>();
  if (threadIdx.x == 0) {            // the block's arrival
    __threadfence();
#ifndef GASR_PROBE_NO_BARRIER
    asm volatile("red.release.gpu.global.add.u64 [%0], 1;" ::"l"(counter)
                 : "memory");
#endif
  }
}

// Probe builds (scripts/torch_recurrence_probe.py, -DGASR_PROBE_CLOCKS):
// thread 0 of every block adds the clock64() cycles of each phase of each
// step into the launch's `clocks` argument (kPhases + 1 zeroed words).
// Phases: the wait at the step barrier; the wait for the staged h; the
// products; (rnn_scan) the partial tiles' store and the cluster barrier;
// the epilogue (the cluster's sum or the LSTM cell, and the stores).
enum Phase { kWait = 0, kLoads = 1, kProducts = 2, kClusterSync = 3,
             kEpilogue = 4, kPhases = 5 };

struct Clock {
#ifdef GASR_PROBE_CLOCKS
  long long t, t0, acc[kPhases];
  __device__ void start() {
    t0 = t = clock64();
    for (int i = 0; i < kPhases; ++i) acc[i] = 0;
  }
  __device__ __forceinline__ void lap(int phase) {
    const long long now = clock64();
    acc[phase] += now - t;
    t = now;
  }
  // the phases' cycles into out[0, kPhases), the block's whole span into
  // out[kPhases]
  __device__ void flush(unsigned long long* out) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < kPhases; ++i)
        atomicAdd(out + i, (unsigned long long)acc[i]);
      atomicAdd(out + kPhases, (unsigned long long)(clock64() - t0));
    }
  }
#else
  __device__ void start() {}
  __device__ __forceinline__ void lap(int) {}
  __device__ void flush(unsigned long long*) {}
#endif
};

// A cooperative launch of `kernel` (one argument struct `args`) on a grid
// of `grid` blocks, `cluster` blocks to a cluster (1: none). Returns the
// launch's error: a grid that cannot be resident at once is refused.
template <typename Args>
inline cudaError_t launch_cooperative(void (*kernel)(Args), dim3 grid,
                                      int threads, size_t smem, int cluster,
                                      cudaStream_t stream, const Args& args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  int n = 1;
  if (cluster > 1) {
    attr[1].id = cudaLaunchAttributeClusterDimension;
    attr[1].val.clusterDim.x = cluster;
    attr[1].val.clusterDim.y = 1;
    attr[1].val.clusterDim.z = 1;
    n = 2;
  }
  cfg.attrs = attr;
  cfg.numAttrs = n;
  err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace rec
}  // namespace gasr
