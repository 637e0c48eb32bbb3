// Whole-scan CTC prefix beam-search decode, and its backpointer traceback.
//
// fused_prefix_decode replaces gasr_tpu/ops/pallas/fused_decode.py::
// fused_prefix_decode (`_kernel`, `_frame_math`); traceback replaces
// fused_decode.py::traceback_pallas (`_tb_kernel(fused=False)`). Both are
// held equal to the eager matched-merge decoder of
// gasr_tpu_torch/decoder/beam_search.py, whose expressions they copy one
// for one (built with -fmad=false so that no product is fused into a
// following sum that PyTorch computes as a separate op).
//
// Decode. Bound on the card: the data are small (log_probs in, 9.6 MB at
// T=200, B=256, V=47; ys out, 20.5 MB) and the arithmetic per frame is
// ~W*V adds and compares, so neither bytes nor operations bound it; what
// does is the serial chain per utterance: T frames, each a few
// block-wide phases separated by __syncthreads. Design: one thread block
// per utterance runs the whole T loop; the beam state (h1, h2, hp1, hp2,
// last, length, live, s1, s2) lives in shared memory across all frames
// and is never written to device memory until the end; the candidate grid
// is never stored at all: the block top-W of topk.cuh builds each
// candidate's key in registers as it sorts (about 9 barriers per frame in
// all); B blocks run side by side to fill the SMs. Per frame:
//   1. the frame's log-probs row into shared memory; per slot the total
//      score, f[last] and the folded match key k2 = 31*h2 + length;
//   2. per stay slot w', the first live w with h1[w] == hp1[w'] and
//      k2[w] == 31*hp2[w'] + length[w'] - 1 (W x W compare), the stay
//      candidate's scores, and a flag on the extend (w, last[w']) that
//      the stay absorbs (its prefix is already in the beam: DEAD);
//   3. the block top-W of the W x V candidates;
//   4. gathers, hash updates and the packed backpointer
//      parent | char<<15 | appended<<30 into ys[t, b, :].
// Redesign for later: the W x W match through a shared hash table, and
// fewer block phases per frame.
//
// Traceback. Bound on the card: bytes (ys read, 20.5 MB; tokens and
// timesteps written, 52 MB at L=256). Design: the -1 fill of both outputs
// is a coalesced memset; then one thread per (b, w) walks t = T-1..0,
// reading one ys word per frame and writing each emission at position
// pos-1 (dropped when < 0 or >= L: head-keeping on overflow).
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk.cuh"

namespace {

constexpr float kNegInf = -1.0e30f;   // beam_search.NEG_INF
constexpr float kDead = -3.0e38f;     // beam_search.DEAD_KEY_LOG
constexpr float kLiveMin = -1.5e38f;  // DEAD_KEY_LOG * 0.5
constexpr uint32_t kM1 = 1000003u;
constexpr uint32_t kM2 = 16777619u;
constexpr int kThreads = 512;   // 16 warps: a power of two (block_top128)

// packed state field order (ops/cuda/fused_decode.py FIELDS)
enum { F_H1, F_H2, F_HP1, F_HP2, F_LAST, F_LEN, F_LIVE, F_S1, F_S2, NF };

// beam_search._logaddexp, expression for expression
__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  const float lo = fminf(a, b);
  const float d = lo - m;
  const float e = __fmul_rn(expf(fmaxf(d, -80.0f)), d > -80.0f ? 1.0f : 0.0f);
  return m + log1pf(e);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__global__ void __launch_bounds__(kThreads, 2)
fused_prefix_decode_kernel(const float* __restrict__ lp,
                           const int* __restrict__ init, int T, int B, int W,
                           int V, int blank, int* __restrict__ ys,
                           int* __restrict__ fin) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* lists = smem;                   // [16][kListLen]
  int* st = reinterpret_cast<int*>(lists + (kThreads / 32) * gasr::kListLen);
                                                      // [NF][W]
  float* frow = reinterpret_cast<float*>(st + NF * W);  // [V]
  float* total = frow + V;                            // [W]
  float* flast = total + W;                           // [W]
  float* spb = flast + W;                             // [W] stay p_blank
  float* spnb = spb + W;                              // [W] stay p_nonblank
  float* sscore = spnb + W;                           // [W] stay score
  uint32_t* k2 = reinterpret_cast<uint32_t*>(sscore + W);  // [W]
  uint8_t* excl = reinterpret_cast<uint8_t*>(k2 + W);  // [W*V] absorbed

  uint32_t* h1 = reinterpret_cast<uint32_t*>(st + F_H1 * W);
  uint32_t* h2 = reinterpret_cast<uint32_t*>(st + F_H2 * W);
  uint32_t* hp1 = reinterpret_cast<uint32_t*>(st + F_HP1 * W);
  uint32_t* hp2 = reinterpret_cast<uint32_t*>(st + F_HP2 * W);
  int* last = st + F_LAST * W;
  int* len = st + F_LEN * W;
  int* live = st + F_LIVE * W;
  float* s1 = reinterpret_cast<float*>(st + F_S1 * W);
  float* s2 = reinterpret_cast<float*>(st + F_S2 * W);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int N = W * V;

  for (int i = tid; i < NF * W; i += blockDim.x) {
    const int f = i / W, w = i - f * W;
    st[i] = init[((size_t)f * B + b) * W + w];
  }
  for (int i = tid; i < N; i += blockDim.x) excl[i] = 0;
  int my_excl = -1;   // the extend flag this thread (stay slot) raised

  for (int t = 0; t < T; ++t) {
    // ---- 1. frame row; per-slot totals and match keys
    const float* f = lp + ((size_t)t * B + b) * V;
    for (int v = tid; v < V; v += blockDim.x) frow[v] = f[v];
    __syncthreads();
    if (tid < W) {
      total[tid] = logaddexp(s1[tid], s2[tid]);
      flast[tid] = frow[clampi(last[tid], 0, V - 1)];
      k2[tid] = h2[tid] * 31u + (uint32_t)len[tid];
    }
    __syncthreads();

    // ---- 2. parent match and stay candidates (thread = stay slot w')
    if (tid < W) {
      const int wp = tid;
      int m = -1;
      if (live[wp]) {
        const uint32_t want1 = hp1[wp];
        const uint32_t want2 = hp2[wp] * 31u + (uint32_t)(len[wp] - 1);
        for (int w = 0; w < W; ++w) {
          if (live[w] && h1[w] == want1 && k2[w] == want2) {
            m = w;
            break;
          }
        }
      }
      const float fl = flast[wp];
      const float stay_pb = total[wp] + frow[blank];
      float stay_pnb = len[wp] > 0 ? s2[wp] + fl : kNegInf;
      float ext_contrib = kNegInf;
      if (m >= 0) {
        const float base = last[m] == last[wp] ? s1[m]
                                               : logaddexp(s1[m], s2[m]);
        ext_contrib = base + fl;
      }
      stay_pnb = logaddexp(stay_pnb, ext_contrib);
      spb[wp] = stay_pb;
      spnb[wp] = stay_pnb;
      sscore[wp] = live[wp] ? logaddexp(stay_pb, stay_pnb) : kDead;
      if (m >= 0) {
        // the extend (m, last[w']) is this stay's own prefix: excluded
        const int v = clampi(last[wp], 0, V - 1);
        if (v != blank) {
          my_excl = m * V + v;
          excl[my_excl] = 1;
        }
      }
    }
    __syncthreads();

    // ---- 3. stable top-W of the W x V candidate grid
    auto key_of = [&](int i) {
      const int w = i / V, v = i - w * V;
      float c;
      if (v == blank) {
        c = sscore[w];
      } else if (live[w] && !excl[i]) {
        c = (v == last[w] ? s1[w] : total[w]) + frow[v];
      } else {
        c = kDead;
      }
      return gasr::topk_key(c, (uint32_t)i);
    };
    gasr::block_top128(key_of, N, lists);

    // ---- 4. state update for slot k = tid
    uint32_t n_h1 = 0, n_h2 = 0, n_hp1 = 0, n_hp2 = 0;
    int n_last = 0, n_len = 0, n_live = 0;
    float n_s1 = 0.f, n_s2 = 0.f;
    if (tid < W) {
      const unsigned long long key = lists[tid];
      const int idx = (int)gasr::key_index(key);
      const float top = gasr::key_value(key);
      const int w = idx / V, v = idx - w * V;
      const bool stay = v == blank;
      const bool nl = top > kLiveMin;
      const uint32_t vp1 = (uint32_t)(v + 1);
      const float ext_pnb = (v == last[w] ? s1[w] : total[w]) + frow[v];
      n_h1 = stay ? h1[w] : h1[w] * kM1 + vp1;
      n_h2 = stay ? h2[w] : h2[w] * kM2 + vp1;
      n_hp1 = stay ? hp1[w] : h1[w];
      n_hp2 = stay ? hp2[w] : h2[w];
      n_last = stay ? last[w] : v;
      n_len = len[w] + (stay ? 0 : 1);
      n_live = nl ? 1 : 0;
      n_s1 = (nl && stay) ? spb[w] : kNegInf;
      n_s2 = nl ? (stay ? spnb[w] : ext_pnb) : kNegInf;
      const int appended = (!stay && nl) ? 1 : 0;
      ys[((size_t)t * B + b) * W + tid] =
          w | ((n_last > 0 ? n_last : 0) << 15) | (appended << 30);
      if (my_excl >= 0) excl[my_excl] = 0;   // no reader until next frame
      my_excl = -1;
    }
    __syncthreads();
    if (tid < W) {
      h1[tid] = n_h1;
      h2[tid] = n_h2;
      hp1[tid] = n_hp1;
      hp2[tid] = n_hp2;
      last[tid] = n_last;
      len[tid] = n_len;
      live[tid] = n_live;
      s1[tid] = n_s1;
      s2[tid] = n_s2;
    }
    __syncthreads();
  }

  for (int i = tid; i < NF * W; i += blockDim.x) {
    const int f = i / W, w = i - f * W;
    fin[((size_t)f * B + b) * W + w] = st[i];
  }
}

__global__ void traceback_kernel(const int* __restrict__ ys,
                                 const int* __restrict__ lengths, int T,
                                 int B, int W, int L, int* __restrict__ tok,
                                 int* __restrict__ ts,
                                 int* __restrict__ start_parent) {
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= B * W) return;
  const int b = gid / W;
  int* trow = tok + (size_t)gid * L;
  int* srow = ts + (size_t)gid * L;
  int cur = gid - b * W;
  int pos = lengths[gid];
  for (int t = T - 1; t >= 0; --t) {
    const int packed = ys[((size_t)t * B + b) * W + cur];
    const int appended = (packed >> 30) & 1;
    if (appended) {
      const int e = pos - 1;
      if (e >= 0 && e < L) {
        trow[e] = (packed >> 15) & 0x7FFF;
        srow[e] = t;
      }
      pos -= 1;
    }
    cur = packed & 0x7FFF;
  }
  start_parent[gid] = cur;
}

}  // namespace

extern "C" int fused_prefix_decode_launch(const float* lp, const int* init,
                                          int T, int B, int W, int V,
                                          int blank, int* ys, int* fin,
                                          cudaStream_t stream) {
  const size_t smem =
      (size_t)(kThreads / 32) * gasr::kListLen * sizeof(unsigned long long) +
      (size_t)(NF * W + V + 6 * W) * sizeof(int) + (size_t)W * V;
  cudaError_t err = cudaFuncSetAttribute(
      fused_prefix_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_prefix_decode_kernel<<<B, kThreads, smem, stream>>>(
      lp, init, T, B, W, V, blank, ys, fin);
  return (int)cudaGetLastError();
}

extern "C" int traceback_launch(const int* ys, const int* lengths, int T,
                                int B, int W, int L, int* tok, int* ts,
                                int* start_parent, cudaStream_t stream) {
  const size_t bytes = (size_t)B * W * L * sizeof(int);
  cudaError_t err = cudaMemsetAsync(tok, 0xFF, bytes, stream);  // -1 fill
  if (err == cudaSuccess) err = cudaMemsetAsync(ts, 0xFF, bytes, stream);
  if (err != cudaSuccess) return (int)err;
  const int threads = 128;
  const int blocks = (B * W + threads - 1) / threads;
  traceback_kernel<<<blocks, threads, 0, stream>>>(ys, lengths, T, B, W, L,
                                                   tok, ts, start_parent);
  return (int)cudaGetLastError();
}
