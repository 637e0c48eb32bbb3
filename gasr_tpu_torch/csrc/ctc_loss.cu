// CTC loss on the card: the Graves forward recursion and its adjoint, one
// kernel each, one block per example.
//
// Replaces no Pallas kernel. The JAX package runs the recursion as XLA's
// `lax.scan` over frames (gasr_tpu/ops/ctc_loss.py:108) and takes its
// gradient with jax.grad through the scan; the port's plain version
// (ops/ctc_loss.py::ctc_loss_plain) repeats the scan as a T-step eager loop
// of ~30 small kernels a frame and takes autograd's gradient through it.
// This file computes the same two functions with the same float32
// expressions, in the same order:
//   alpha_0[k] = k < E ? init_k + e_0[k] : NEG
//   alpha_t[k] = k < E ? lse3(alpha_{t-1}[k], alpha_{t-1}[k-1],
//                             skip_k ? alpha_{t-1}[k-2] : NEG) + e_t[k] : NEG
//   loss       = -lse3(alpha_{T-1}[E-1], E >= 2 ? alpha_{T-1}[E-2] : NEG, NEG)
// lse3 is the plain version's `_logsumexp3` (each term below e^-80 of the
// largest dropped, + 1e-37, the result clamped at NEG = -1e30); z is the
// blank-interleaved label sequence of L = 2S + 1 states, E = 2
// label_length + 1, skip_k = (k odd and z_k != z_{k-2}), init_0 = 0,
// init_1 = 0 where label_length > 0, NEG elsewhere; e_t[k] =
// log_probs[t, b, z_k], or the deterministic blank (0 where z_k is the
// blank, NEG elsewhere) at t >= input_length. The gradient is the one
// autograd takes through those expressions: torch.maximum's gradient
// splits in half at ties (where every operand is NEG, in unreachable
// states), a term under the -80 floor gets none, padded frames and states
// k >= E get zero.
//
// Bound on the card: bytes, ~6 us at 3.35 TB/s for the training cell (T'
// = 300, B = 64, V = 129, S = 97): at most T B V floats of log_probs read
// (9.9 MB) and d loss / d log_probs written (9.9 MB). What limits the
// kernels is the chain of T frames in each example: a frame's states need
// the previous frame's, so each kernel is T steps of exp / log latency and
// one block barrier, with the examples' blocks side by side on the SMs.
//
// Design.
//   - One block per example, threads over the L states (a strided loop for
//     L above kMaxThreads), shared memory in proportion to L alone.
//   - The prologue builds z and the skip flags from the labels in the
//     block; a label the loss reads outside [0, V), or a label length
//     outside [0, S], makes the example's loss and gradient NaN.
//   - ctc_forward_kernel: the emissions e_t[k] are gathered from
//     log_probs through its strides (the model's [T, B, V] view is not
//     copied) by 4-byte cp.async copies into a ring of kStages frames,
//     kStages - 1 frames ahead of the recursion, so the chain does not
//     wait on device memory. alpha is double-buffered in shared memory,
//     one barrier a frame, and each frame's row is stored to alpha [B, T,
//     L] for the backward.
//   - ctc_backward_kernel: walks t = T-1 .. 1 with the rows of alpha
//     prefetched by the same ring, downwards. Each state recomputes lse3's
//     operands and takes its adjoint (Adj); the adjoints to the state's
//     own, previous and skip predecessor go to three arrays, ga, gb, gc,
//     double-buffered, and g_alpha_{t-1}[k] = ga[k] + gb[k+1] + gc[k+2]:
//     one barrier a frame, no atomics. The emissions' adjoints go to a
//     scratch ge [B, T, L]. Then the fold: each warp takes whole frames,
//     copies the frame's ge row into shared memory, sums the blank's
//     states by a fixed shuffle tree and each label's states along a chain
//     in increasing k (built in the prologue), and writes the frame's
//     gradient row: zeros, then the sums. The gradient is bit-identical
//     from run to run.
//   - Built with -fmad=false: products and sums round one by one, as the
//     plain version's separate tensor ops do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1.0e30f;
constexpr float kFloor = -80.0f;
constexpr float kTiny = 1e-37f;
constexpr int kStages = 8;        // frames in the cp.async ring
constexpr int kMaxThreads = 512;
constexpr int kSkip = 1;          // flags: skip_k
constexpr int kFirst = 2;         // flags: the first odd state of its label

// torch.maximum: the larger operand, NaN where either is NaN
__device__ __forceinline__ float mx(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// the share of g that torch.maximum's backward gives operand x against y:
// all of it above, half at a tie, none below
__device__ __forceinline__ float share(float x, float y, float g) {
  return x < y ? 0.f : (x == y ? g * 0.5f : g);
}

// a term of _logsumexp3: exp(d) * (d > -80)
__device__ __forceinline__ float term(float d) {
  return d > kFloor ? expf(d) : 0.f;
}

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = mx(mx(a, b), c);
  const float ms = mx(m, kNeg);
  const float s = ((term(a - ms) + term(b - ms)) + term(c - ms)) + kTiny;
  return mx(m + logf(s), kNeg);
}

struct Adj {
  float a, b, c;
};

// the adjoints of lse3(a, b, c)'s operands for the adjoint g of its result
__device__ __forceinline__ Adj lse3_adjoint(float a, float b, float c,
                                            float g) {
  const float ab = mx(a, b);
  const float m = mx(ab, c);
  const float ms = mx(m, kNeg);
  const float ea = term(a - ms), eb = term(b - ms), ec = term(c - ms);
  const float s = ((ea + eb) + ec) + kTiny;
  const float gout = share(m + logf(s), kNeg, g);
  const float gs = gout / s;
  const float gda = gs * ea, gdb = gs * eb, gdc = gs * ec;
  const float gm = gout + share(m, kNeg, (-gda - gdb) - gdc);
  const float gab = share(ab, c, gm);
  return {gda + share(a, b, gab), gdb + share(b, a, gab),
          gdc + share(c, ab, gm)};
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// z and the skip flags of the L states of one example (lab: its S
// labels); false for every thread where the example is out of range.
// Ends in a block barrier.
__device__ bool states(const int* __restrict__ lab, int S, int V, int blank,
                       int ll, int* z, int* flags) {
  const int L = 2 * S + 1;
  bool bad = ll < 0 || ll > S;
  const int E = bad ? 0 : 2 * ll + 1;
  for (int k = threadIdx.x; k < L; k += blockDim.x) {
    int zk = blank, f = 0;
    if (k & 1) {
      zk = lab[k >> 1];
      if (k < 2 || zk != lab[(k >> 1) - 1]) f = kSkip;
      if (k < E && (zk < 0 || zk >= V)) bad = true;
    }
    z[k] = zk;
    flags[k] = f;
  }
  return !__syncthreads_or(bad);
}

__global__ void __launch_bounds__(kMaxThreads)
ctc_forward_kernel(const float* __restrict__ lp, long long st, long long sb,
                   long long sv, const int* __restrict__ labels,
                   const int* __restrict__ in_len,
                   const int* __restrict__ lab_len, int T, int V, int S,
                   int blank, float* __restrict__ alpha,
                   float* __restrict__ loss) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int L = 2 * S + 1;
  float* A = smem;                                       // [2][L]
  float* ring = A + 2 * L;                               // [kStages][L]
  int* z = reinterpret_cast<int*>(ring + kStages * L);   // [L]
  int* flags = z + L;                                    // [L]
  const int ll = lab_len[b];
  if (!states(labels + (size_t)b * S, S, V, blank, ll, z, flags)) {
    if (tid == 0) loss[b] = nanf("");
    return;
  }
  const int E = 2 * ll + 1;
  const int nreal = min(in_len[b], T);   // frames read from log_probs
  const float* lpb = lp + b * sb;
  float* ab = alpha + (size_t)b * T * L;

  // frame t's emissions into the ring (one commit group a frame, empty
  // past the real frames)
  auto fetch = [&](int t) {
    if (t < nreal) {
      float* dst = ring + (t % kStages) * L;
      const float* row = lpb + t * st;
      for (int k = tid; k < E; k += nt) copy4(dst + k, row + z[k] * sv);
    }
    commit();
  };
  for (int t = 0; t < kStages - 1; ++t) fetch(t);

  float* cur = A;
  float* nxt = A + L;
  for (int t = 0; t < T; ++t) {
    wait_group<kStages - 2>();      // frame t's copies (this thread's)
    __syncthreads();                // everyone's; cur complete
    fetch(t + kStages - 1);         // into frame t-1's stage, now free
    const float* e_row = ring + (t % kStages) * L;
    const bool real = t < nreal;
    for (int k = tid; k < L; k += nt) {
      float v = kNeg;
      if (k < E) {
        const float e = real ? e_row[k] : (z[k] == blank ? 0.f : kNeg);
        if (t == 0) {
          v = (k < 2 ? 0.f : kNeg) + e;
        } else {
          const float c = (k >= 2 && (flags[k] & kSkip)) ? cur[k - 2] : kNeg;
          v = lse3(cur[k], k >= 1 ? cur[k - 1] : kNeg, c) + e;
        }
      }
      nxt[k] = v;
      ab[(size_t)t * L + k] = v;
    }
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  wait_group<0>();
  __syncthreads();
  if (tid == 0)
    loss[b] = -lse3(cur[E - 1], E >= 2 ? cur[E - 2] : kNeg, kNeg);
}

__global__ void __launch_bounds__(kMaxThreads)
ctc_backward_kernel(const float* __restrict__ alpha,
                    const int* __restrict__ labels,
                    const int* __restrict__ in_len,
                    const int* __restrict__ lab_len,
                    const float* __restrict__ gloss, long long sg, int T,
                    int V, int S, int blank, float* __restrict__ ge,
                    float* __restrict__ grad, long long st, long long sb,
                    long long sv) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float g_last[2];
  __shared__ int blank_chain;     // the first odd state whose label is blank
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid % 32, warp = tid / 32;
  const int L = 2 * S + 1;
  float* G = smem;                                       // [2][3][L]
  float* ring = G + 6 * L;                               // [kStages][L]
  int* z = reinterpret_cast<int*>(ring + kStages * L);   // [L]
  int* flags = z + L;                                    // [L]
  int* next = flags + L;                                 // [L]
  float* gbo = grad + b * sb;
  const int ll = lab_len[b];
  if (tid == 0) blank_chain = -1;
  if (!states(labels + (size_t)b * S, S, V, blank, ll, z, flags)) {
    for (long long i = tid; i < (long long)T * V; i += nt)
      gbo[(i / V) * st + (i % V) * sv] = nanf("");
    return;
  }
  const int E = 2 * ll + 1;
  const int nreal = max(min(in_len[b], T), 0);
  const float* ab = alpha + (size_t)b * T * L;
  float* geb = ge + (size_t)b * T * L;

  // each label's odd states as a chain in increasing k
  for (int k = 1 + 2 * tid; k < E; k += 2 * nt) {
    const int zk = z[k];
    int nk = -1;
    for (int j = k + 2; j < E; j += 2)
      if (z[j] == zk) {
        nk = j;
        break;
      }
    next[k] = nk;
    bool first = true;
    for (int j = k - 2; j > 0; j -= 2)
      if (z[j] == zk) {
        first = false;
        break;
      }
    if (first) {
      flags[k] |= kFirst;
      if (zk == blank) blank_chain = k;
    }
  }
  // the closing logsumexp's adjoint, from -d loss
  if (tid == 0) {
    const float* last = ab + (size_t)(T - 1) * L;
    const Adj j = lse3_adjoint(last[E - 1], E >= 2 ? last[E - 2] : kNeg, kNeg,
                               -gloss[b * sg]);
    g_last[0] = j.a;
    g_last[1] = E >= 2 ? j.b : 0.f;
  }

  // alpha row r into the ring (one commit group a row, empty below 0)
  auto fetch = [&](int r) {
    if (r >= 0) {
      float* dst = ring + (r % kStages) * L;
      const float* row = ab + (size_t)r * L;
      for (int k = tid; k < E; k += nt) copy4(dst + k, row + k);
    }
    commit();
  };
  for (int i = 0; i < kStages - 1; ++i) fetch(T - 2 - i);
  __syncthreads();
  for (int k = tid; k < L; k += nt) {
    G[k] = k == E - 1 ? g_last[0] : (k == E - 2 ? g_last[1] : 0.f);
    G[L + k] = 0.f;
    G[2 * L + k] = 0.f;
  }

  // g_alpha_t[k], masked to the valid states, from buffer q
  auto adjoint_in = [&](const float* q, int k) {
    if (k >= E) return 0.f;
    return (q[k] + (k + 1 < L ? q[L + k + 1] : 0.f)) +
           (k + 2 < L ? q[2 * L + k + 2] : 0.f);
  };
  int q = 0;
  for (int t = T - 1; t >= 1; --t) {
    wait_group<kStages - 2>();      // row t-1's copies (this thread's)
    __syncthreads();                // everyone's; buffer q complete
    fetch(t - kStages);             // into row t's stage, now free
    const float* row = ring + ((t - 1) % kStages) * L;
    const float* gq = G + q * 3 * L;
    float* gn = G + (1 - q) * 3 * L;
    for (int k = tid; k < L; k += nt) {
      const float g = adjoint_in(gq, k);
      geb[(size_t)t * L + k] = g;
      float oa = 0.f, ob = 0.f, oc = 0.f;
      if (k < E) {
        const bool skip = k >= 2 && (flags[k] & kSkip);
        const Adj j = lse3_adjoint(row[k], k >= 1 ? row[k - 1] : kNeg,
                                   skip ? row[k - 2] : kNeg, g);
        oa = j.a;
        ob = k >= 1 ? j.b : 0.f;
        oc = skip ? j.c : 0.f;
      }
      gn[k] = oa;
      gn[L + k] = ob;
      gn[2 * L + k] = oc;
    }
    q = 1 - q;
  }
  wait_group<0>();
  __syncthreads();
  for (int k = tid; k < L; k += nt) geb[k] = adjoint_in(G + q * 3 * L, k);
  __syncthreads();

  // the fold, a warp a frame: d log_probs[t, b, :] from ge[t, :E], in a
  // row of the ring and adjoint buffers (free now; 14 L floats)
  const int warps = min(nt / 32, 14);
  if (warp >= warps) return;
  float* g = smem + warp * L;
  for (int t = warp; t < T; t += warps) {
    float* out = gbo + t * st;
    if (t >= nreal) {
      for (int v = lane; v < V; v += 32) out[v * sv] = 0.f;
      continue;
    }
    const float* src = geb + (size_t)t * L;
    for (int k = lane; k < E; k += 32) g[k] = src[k];
    __syncwarp();
    // the blank: its even states, each lane's in increasing k, then a
    // fixed tree over the lanes, then its odd states (labels equal to the
    // blank) in increasing k
    float sum = 0.f;
    for (int k = 2 * lane; k < E; k += 64) sum += g[k];
    for (int o = 16; o > 0; o /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int k = blank_chain; k >= 0; k = next[k]) sum += g[k];
    for (int v = lane; v < V; v += 32) out[v * sv] = v == blank ? sum : 0.f;
    __syncwarp();
    // each other label present: its odd states in increasing k
    for (int k = 1 + 2 * lane; k < E; k += 64) {
      if (!(flags[k] & kFirst) || z[k] == blank) continue;
      float s = g[k];
      for (int j = next[k]; j >= 0; j = next[j]) s += g[j];
      out[z[k] * sv] = s;
    }
    __syncwarp();
  }
}

size_t forward_smem(int L) { return (size_t)(2 + kStages) * L * 4 + 2 * L * 4; }
size_t backward_smem(int L) { return (size_t)(6 + kStages) * L * 4 + 3 * L * 4; }

int threads(int L) { return min((L + 31) / 32 * 32, kMaxThreads); }

template <typename K>
cudaError_t opt_in(K kernel, size_t smem) {
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)most) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

// log_probs [T, B, V] float32 with element strides (st, sb, sv); labels
// [B, S] int32, contiguous; in_len, lab_len [B] int32; alpha [B, T, 2S+1]
// float32 out; loss [B] float32 out. T >= 1, S >= 1, 0 <= blank < V.
extern "C" int ctc_forward_launch(const float* lp, long long st, long long sb,
                                  long long sv, const int* labels,
                                  const int* in_len, const int* lab_len,
                                  int T, int B, int V, int S, int blank,
                                  float* alpha, float* loss,
                                  cudaStream_t stream) {
  if (T < 1 || S < 1 || B < 1 || blank < 0 || blank >= V)
    return (int)cudaErrorInvalidValue;
  const int L = 2 * S + 1;
  const size_t smem = forward_smem(L);
  cudaError_t err = opt_in(ctc_forward_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  ctc_forward_kernel<<<B, threads(L), smem, stream>>>(
      lp, st, sb, sv, labels, in_len, lab_len, T, V, S, blank, alpha, loss);
  return (int)cudaGetLastError();
}

// alpha, labels, in_len, lab_len as the forward left them; gloss [B]
// float32 with element stride sg (d total / d loss); ge [B, T, 2S+1]
// float32 scratch; grad [T, B, V] float32 out with element strides (st,
// sb, sv), every element written.
extern "C" int ctc_backward_launch(const float* alpha, const int* labels,
                                   const int* in_len, const int* lab_len,
                                   const float* gloss, long long sg, int T,
                                   int B, int V, int S, int blank, float* ge,
                                   float* grad, long long st, long long sb,
                                   long long sv, cudaStream_t stream) {
  if (T < 1 || S < 1 || B < 1 || blank < 0 || blank >= V)
    return (int)cudaErrorInvalidValue;
  const int L = 2 * S + 1;
  const size_t smem = backward_smem(L);
  cudaError_t err = opt_in(ctc_backward_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  ctc_backward_kernel<<<B, threads(L), smem, stream>>>(
      alpha, labels, in_len, lab_len, gloss, sg, T, V, S, blank, ge, grad, st,
      sb, sv);
  return (int)cudaGetLastError();
}
