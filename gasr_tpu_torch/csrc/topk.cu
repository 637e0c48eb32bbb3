// Standalone exact stable top-k over rows, k <= 128: the filtered top-W of
// topk.cuh (select_seed, select_walk, select_rank; see there for what it
// replaces, its bound and its design), the selection every decode kernel
// runs each frame, as a kernel of its own, one block per row, so the chip
// check can hold it against its plain PyTorch version at the decode's
// shape ([256, 4700], k=100). Every cell of a row is a real candidate, so
// the seed asks for k maxima: c = ceil(k / warps).
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk.cuh"

namespace {

constexpr int kThreads = 512;   // 16 warps, as the decode kernels
constexpr int kWarps = kThreads / 32;
constexpr int kR = 4;           // 32 * kR >= k: a list of 128 keys a warp

__global__ void __launch_bounds__(kThreads)
topk_kernel(const float* __restrict__ x, int n, int k,
            float* __restrict__ vals, int* __restrict__ idx) {
  __shared__ unsigned long long scratch[(gasr::select_bytes(kWarps) + 7) / 8];
  gasr::Select sel;
  gasr::carve_select(scratch, kWarps, &sel);
  const float* row = x + (size_t)blockIdx.x * n;
  float* vrow = vals + (size_t)blockIdx.x * k;
  int* irow = idx + (size_t)blockIdx.x * k;
  // one row: cell (0, j) is element j
  gasr::select_seed([&](int, int j) { return gasr::monotone_bits(row[j]); },
                    n, n, (k + kWarps - 1) / kWarps, sel);
  __syncthreads();
  gasr::select_walk<kR>(
      [&](int i, int, int) { return gasr::topk_key(row[i], (uint32_t)i); },
      n, n, k, sel);
  __syncthreads();
  gasr::select_rank<kWarps, kR>(k, sel, [&](int r, unsigned long long key) {
    vrow[r] = gasr::key_value(key);
    irow[r] = (int)gasr::key_index(key);
  });
}

}  // namespace

extern "C" int topk_launch(const float* x, int rows, int n, int k,
                           float* vals, int* idx, cudaStream_t stream) {
  if (k < 1 || k > gasr::kListLen || k > n) return (int)cudaErrorInvalidValue;
  topk_kernel<<<rows, kThreads, 0, stream>>>(x, n, k, vals, idx);
  return (int)cudaGetLastError();
}
