// Standalone exact stable top-k over rows, k <= 128: the block top-W of
// topk.cuh (see there for what it replaces, its bound and its design) as
// a kernel of its own, one block per row, so the chip check can hold it
// against its plain PyTorch version at the decode's shape ([256, 4700],
// k=100).
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk.cuh"

namespace {

constexpr int kThreads = 512;   // 16 warps: a power of two (block_top128)

__global__ void __launch_bounds__(kThreads)
topk_kernel(const float* __restrict__ x, int n, int k,
            float* __restrict__ vals, int* __restrict__ idx) {
  __shared__ unsigned long long lists[(kThreads / 32) * gasr::kListLen];
  const float* row = x + (size_t)blockIdx.x * n;
  gasr::block_top128(
      [&](int i) { return gasr::topk_key(row[i], (uint32_t)i); }, n, lists);
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const unsigned long long key = lists[j];
    vals[(size_t)blockIdx.x * k + j] = gasr::key_value(key);
    idx[(size_t)blockIdx.x * k + j] = (int)gasr::key_index(key);
  }
}

}  // namespace

extern "C" int topk_launch(const float* x, int rows, int n, int k,
                           float* vals, int* idx, cudaStream_t stream) {
  if (k < 1 || k > gasr::kListLen || k > n) return (int)cudaErrorInvalidValue;
  topk_kernel<<<rows, kThreads, 0, stream>>>(x, n, k, vals, idx);
  return (int)cudaGetLastError();
}
