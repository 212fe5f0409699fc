// Shared pieces of the banded Chebyshev-conv kernels: the bf16 type, the
// row-tile size and the block shape.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace p2m {

using bf16 = __nv_bfloat16;

// Band tile height: the packed operator's (T, T) blocks.  One thread block
// owns one row tile; each of its 8 warps owns 16 rows of it.
constexpr int kT = 128;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// Largest dynamic shared memory a block may use on sm_90 (227 KB).
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

}  // namespace p2m

// In the source file's own unnamed namespace (the same one its kernels use):
// a kernel in a second, nested unnamed namespace makes nvcc's host stubs
// ambiguous.
namespace {

// out[i] = sum over p < P of part[p * n + i], added in the order of p: the
// second, deterministic pass over per-block partial sums (no atomics).
__global__ void reduce_partials(const float* __restrict__ part, int P, int n,
                                float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int p = 0; p < P; ++p) s += part[(long)p * n + i];
  out[i] = s;
}

inline cudaError_t launch_reduce(const float* part, int P, int n, float* out,
                                 cudaStream_t stream) {
  reduce_partials<<<(n + 255) / 256, 256, 0, stream>>>(part, P, n, out);
  return cudaGetLastError();
}

}  // namespace
