// Shared pieces of the banded Chebyshev-conv kernels: bf16 tensor-core
// fragments (WMMA 16x16x16, float32 accumulation) and the row-tile size.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace p2m {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

// Band tile height: the packed operator's (T, T) blocks.  One thread block
// owns one row tile; each of its 8 warps owns 16 rows of it.
constexpr int kT = 128;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Largest dynamic shared memory a block may use on sm_90 (227 KB).
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 to_bf(float v) { return __float2bfloat16(v); }

// acc[j] += a_rows (16 x K, row-major, ld lda) @ w[:, j*16 .. j*16+16)
// with w of leading dimension ldw.
template <int NJ>
__device__ __forceinline__ void rows_mma(FragC (&acc)[NJ], const bf16* a_rows, long lda,
                                         const bf16* w, long ldw, int K) {
  for (int kk = 0; kk < K; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a_rows + kk, lda);
    for (int j = 0; j < NJ; ++j) {
      FragB fb;
      wmma::load_matrix_sync(fb, w + (long)kk * ldw + j * 16, ldw);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
}

template <int NJ>
__device__ __forceinline__ void zero(FragC (&acc)[NJ]) {
  for (int j = 0; j < NJ; ++j) wmma::fill_fragment(acc[j], 0.0f);
}

// Store a warp's 16 x (NJ*16) accumulators to its float32 staging area
// (row-major, ld NJ*16) and make them visible to the whole warp.
template <int NJ>
__device__ __forceinline__ void stage(float* st, FragC (&acc)[NJ]) {
  for (int j = 0; j < NJ; ++j)
    wmma::store_matrix_sync(st + j * 16, acc[j], NJ * 16, wmma::mem_row_major);
  __syncwarp();
}

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
