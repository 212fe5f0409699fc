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

// acc[j] += band_rows (16 x T, row-major, ld kT) @ src[:, j*16 .. j*16+16)
// for j < NJ, where src is T rows of leading dimension ld.
template <int NJ>
__device__ __forceinline__ void band_rows_mma(FragC (&acc)[NJ], const bf16* band_rows,
                                              const bf16* src, long ld) {
  for (int kk = 0; kk < kT; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, band_rows + kk, kT);
    for (int j = 0; j < NJ; ++j) {
      FragB fb;
      wmma::load_matrix_sync(fb, src + (long)kk * ld + j * 16, ld);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
}

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

// ---- training kernels: real-row (V, B, C) layout, V <= nt * T ----------------

// Stage rows (t-2k)*T .. (t+2k+1)*T - 1, channels [c0, c0+FC) of a vertex-major
// tensor (row v at src + v*ld) into dst (4k+1, T, FC), by the whole block.  Rows
// outside [0, V) and channels >= C read as zero.  With fold_s, an element becomes
// relu(x*s + c) computed in float32 (no fused multiply-add, as the plain version)
// and rounded to bf16; s and c are bf16 per channel.
template <int FC>
__device__ __forceinline__ void stage_halo(bf16* dst, const bf16* src, long ld, int t,
                                           int k, int V, int C, int c0,
                                           const bf16* fold_s, const bf16* fold_c) {
  const int n = (4 * k + 1) * kT * FC;
  const int v0 = (t - 2 * k) * kT;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int v = v0 + e / FC, c = c0 + e % FC;
    bf16 u = to_bf(0.0f);
    if (v >= 0 && v < V && c < C) {
      u = src[v * ld + c];
      if (fold_s)
        u = to_bf(fmaxf(__fadd_rn(__fmul_rn(to_f(u), to_f(fold_s[c])), to_f(fold_c[c])),
                        0.0f));
    }
    dst[e] = u;
  }
  __syncthreads();
}

// The Chebyshev hops of row tile t for one chunk of FC channels, by the whole
// block: z1 = L u on tiles t-k .. t+k into z1h (2k+1, T, FC), then
// z2 = 2 L z1 - u on tile t into z2 (T, FC), both rounded to bf16.  uh
// (4k+1, T, FC) holds u on tiles t-2k .. t+2k.  Out-of-range tiles are skipped
// (their band blocks are zero).  Each warp owns 16 rows and st (16 x FC floats)
// is its staging.  On return each warp sees its own rows of z2.
template <int FC>
__device__ __forceinline__ void cheby_hops(const bf16* band, const bf16* uh, bf16* z1h,
                                           bf16* z2, float* st, int t, int nt, int k) {
  constexpr int NJ = FC / 16;
  const int nbd = 2 * k + 1;
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x / 32) * 16;
  const long tile = (long)kT * kT;
  for (int ai = 0; ai < nbd; ++ai) {
    const int a = t + ai - k;
    if (a < 0 || a >= nt) continue;
    FragC acc[NJ];
    zero(acc);
    for (int d = 0; d < nbd; ++d) {
      const int src = a + d - k;  // u tile src sits at uh[ai + d]
      if (src < 0 || src >= nt) continue;
      band_rows_mma(acc, band + ((long)d * nt + a) * tile + r0 * kT,
                    uh + (long)(ai + d) * kT * FC, FC);
    }
    stage(st, acc);
    bf16* dst = z1h + ((long)ai * kT + r0) * FC;
    for (int e = lane; e < 16 * FC; e += 32) dst[e] = to_bf(st[e]);
    __syncwarp();
  }
  __syncthreads();
  FragC acc[NJ];
  zero(acc);
  for (int d = 0; d < nbd; ++d) {
    const int src = t + d - k;
    if (src < 0 || src >= nt) continue;
    band_rows_mma(acc, band + ((long)d * nt + t) * tile + r0 * kT,
                  z1h + (long)d * kT * FC, FC);
  }
  stage(st, acc);
  const bf16* ut = uh + ((long)2 * k * kT + r0) * FC;
  for (int e = lane; e < 16 * FC; e += 32)
    z2[(long)r0 * FC + e] = to_bf(2.0f * st[e] - to_f(ut[e]));
  __syncwarp();
}

// Shared memory of one hop chunk: u halo, z1 halo, z2 (bf16) and the warps'
// float32 staging.
__host__ __device__ constexpr size_t hop_smem(int FC, int k) {
  return (size_t)((4 * k + 1) + (2 * k + 1) + 1) * kT * FC * sizeof(bf16)
         + (size_t)kWarps * 16 * FC * sizeof(float);
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
