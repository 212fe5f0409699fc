// Shared pieces of the banded Chebyshev-conv kernels: the operand types
// (bf16, or float32 for the float32 instances), the row-tile size, the block
// shape, the element access both types share and the hop engines' arguments.
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
__device__ __forceinline__ float to_f(float v) { return v; }

// Elements of the operand type T in one 16-byte vector (cp.async, stores).
template <typename T>
__host__ __device__ constexpr int vec_elems() { return 16 / (int)sizeof(T); }

// Two neighbouring elements as float2 (8- or 4-byte aligned), and back: the
// bf16 store rounds once to nearest, the float32 store does not round.
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

// The hop engines' arguments (band_hop.cuh bf16, band_hop_f32.cuh float32)
// and their epilogues (the template parameter EPI of launch_band_hop).
constexpr int kHopAdd = 0, kHopF32Add = 1, kHopSkipAdd = 2, kHopSkipProj = 3;

template <typename T>
struct HopArgsT {
  const T* band;  // the block band, or the strip form (STRIP)
  const T* x;
  const T* add;  // add operand; null: beta is not used (not with kHopF32Add)
  T* y;
  float alpha, beta;
  int V, nt, k, C;               // k: the block band's band_k
  const float* addf = nullptr;   // kHopF32Add: the float32 add operand (V, C)
  const int* wrow = nullptr;     // STRIP: v0(t, w), the warps' source rows (nt, 8)
  int relu = 0;                  // ReLU after the add
  int ld = 0, span = 0;          // STRIP: Wd, the staged 16-row groups of a row tile
  const T* post = nullptr;       // kHopSkipAdd: (V, C) added after the activation
  const float* postf = nullptr;  // kHopSkipProj: float32 (V, C) added after the activation
};
using HopArgs = HopArgsT<bf16>;

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
