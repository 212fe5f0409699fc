// Fused K=3 Chebyshev graph conv of the training step (forward), K1.
//
//   u = x, or relu(x*s + c) with (s, c) the previous BatchNorm's affine
//   y = [u, Lu, 2L(Lu) - u] @ W + b,   optionally (sum y, sum y^2) per channel,
//   or (keep_basis) the basis z1 = Lu and z2 = 2L z1 - u beside y
//
// Replaces the TPU kernel `_fused_call` (pose2mesh_release_tpu/ops/
// pallas_cheby.py, kernel body `_fused_kernel_factory`) in its plain,
// emit_stats, in_fold and in_fold + emit_stats forms, and with keep_basis.
//
// Layout: band (2k+1, nt, T, T); x (V, B, F) at the real row count V <= nt*T;
// W (3F, Np) basis-major, zero-padded to Np columns; bias (Fout,); fold scale
// and shift (F,); u, z1, z2 (V, B, F) scratch (z1, z2 the keep_basis
// outputs); y (V, B, Fout); all bf16, or all float32 (the float32 instances,
// the `f32` argument: nothing rounded, the hops by exact FFMA
// (band_hop_f32.cuh), the projection by 3xTF32 on wgmma, gemm_f32.cuh).
// Rows >= V read as zero and are never written, so nothing of a pad row
// reaches the statistics or, in the backward, the gradients.
//
// Design, in launches on one stream (the wrapper counts them as one call):
//   1. with the fold: u = bf16(relu(x*s + c)) in float32 without FMA, as the
//      plain version, one 16-byte vector a thread (u has only the V real
//      rows, so the hops below read its missing rows as zero, not relu(c));
//   2-3. z1 = L u and z2 = 2 L z1 - u: two launches of the banded hop engine
//      (band_hop.cuh) over u viewed as (V, B*F): band fragments resident per
//      row tile, zero 16 x 16 sub-tiles skipped, cp.async staging, each
//      result rounded once to bf16 where the TPU kernel rounds it;
//   4. y = [u, z1, z2] @ W + b: the projection GEMM (cheby_proj.cuh) over
//      M = V*B rows, the three operands as W's three K-blocks, with the
//      statistics epilogue (one float32 partial per block) where asked;
//   5. with the statistics, the partials added in block order.  No atomics:
//      two runs give equal bits.
// With keep_basis the wrapper returns the z1 and z2 of steps 2-3.
//
// Bound on the H100: counted at the band's nonzeros the conv does few
// operations per byte and is bound by device memory (x read once, y written
// once).  This design moves more: z1 and z2 (and u with the fold) are
// written and read back, and each hop re-reads its x rows' halo from L2, so
// its own floor is about 3-5x the bound's bytes.
#include "cheby_proj.cuh"

using namespace p2m;

namespace {

// u = T(relu(x*s + c)) over n 16-byte vectors of (rows, F), float32
// without FMA; s and c of type T per channel.
template <typename T>
__global__ void fold_kernel(const T* __restrict__ x, const T* __restrict__ s,
                            const T* __restrict__ c, T* __restrict__ u, long n, int F) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    const int f0 = (int)((i * vec_elems<T>()) % F);
    if constexpr (sizeof(T) == 4) {
      float4 v = reinterpret_cast<const float4*>(x)[i];
      const float4 sv = *reinterpret_cast<const float4*>(s + f0);
      const float4 cv = *reinterpret_cast<const float4*>(c + f0);
      v.x = fmaxf(__fadd_rn(__fmul_rn(v.x, sv.x), cv.x), 0.0f);
      v.y = fmaxf(__fadd_rn(__fmul_rn(v.y, sv.y), cv.y), 0.0f);
      v.z = fmaxf(__fadd_rn(__fmul_rn(v.z, sv.z), cv.z), 0.0f);
      v.w = fmaxf(__fadd_rn(__fmul_rn(v.w, sv.w), cv.w), 0.0f);
      reinterpret_cast<float4*>(u)[i] = v;
    } else {
      uint4 v = reinterpret_cast<const uint4*>(x)[i];
      const uint4 sv = *reinterpret_cast<const uint4*>(s + f0);
      const uint4 cv = *reinterpret_cast<const uint4*>(c + f0);
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
      const __nv_bfloat162* hs = reinterpret_cast<const __nv_bfloat162*>(&sv);
      const __nv_bfloat162* hc = reinterpret_cast<const __nv_bfloat162*>(&cv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 xf = __bfloat1622float2(h[j]), sf = __bfloat1622float2(hs[j]),
                     cf = __bfloat1622float2(hc[j]);
        h[j] = __floats2bfloat162_rn(fmaxf(__fadd_rn(__fmul_rn(xf.x, sf.x), cf.x), 0.0f),
                                     fmaxf(__fadd_rn(__fmul_rn(xf.y, sf.y), cf.y), 0.0f));
      }
      reinterpret_cast<uint4*>(u)[i] = v;
    }
  }
}

template <typename T>
cudaError_t train_conv(const void* band, const void* x, const void* W, const void* bias,
                       const void* fold_s, const void* fold_c, void* u, void* z1, void* z2,
                       void* out, void* part, void* stats, int V, int nt, int k, int B, int F,
                       int Fout, int Np, int emit_stats, int hop_cc, int hop_grid,
                       int hop_per_block, int bn, int proj_grid, int stages,
                       cudaStream_t st) {
  const bool fold = fold_s != nullptr;
  const T* ub = fold ? static_cast<const T*>(u) : static_cast<const T*>(x);
  T* z1b = static_cast<T*>(z1);
  T* z2b = static_cast<T*>(z2);
  cudaError_t err = cudaSuccess;
  if (fold && (stages & 1)) {
    if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(u) |
         reinterpret_cast<uintptr_t>(fold_s) | reinterpret_cast<uintptr_t>(fold_c)) % 16)
      return cudaErrorMisalignedAddress;
    const long n = (long)V * B * F / vec_elems<T>();
    const long blocks = (n + 255) / 256;
    fold_kernel<T><<<(int)(blocks < 65536 ? blocks : 65536), 256, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(fold_s),
        static_cast<const T*>(fold_c), static_cast<T*>(u), n, F);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (stages & 2) {
    const T* bb = static_cast<const T*>(band);
    const int C = B * F;
    err = launch_band_hop(HopArgsT<T>{bb, ub, nullptr, z1b, 1.0f, 0.0f, V, nt, k, C}, hop_cc,
                          hop_grid, hop_per_block, st);
    if (err != cudaSuccess) return err;
    err = launch_band_hop(HopArgsT<T>{bb, z1b, ub, z2b, 2.0f, -1.0f, V, nt, k, C}, hop_cc,
                          hop_grid, hop_per_block, st);
    if (err != cudaSuccess) return err;
  }
  if (!(stages & 4)) return cudaSuccess;
  ProjArgsT<T> p{{ub, z1b, z2b}, static_cast<const T*>(W), static_cast<const T*>(bias),
                 nullptr, nullptr, static_cast<T*>(out), static_cast<float*>(part),
                 V * B, F, Fout, Np, 0, 0};
  if (emit_stats)
    return launch_proj<kEpiStats>(p, bn, proj_grid, static_cast<float*>(stats), st);
  return launch_proj<kEpiBias>(p, bn, proj_grid, nullptr, st);
}

}  // namespace

// fold_s / fold_c: null without the fold, and then u is not used (x is u).
// z1, z2: (V, B, F), written by the hops.  part: (proj_grid, 2*Fout)
// float32 scratch and stats: (2, Fout) float32 [sum y; sum y^2], used with
// emit_stats.  The launch plan (ops/fused_cheby_train.py train_launcher):
// the hop engine's chunk, grid and items per block (hop_plan over B*F
// columns); the projection's tile width bn and grid (proj_plan).  stages:
// which launches run, 1 the fold, 2 the two hops, 4 the projection (and
// the statistics' reduction); 7 is the whole conv (the parts alone only time
// the split).  f32: the operands are float32, else bf16.  Returns a
// cudaError_t.
extern "C" int p2m_train_conv(const void* band, const void* x, const void* W,
                              const void* bias, const void* fold_s, const void* fold_c,
                              void* u, void* z1, void* z2, void* out, void* part,
                              void* stats, int V, int nt, int k, int B, int F, int Fout,
                              int Np, int emit_stats, int hop_cc, int hop_grid,
                              int hop_per_block, int bn, int proj_grid, int stages, int f32,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (F % 16 || V <= 0 || B <= 0) return cudaErrorInvalidValue;
  auto run = [&](auto zero) {
    return train_conv<decltype(zero)>(band, x, W, bias, fold_s, fold_c, u, z1, z2, out, part,
                                      stats, V, nt, k, B, F, Fout, Np, emit_stats, hop_cc,
                                      hop_grid, hop_per_block, bn, proj_grid, stages, st);
  };
  return f32 ? run(0.0f) : run(bf16{});
}

extern "C" const char* p2m_train_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
