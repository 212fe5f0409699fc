// Fused K=3 Chebyshev graph conv on a block-banded Laplacian (deploy form).
//
//   y = act([x, Lx, 2L(Lx) - x] @ W + b)  (+ skip | + skip @ skip_w)
//
// Replaces the TPU kernel `fused_conv_flat` (pose2mesh_release_tpu/ops/
// pallas_cheby.py, kernel body `_fused_kernel_factory`).
//
// Layout: band (2k+1, nt, T, T), x (nt*T, B, F), W (3F, Np) basis-major and
// zero-padded to Np columns, bias (Fout,), skip (nt*T, B, Fs), skip_w (Fs,
// Np), z1 and z2 (nt*T, B, F) scratch, out (nt*T, B, Fout); all bf16, or all
// float32 (the float32 instances, the `f32` argument: nothing rounded, the
// hops by exact FFMA (band_hop_f32.cuh), the projection by 3xTF32 on wgmma,
// gemm_f32.cuh).
//
// Design, in launches on one stream (the wrapper counts them as one call):
//   1-2. z1 = L x and z2 = 2 L z1 - x: two launches of the banded hop engine
//      (band_hop.cuh) over x viewed as (nt*T, B*F), every row computed, pad
//      rows included; band fragments resident per row tile, zero 16 x 16
//      sub-tiles skipped, cp.async staging; z1 and z2 rounded to bf16 where
//      the TPU kernel rounds them;
//   3. the projection GEMM (cheby_proj.cuh) over M = nt*T*B rows with x, z1
//      and z2 as W's three K-blocks, bias and ReLU in registers, then the
//      skip: added in float32, or its projection through skip_w accumulated
//      after the activation; one rounding to bf16, 16-byte stores.
// The TPU kernel keeps z1 and z2 in VMEM; here they go through device memory
// once (written by the hops, read by the projection).
//
// Bound on the H100: the band blocks are ~2% nonzero, so counted at the
// nonzeros the conv does few operations per byte and is bound by device
// memory (x read once, y written once).  Writing and reading back z1 and z2,
// and the hops' halo re-reads from L2, give this design a floor of about
// 3-5x the bound's bytes.
#include "cheby_proj.cuh"

using namespace p2m;

namespace {

template <typename T>
cudaError_t group_conv(const void* band, const void* x, const void* W, const void* bias,
                       const void* skip, const void* skip_w, void* z1, void* z2, void* out,
                       int nt, int k, int B, int F, int Fout, int Np, int Fs, int relu,
                       int skip_mode, int hop_cc, int hop_grid, int hop_per_block, int bn,
                       int proj_grid, int stages, cudaStream_t st) {
  const int V = nt * kT;
  const T* xb = static_cast<const T*>(x);
  T* z1b = static_cast<T*>(z1);
  T* z2b = static_cast<T*>(z2);
  cudaError_t err = cudaSuccess;
  if (stages & 1) {
    const T* bb = static_cast<const T*>(band);
    const int C = B * F;
    err = launch_band_hop(HopArgsT<T>{bb, xb, nullptr, z1b, 1.0f, 0.0f, V, nt, k, C}, hop_cc,
                          hop_grid, hop_per_block, st);
    if (err != cudaSuccess) return err;
    err = launch_band_hop(HopArgsT<T>{bb, z1b, xb, z2b, 2.0f, -1.0f, V, nt, k, C}, hop_cc,
                          hop_grid, hop_per_block, st);
    if (err != cudaSuccess) return err;
  }
  if (!(stages & 2)) return cudaSuccess;
  ProjArgsT<T> p{{xb, z1b, z2b}, static_cast<const T*>(W), static_cast<const T*>(bias),
                 skip_mode ? static_cast<const T*>(skip) : nullptr,
                 skip_mode == 2 ? static_cast<const T*>(skip_w) : nullptr,
                 static_cast<T*>(out), nullptr, V * B, F, Fout, Np, Fs, relu};
  return launch_proj<kEpiDeploy>(p, bn, proj_grid, nullptr, st);
}

}  // namespace

// skip_mode: 0 none, 1 add (Fs == Fout), 2 projection through skip_w.  The
// launch plan (ops/fused_cheby.py conv_launcher): the hop engine's chunk,
// grid and items per block (hop_plan over B*F columns); the projection's tile
// width bn and grid (proj_plan).  stages: 1 the two hops, 2 the projection; 3
// is the whole conv (the parts alone only time the split).  f32: the
// operands are float32, else bf16.  Returns a cudaError_t.
extern "C" int p2m_fused_cheby_conv(const void* band, const void* x, const void* W,
                                    const void* bias, const void* skip, const void* skip_w,
                                    void* z1, void* z2, void* out, int nt, int k, int B,
                                    int F, int Fout, int Np, int Fs, int relu, int skip_mode,
                                    int hop_cc, int hop_grid, int hop_per_block, int bn,
                                    int proj_grid, int stages, int f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (F % 16 || B <= 0 || skip_mode < 0 || skip_mode > 2) return cudaErrorInvalidValue;
  auto run = [&](auto zero) {
    return group_conv<decltype(zero)>(band, x, W, bias, skip, skip_w, z1, z2, out, nt, k, B,
                                      F, Fout, Np, Fs, relu, skip_mode, hop_cc, hop_grid,
                                      hop_per_block, bn, proj_grid, stages, st);
  };
  return f32 ? run(0.0f) : run(bf16{});
}

extern "C" const char* p2m_fused_cheby_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
