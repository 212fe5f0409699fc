// K=3 Chebyshev graph conv over the sliding-window form of a Laplacian
// (deploy form).
//
//   y = act([x, Lx, 2L(Lx) - x] @ W + b)  (+ skip | + skip @ skip_w)
//
// Replaces the TPU kernel `fused_conv_flat_window` (pose2mesh_release_tpu/
// ops/pallas_window.py, kernel body `_win_kernel_factory`).
//
// Layout: win (Vp, Wd) with Wd = (2k+1)*T: row tile j holds L[jT:(j+1)T,
// s_j : s_j + Wd], s_j = clip((j - k) T, 0, Vp - Wd) from the offsets table
// woff (nt,) int32 (the first and last k tiles shift their entries instead of
// clamping, so every window is in bounds; this needs nt >= 2k+1); x
// (Vp, B, F); W (3F, Np) basis-major, zero-padded to Np columns; bias
// (Fout,); skip (Vp, B, Fs); skip_w (Fs, Np); z1 and z2 (Vp, B, F) scratch;
// out (Vp, B, Fout); all bf16.
//
// Design: that of fused_cheby.cu, with the hops reading the window form, in
// launches on one stream (the wrapper counts them as one call):
//   1-2. z1 = L x and z2 = 2 L z1 - x: two launches of the banded hop engine
//      (band_hop.cuh, WIN layout: warp w of tile t reads its band rows at
//      win + (t T + 16 w) Wd, sub-tile j at + 16 j, against x rows
//      woff[t] + 16 j), over x viewed as (Vp, B*F); zero 16 x 16 sub-tiles
//      skipped, the nonzero ones kept in registers, z1 and z2 rounded to
//      bf16 where the TPU kernel rounds them;
//   3. the projection GEMM (cheby_proj.cuh, epilogue kEpiDeploy) over
//      M = Vp*B rows with x, z1 and z2 as W's three K-blocks, bias, ReLU and
//      the skip, one rounding to bf16.
//
// Bound on the H100: as fused_cheby.cu, device memory (x read once, y
// written once) at the operator's nonzeros; writing and reading back z1 and
// z2 and the hops' halo re-reads give this design a floor of about 3-5x the
// bound's bytes.
#include "cheby_proj.cuh"

using namespace p2m;

// skip_mode: 0 none, 1 add (Fs == Fout), 2 projection through skip_w.  The
// launch plan (ops/window_cheby.py window_launcher): the hop engine's chunk,
// grid and items per block (hop_plan over B*F columns); the projection's
// tile width bn and grid (proj_plan).  stages: 1 the two hops, 2 the
// projection; 3 is the whole conv (the parts alone only time the split).
// Returns a cudaError_t.
extern "C" int p2m_window_cheby_conv(const void* win, const void* woff, const void* x,
                                     const void* W, const void* bias, const void* skip,
                                     const void* skip_w, void* z1, void* z2, void* out,
                                     int nt, int k, int B, int F, int Fout, int Np, int Fs,
                                     int relu, int skip_mode, int hop_cc, int hop_grid,
                                     int hop_per_block, int bn, int proj_grid, int stages,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (F % 16 || B <= 0 || skip_mode < 0 || skip_mode > 2 || nt < 2 * k + 1)
    return cudaErrorInvalidValue;
  const int V = nt * kT;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* z1b = static_cast<bf16*>(z1);
  bf16* z2b = static_cast<bf16*>(z2);
  cudaError_t err = cudaSuccess;
  if (stages & 1) {
    const bf16* wb = static_cast<const bf16*>(win);
    const int* wo = static_cast<const int*>(woff);
    const int C = B * F;
    HopArgs h1{wb, xb, nullptr, z1b, 1.0f, 0.0f, V, nt, k, C};
    h1.woff = wo;
    err = launch_band_hop<true, false>(h1, hop_cc, hop_grid, hop_per_block, st);
    if (err != cudaSuccess) return err;
    HopArgs h2{wb, z1b, xb, z2b, 2.0f, -1.0f, V, nt, k, C};
    h2.woff = wo;
    err = launch_band_hop<true, false>(h2, hop_cc, hop_grid, hop_per_block, st);
    if (err != cudaSuccess) return err;
  }
  if (!(stages & 2)) return cudaSuccess;
  ProjArgs p{{xb, z1b, z2b}, static_cast<const bf16*>(W), static_cast<const bf16*>(bias),
             skip_mode ? static_cast<const bf16*>(skip) : nullptr,
             skip_mode == 2 ? static_cast<const bf16*>(skip_w) : nullptr,
             static_cast<bf16*>(out), nullptr, V * B, F, Fout, Np, Fs, relu};
  return launch_proj<kEpiDeploy>(p, bn, proj_grid, nullptr, st);
}

extern "C" const char* p2m_window_cheby_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
