// K=3 Chebyshev graph conv over the strip form of a Laplacian (deploy form).
//
//   basis:     z1 = S x,  z2 = 2 S z1 - x,  y = act([x, z1, z2] @ W + b) (+ skip)
//   commuted:  u = x W2,  t = 2 S u + x W1,  y = act(S t + x (W0 - W2) + b) (+ skip)
//              with W = [W0 - W2; W1; W2]
//
// Replaces the TPU kernel `fused_conv_flat_strip` (pose2mesh_release_tpu/ops/
// pallas_strip.py, kernel bodies `_strip_kernel_factory` and
// `_strip_basis_kernel_factory`), and in basis order also
// `fused_conv_flat_window` (ops/pallas_window.py, `_win_kernel_factory`):
// the window form is the strip form with T-row tiles (ops/window_cheby.py).
//
// Layout: strip (Vp, Wd): row r holds L[r, off[r / h] + j] for j < Wd, with h
// the strip tile height (a multiple of 16 dividing Vp), Wd a multiple of 16
// and the offsets off (Vp / h,) int32 from the pack-time table, given as the
// engine's table wrow (Vp / T, 8) int32 of each warp's source row
// off[(t T + 16 w) / h]; x (Vp, B, F);
// W (3F, Np) zero-padded (basis: Np from proj_plan; commuted: three blocks of
// fo_pad = Fout rounded up to 16, Np = 3 fo_pad); bias (Fout,); skip (Vp, B,
// Fs), or (Vp, B, fo_pad) for the skip add in commuted order; skip_w (Fs,
// Np) basis, (Fs, fo_pad) commuted; all bf16, or all float32 (the float32
// instances, the `f32` argument: nothing rounded between the stages, as the
// TPU kernel's float32 scratch keeps them; the hops by exact FFMA
// (band_hop_f32.cuh), the projections by 3xTF32 on wgmma, gemm_f32.cuh).
//
// Design, in launches on one stream (the wrapper counts them as one call),
// the hops on the banded hop engine (band_hop.cuh, its strip layout: the
// nonzero 16 x 16 sub-tiles of the strip form are those of the block band,
// kept in registers, the rest skipped) over x viewed as (Vp, B*F):
//   basis (the group conv's sequence):
//     1-2. z1 = S x, z2 = 2 S z1 - x: two engine launches, z1 and z2 rounded
//          to bf16 where the TPU kernel rounds them;
//     3.   the projection GEMM (cheby_proj.cuh, kEpiDeploy) over M = Vp*B
//          rows with x, z1 and z2 as W's three K-blocks, bias, ReLU and the
//          skip, one rounding to bf16.
//   commuted:
//     (with a skip projection: sp = skip @ skip_w into float32 (M, fo_pad),
//          the projection with kEpiF32);
//     1.   the projection (kEpiCommutedT): [p | t0 | u] = bf16([x (W0 -
//          W2) + b | x W1 | x W2]) into (3, M, fo_pad);
//     2.   t = bf16(2 S u + t0): the engine with an add operand of the
//          operand type;
//     3.   y = bf16(act(S t + p) (+ skip | + sp)): the engine with the ReLU
//          and, with a skip, its post-activation operand of the operand type
//          or float32 (kHopSkipAdd, kHopSkipProj).
//   Where Fout < fo_pad (no SMPL conv's) the wrapper narrows y with one copy.
// The rounding points are the TPU strip kernel's: in commuted order x W1 and
// the bias partial p are rounded to bf16 (the group commuted conv keeps them
// float32).  The TPU kernel keeps a whole level in VMEM; here z1, z2 or p,
// t0, u and t go through device memory once.
//
// Bound on the H100: counted at the Laplacian's nonzeros, device memory (x
// read once, y written once).  Writing and reading back the intermediates,
// and the hops' halo re-reads from L2, give this design a floor of about 3-5x
// the bound's bytes.
#include "cheby_proj.cuh"

using namespace p2m;

namespace {

// The last hop of commuted order with the skip's epilogue.
template <typename T>
cudaError_t commuted_hop2(const HopArgsT<T>& a, int skip_mode, int cc, int grid,
                          int per_block, cudaStream_t st) {
  if (skip_mode == 1) return launch_band_hop<true, kHopSkipAdd>(a, cc, grid, per_block, st);
  if (skip_mode == 2) return launch_band_hop<true, kHopSkipProj>(a, cc, grid, per_block, st);
  return launch_band_hop<true, kHopAdd>(a, cc, grid, per_block, st);
}

template <typename T>
cudaError_t strip_conv(const void* strip, const void* wrow, const void* x, const void* W,
                       const void* bias, const void* skip, const void* skip_w, void* s0,
                       void* s1, void* sp, void* out, int Vp, int Wd, int span, int B, int F,
                       int Fout, int Np, int Fs, int commuted, int relu, int skip_mode,
                       int hop_cc, int hop_grid, int hop_per_block, int bn, int proj_grid,
                       int skip_bn, int skip_grid, int stages, cudaStream_t st) {
  const int nt = Vp / kT;
  const long M = (long)Vp * B;
  const T* xb = static_cast<const T*>(x);
  const T* sk = skip_mode ? static_cast<const T*>(skip) : nullptr;
  T* b0 = static_cast<T*>(s0);
  T* b1 = static_cast<T*>(s1);
  HopArgsT<T> hop{static_cast<const T*>(strip), nullptr, nullptr, nullptr, 1.0f, 0.0f, Vp,
                  nt, 0, 0};
  hop.wrow = static_cast<const int*>(wrow);
  hop.ld = Wd, hop.span = span;
  cudaError_t err = cudaSuccess;
  if (!commuted) {
    if (stages & 1) {
      HopArgsT<T> z1 = hop;  // z1 = S x
      z1.x = xb, z1.y = b0, z1.C = B * F;
      if ((err = launch_band_hop<true>(z1, hop_cc, hop_grid, hop_per_block, st)) != cudaSuccess)
        return err;
      HopArgsT<T> z2 = z1;  // z2 = 2 S z1 - x
      z2.x = b0, z2.add = xb, z2.y = b1, z2.alpha = 2.0f, z2.beta = -1.0f;
      if ((err = launch_band_hop<true>(z2, hop_cc, hop_grid, hop_per_block, st)) != cudaSuccess)
        return err;
    }
    if (!(stages & 2)) return cudaSuccess;
    ProjArgsT<T> p{{xb, b0, b1}, static_cast<const T*>(W), static_cast<const T*>(bias), sk,
                   skip_mode == 2 ? static_cast<const T*>(skip_w) : nullptr,
                   static_cast<T*>(out), nullptr, (int)M, F, Fout, Np, Fs, relu};
    return launch_proj<kEpiDeploy>(p, bn, proj_grid, nullptr, st);
  }
  const int fo = Np / 3;
  T *pb = b0, *t0 = b0 + M * fo, *ub = b0 + 2 * M * fo;
  if (stages & 1) {
    if (skip_mode == 2) {  // sp = skip @ skip_w, float32
      ProjArgsT<T> q{{sk, nullptr, nullptr}, static_cast<const T*>(skip_w), nullptr, nullptr,
                     nullptr, nullptr, nullptr, (int)M, Fs, Fout, fo, 0, 0,
                     static_cast<float*>(sp)};
      if ((err = launch_proj<kEpiF32>(q, skip_bn, skip_grid, nullptr, st)) != cudaSuccess)
        return err;
    }
    ProjArgsT<T> p{{xb, nullptr, nullptr}, static_cast<const T*>(W),
                   static_cast<const T*>(bias), nullptr, nullptr, pb, nullptr, (int)M, F,
                   Fout, Np, 0, 0};
    if ((err = launch_proj<kEpiCommutedT>(p, bn, proj_grid, nullptr, st)) != cudaSuccess)
      return err;
  }
  if (stages & 2) {  // t = 2 S u + t0
    HopArgsT<T> t = hop;
    t.x = ub, t.add = t0, t.y = b1, t.alpha = 2.0f, t.beta = 1.0f, t.C = B * fo;
    if ((err = launch_band_hop<true>(t, hop_cc, hop_grid, hop_per_block, st)) != cudaSuccess)
      return err;
  }
  if (stages & 4) {  // y = act(S t + p) (+ skip | + sp)
    HopArgsT<T> y = hop;
    y.x = b1, y.add = pb, y.y = static_cast<T*>(out), y.beta = 1.0f, y.C = B * fo;
    y.relu = relu;
    if (skip_mode == 1) y.post = sk;
    if (skip_mode == 2) y.postf = static_cast<const float*>(sp);
    err = commuted_hop2(y, skip_mode, hop_cc, hop_grid, hop_per_block, st);
  }
  return err;
}

}  // namespace

// commuted: 0 basis order, 1 commuted order.  skip_mode: 0 none, 1 add, 2
// projection through skip_w.  s0, s1: basis z1, z2 (Vp, B, F); commuted
// [p | t0 | u] (3, Vp, B, fo_pad) and t (Vp, B, fo_pad), of the operand
// type.  sp: the skip projection's float32 (Vp, B, fo_pad) (commuted,
// skip_mode 2).  out: (Vp, B, Fout) basis, (Vp, B, fo_pad) commuted.  span:
// the staged 16-row groups of a row tile (ops/hop.py hop_layout).  The
// launch plan (ops/strip_cheby.py strip_launcher): the hop engine's chunk,
// grid and items per block (hop_plan over B*F or B*fo_pad columns); the
// projection's tile width bn and grid (proj_plan, commuted_plan), and the
// skip projection's (skip_bn, skip_grid).  stages: basis 1 the two hops, 2
// the projection; commuted 1 the projection(s), 2 the first hop, 4 the
// second; all set is the whole conv (the parts alone only time the split).
// f32: the operands are float32, else bf16.  Returns a cudaError_t.
extern "C" int p2m_strip_cheby_conv(const void* strip, const void* wrow, const void* x,
                                    const void* W, const void* bias, const void* skip,
                                    const void* skip_w, void* s0, void* s1, void* sp,
                                    void* out, int Vp, int Wd, int span, int B, int F,
                                    int Fout, int Np, int Fs, int commuted, int relu,
                                    int skip_mode, int hop_cc, int hop_grid,
                                    int hop_per_block, int bn, int proj_grid, int skip_bn,
                                    int skip_grid, int stages, int f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Vp % kT || F % 16 || B <= 0 || skip_mode < 0 || skip_mode > 2 || (commuted && Np % 48))
    return cudaErrorInvalidValue;
  auto run = [&](auto zero) {
    return strip_conv<decltype(zero)>(strip, wrow, x, W, bias, skip, skip_w, s0, s1, sp, out,
                                      Vp, Wd, span, B, F, Fout, Np, Fs, commuted, relu,
                                      skip_mode, hop_cc, hop_grid, hop_per_block, bn,
                                      proj_grid, skip_bn, skip_grid, stages, st);
  };
  return f32 ? run(0.0f) : run(bf16{});
}

extern "C" const char* p2m_strip_cheby_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
