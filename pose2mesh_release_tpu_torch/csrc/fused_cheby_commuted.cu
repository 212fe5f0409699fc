// Commuted K=3 Chebyshev graph conv on a block-banded Laplacian (deploy form).
//
//   y = act(x (W0 - W2) + L (x W1 + 2 L (x W2)) + b),  Wc = [W0 - W2; W1; W2]
//
// L acts on vertices and W on channels, so projecting first moves both hops
// onto Fout-wide columns; for Fout < F that cuts the hop work by F / Fout.
// Replaces the TPU kernel `fused_conv_flat_commuted` (pose2mesh_release_tpu/
// ops/pallas_cheby.py, kernel body `_commuted_kernel_factory`).
//
// Layout: band (2k+1, nt, T, T); x (nt*T, B, F); Wc (3F, Fo_pad) basis-major,
// zero-padded to Fo_pad (Fo rounded up to 16); bias (Fo,); scratch a and p1
// (nt*T, B, Fo_pad) float32 (one (2, ...) buffer), p2 and t (nt*T, B, Fo_pad)
// bf16; out (nt*T, B, Fo_pad) bf16; or every bf16 tensor float32 (the
// float32 instances, the `f32` argument: nothing rounded, the hops by exact
// FFMA (band_hop_f32.cuh), the projection by 3xTF32 on wgmma, gemm_f32.cuh).
// Where Fo < Fo_pad (no SMPL conv) the wrapper narrows out to (nt*T, B, Fo)
// with one copy.
//
// Design, in launches on one stream (the wrapper counts them as one call):
//   1. the projection GEMM (cheby_proj.cuh, epilogue kEpiCommuted) over
//      M = nt*T*B rows and the one operand x: a = x (W0 - W2) + b and
//      p1 = x W1 in float32, p2 = x W2 rounded to bf16;
//   2. t = bf16(2 L p2 + p1): the banded hop engine (band_hop.cuh) over
//      C = B*Fo_pad columns with its float32 add operand;
//   3. y = bf16(act(L t + a)): the engine again, float32 add and the ReLU.
// The rounding points are the TPU kernel's: x W2 and x W1 + 2 L u rounded to
// bf16, x W1 and x (W0 - W2) added unrounded.  The TPU kernel keeps u and t
// in VMEM; here p2, t and the float32 a and p1 go through device memory once.
//
// Bound on the H100: counted at the Laplacian's nonzeros, device memory (x
// read once, y written once).  This design also writes and reads back a, p1
// (float32), p2 and t, and the hops re-read their halo from L2: at 6890
// 128->64 about 0.85 GB against the bound's ~0.17.
#include "cheby_proj.cuh"

using namespace p2m;

namespace {

template <typename T>
cudaError_t commuted_conv(const void* band, const void* x, const void* Wc, const void* bias,
                          void* ap1, void* p2, void* t, void* out, int nt, int k, int B, int F,
                          int Fo, int Fo_pad, int relu, int hop_cc, int hop_grid,
                          int hop_per_block, int bn, int proj_grid, int stages,
                          cudaStream_t st) {
  const int V = nt * kT, C = B * Fo_pad;
  const long M = (long)V * B;
  const T* bb = static_cast<const T*>(band);
  float* a = static_cast<float*>(ap1);
  T* p2b = static_cast<T*>(p2);
  T* tb = static_cast<T*>(t);
  cudaError_t err = cudaSuccess;
  if (stages & 1) {
    ProjArgsT<T> p{{static_cast<const T*>(x), nullptr, nullptr}, static_cast<const T*>(Wc),
                   static_cast<const T*>(bias), nullptr, nullptr, p2b, nullptr, (int)M, F, Fo,
                   3 * Fo_pad, 0, 0, a};
    err = launch_proj<kEpiCommuted>(p, bn, proj_grid, nullptr, st);
    if (err != cudaSuccess) return err;
  }
  if (stages & 2) {
    HopArgsT<T> h{bb, p2b, nullptr, tb, 2.0f, 1.0f, V, nt, k, C};
    h.addf = a + M * Fo_pad;  // p1
    err = launch_band_hop<false, kHopF32Add>(h, hop_cc, hop_grid, hop_per_block, st);
    if (err != cudaSuccess) return err;
  }
  if (stages & 4) {
    HopArgsT<T> h{bb, tb, nullptr, static_cast<T*>(out), 1.0f, 1.0f, V, nt, k, C};
    h.addf = a;
    h.relu = relu;
    err = launch_band_hop<false, kHopF32Add>(h, hop_cc, hop_grid, hop_per_block, st);
  }
  return err;
}

}  // namespace

// The launch plan (ops/fused_cheby.py commuted_launcher): the hop engine's
// chunk, grid and items per block (hop_plan over B*Fo_pad columns); the
// projection's tile width bn (dividing Fo_pad) and grid (commuted_plan).
// stages: 1 the projection, 2 the first hop, 4 the second; 7 is the whole
// conv (the parts alone only time the split).  f32: the operands are
// float32, else bf16.  Returns a cudaError_t.
extern "C" int p2m_fused_cheby_conv_commuted(const void* band, const void* x, const void* Wc,
                                             const void* bias, void* ap1, void* p2, void* t,
                                             void* out, int nt, int k, int B, int F, int Fo,
                                             int Fo_pad, int relu, int hop_cc, int hop_grid,
                                             int hop_per_block, int bn, int proj_grid,
                                             int stages, int f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (F % 16 || Fo_pad % 16 || Fo <= 0 || Fo > Fo_pad || B <= 0) return cudaErrorInvalidValue;
  auto run = [&](auto zero) {
    return commuted_conv<decltype(zero)>(band, x, Wc, bias, ap1, p2, t, out, nt, k, B, F, Fo,
                                         Fo_pad, relu, hop_cc, hop_grid, hop_per_block, bn,
                                         proj_grid, stages, st);
  };
  return f32 ? run(0.0f) : run(bf16{});
}

extern "C" const char* p2m_fused_cheby_commuted_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
