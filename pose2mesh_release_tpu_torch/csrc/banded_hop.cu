// One banded Laplacian hop, y = L x, on a block-banded operator (K4).
//
// Replaces the TPU kernel `_hop_call` (pose2mesh_release_tpu/ops/
// pallas_cheby.py, kernel body `_hop_kernel_factory`): the hop of the
// unfused Chebyshev conv, forward and backward (L is symmetric).
//
// Layout: band (2k+1, nt, T, T); x and y (V, C) row-major with C = B*F a
// multiple of 16 and V <= nt*T; all bf16, or all float32 (the float32
// instances, the `f32` argument: exact float32 FFMA over the band's
// nonzeros, nothing rounded).  Rows >= V read as zero and are never written
// (the training layout keeps the real row count; the deploy layout has V =
// nt*T).
//
// The kernel is the banded hop engine of band_hop.cuh (bf16; float32 on
// band_hop_f32.cuh, after its list pass) with alpha = 1 and no added term:
// one launch per hop, float32 accumulation, rounded once to bf16 as the TPU
// kernel rounds it.
// Its design and bound are in those headers.
#include "band_hop.cuh"

using namespace p2m;

// cc: column chunk (16, 32 or 64 dividing C; at float32 128); grid
// blocks of per_block (row tile, chunk) items each, from ops/hop.py
// hop_plan.  f32: the operands are float32, else bf16.  Returns a
// cudaError_t.
extern "C" int p2m_banded_hop(const void* band, const void* x, void* out, int V, int nt,
                              int k, int C, int cc, int grid, int per_block, int f32,
                              void* stream) {
  auto run = [&](auto zero) {
    using T = decltype(zero);
    HopArgsT<T> a{static_cast<const T*>(band), static_cast<const T*>(x), nullptr,
                  static_cast<T*>(out), 1.0f, 0.0f, V, nt, k, C};
    return launch_band_hop(a, cc, grid, per_block, static_cast<cudaStream_t>(stream));
  };
  return f32 ? run(0.0f) : run(bf16{});
}

extern "C" const char* p2m_banded_hop_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
