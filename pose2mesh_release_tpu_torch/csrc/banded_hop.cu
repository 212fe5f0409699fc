// One banded Laplacian hop, y = L x, on a block-banded operator.
//
// Replaces the TPU kernel `_hop_call` (pose2mesh_release_tpu/ops/
// pallas_cheby.py, kernel body `_hop_kernel_factory`): the hop of the
// unfused Chebyshev conv and of the unfused training backward.
//
// Layout: band (2k+1, nt, T, T); x and y (V, C) row-major with C = B*F a
// multiple of 16 and V <= nt*T; all bf16.  Rows >= V read as zero and are
// never written (the training layout keeps the real row count; the deploy
// layout has V = nt*T).
//
// Design: one thread block per (row tile t, CC-column chunk).  For each of
// the 2k+1 band blocks of row t the block stages the source tile's chunk in
// shared memory (rows >= V as zero, 16-byte loads), and each warp multiplies
// its 16 band rows with it on bf16 tensor cores (WMMA, float32 accumulation).
// The sum is rounded once to bf16, as the TPU kernel rounds it.  Out-of-range
// neighbour tiles are zero blocks and are skipped.
//
// Bound on the H100: counted at the band's nonzeros (~2% of the dense
// blocks) the hop does about one operation per byte, so device memory bounds
// it (x read once, y written once).  This first version multiplies the dense
// T x T blocks, reads each band block once per column chunk and does not
// pipeline its loads, so it sits far from that bound.
#include "common.cuh"

using namespace p2m;

namespace {

template <int NJ>
__global__ void __launch_bounds__(kThreads)
hop_kernel(const bf16* __restrict__ band, const bf16* __restrict__ x,
           bf16* __restrict__ out, int V, int nt, int k, int C) {
  constexpr int CC = NJ * 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);                   // (T, CC)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = warp * 16;
  float* st = reinterpret_cast<float*>(xs + kT * CC) + warp * 16 * CC;
  const int t = blockIdx.x, c0 = blockIdx.y * CC;
  const long tile = (long)kT * kT;
  FragC acc[NJ];
  zero(acc);
  for (int d = 0; d < 2 * k + 1; ++d) {
    const int src = t + d - k;
    if (src < 0 || src >= nt) continue;
    for (int e = threadIdx.x; e < kT * CC / 8; e += kThreads) {
      const int r = e / (CC / 8), c = (e % (CC / 8)) * 8;
      const long v = (long)src * kT + r;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (v < V) val = *reinterpret_cast<const uint4*>(x + v * C + c0 + c);
      *reinterpret_cast<uint4*>(xs + r * CC + c) = val;
    }
    __syncthreads();
    band_rows_mma(acc, band + ((long)d * nt + t) * tile + r0 * kT, xs, CC);
    __syncthreads();
  }
  stage(st, acc);
  const long v0 = (long)t * kT + r0;
  for (int e = lane; e < 16 * CC; e += 32) {
    const long v = v0 + e / CC;
    if (v < V) out[v * C + c0 + e % CC] = to_bf(st[e]);
  }
}

template <int NJ>
cudaError_t launch(const void* band, const void* x, void* out, int V, int nt, int k,
                   int C, cudaStream_t stream) {
  constexpr int CC = NJ * 16;
  const size_t smem = (size_t)kT * CC * sizeof(bf16) + (size_t)kWarps * 16 * CC * sizeof(float);
  if (C % CC) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      hop_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  hop_kernel<NJ><<<dim3(nt, C / CC), kThreads, smem, stream>>>(
      static_cast<const bf16*>(band), static_cast<const bf16*>(x), static_cast<bf16*>(out),
      V, nt, k, C);
  return cudaGetLastError();
}

}  // namespace

// cc: column chunk (16, 32, 64 or 128, dividing C).  Returns a cudaError_t.
extern "C" int p2m_banded_hop(const void* band, const void* x, void* out, int V, int nt,
                              int k, int C, int cc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cc) {
    case 16: return launch<1>(band, x, out, V, nt, k, C, s);
    case 32: return launch<2>(band, x, out, V, nt, k, C, s);
    case 64: return launch<4>(band, x, out, V, nt, k, C, s);
    case 128: return launch<8>(band, x, out, V, nt, k, C, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* p2m_banded_hop_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
