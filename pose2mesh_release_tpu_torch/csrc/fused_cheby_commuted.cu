// Commuted K=3 Chebyshev graph conv on a block-banded Laplacian (deploy form).
//
//   y = act(x (W0 - W2) + L (x W1 + 2 L (x W2)) + b),  Wc = [W0 - W2; W1; W2]
//
// L acts on vertices and W on channels, so projecting first moves both hops
// onto Fout-wide columns; for Fout < F that cuts the hop work by F / Fout.
// Replaces the TPU kernel `fused_conv_flat_commuted` (pose2mesh_release_tpu/
// ops/pallas_cheby.py, kernel body `_commuted_kernel_factory`).
//
// Layout: band (2k+1, nt, T, T), x (nt*T, B, F), Wc (3F, Fo_pad) zero-padded
// to Fo_pad (a multiple of 32), bias (Fo,), out (nt*T, B, Fo); all bf16.
//
// Design: one thread block per (row tile t, batch element, 32 output
// channels) -- every step is separable in the output channels.  The block
// projects u = x W2 for tiles t-2k..t+2k and then tt = x W1 + 2 L u for
// tiles t-k..t+k into shared memory, both rounded to bf16 where the TPU
// kernel rounds them, then writes y = x (W0 - W2) + L tt + b for tile t.
// Out-of-range neighbour tiles are zero blocks and are skipped.  bf16
// tensor cores (WMMA) with float32 accumulation; one launch per conv.
//
// Bound on the H100: counted at the Laplacian's nonzeros, device memory
// (x read once, y written once).  This first version recomputes the halo
// projections ((4k+1) and (2k+1) tiles per output tile), multiplies dense
// band blocks and does not pipeline its loads; see fused_cheby.cu.
#include "common.cuh"

using namespace p2m;

namespace {

constexpr int FOC = 32;  // output channels per block
constexpr int NJ = FOC / 16;

__global__ void __launch_bounds__(kThreads)
commuted_kernel(const bf16* __restrict__ band, const bf16* __restrict__ x,
                const bf16* __restrict__ Wc, const bf16* __restrict__ bias,
                bf16* __restrict__ out, int nt, int k, int B, int F, int Fo,
                int Fo_pad, int relu) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nbd = 2 * k + 1, nu = 4 * k + 1;
  const int t = blockIdx.x, bi = blockIdx.y, oc = blockIdx.z * FOC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  bf16* u = reinterpret_cast<bf16*>(smem);       // (nu, T, FOC): tiles t-2k..t+2k
  bf16* tt = u + (long)nu * kT * FOC;            // (nbd, T, FOC): tiles t-k..t+k
  float* st = reinterpret_cast<float*>(tt + (long)nbd * kT * FOC) + warp * 16 * FOC;
  const long ldx = (long)B * F;
  const bf16* xb = x + (long)bi * F;             // vertex row v at xb + v*ldx
  const bf16* W0 = Wc + oc;
  const bf16* W1 = Wc + (long)F * Fo_pad + oc;
  const bf16* W2 = Wc + 2L * F * Fo_pad + oc;
  const long tile = (long)kT * kT;

  // u = x W2
  for (int ai = 0; ai < nu; ++ai) {
    const int a = t - 2 * k + ai;
    if (a < 0 || a >= nt) continue;
    FragC acc[NJ];
    zero(acc);
    rows_mma(acc, xb + ((long)a * kT + r0) * ldx, ldx, W2, Fo_pad, F);
    stage(st, acc);
    bf16* dst = u + ((long)ai * kT + r0) * FOC;
    for (int e = lane; e < 16 * FOC; e += 32) dst[e] = to_bf(st[e]);
    __syncwarp();
  }
  __syncthreads();

  // tt = x W1 + 2 L u
  for (int ai = 0; ai < nbd; ++ai) {
    const int a = t - k + ai;
    if (a < 0 || a >= nt) continue;
    FragC hop[NJ], acc[NJ];
    zero(hop);
    zero(acc);
    for (int d = 0; d < nbd; ++d) {
      const int src = a + d - k;
      if (src < 0 || src >= nt) continue;
      band_rows_mma(hop, band + ((long)d * nt + a) * tile + r0 * kT,
                    u + (long)(src - (t - 2 * k)) * kT * FOC, FOC);
    }
    rows_mma(acc, xb + ((long)a * kT + r0) * ldx, ldx, W1, Fo_pad, F);
    for (int j = 0; j < NJ; ++j)
      for (int i = 0; i < acc[j].num_elements; ++i) acc[j].x[i] += 2.0f * hop[j].x[i];
    stage(st, acc);
    bf16* dst = tt + ((long)ai * kT + r0) * FOC;
    for (int e = lane; e < 16 * FOC; e += 32) dst[e] = to_bf(st[e]);
    __syncwarp();
  }
  __syncthreads();

  // y = x (W0 - W2) + L tt + b
  FragC acc[NJ];
  zero(acc);
  rows_mma(acc, xb + ((long)t * kT + r0) * ldx, ldx, W0, Fo_pad, F);
  for (int d = 0; d < nbd; ++d) {
    const int src = t + d - k;
    if (src < 0 || src >= nt) continue;
    band_rows_mma(acc, band + ((long)d * nt + t) * tile + r0 * kT,
                  tt + (long)d * kT * FOC, FOC);
  }
  stage(st, acc);
  const long ldo = (long)B * Fo;
  bf16* ot = out + ((long)t * kT * B + bi) * Fo;
  for (int e = lane; e < 16 * FOC; e += 32) {
    const int r = r0 + e / FOC, c = oc + e % FOC;
    if (c >= Fo) continue;
    float v = st[e] + to_f(bias[c]);
    if (relu) v = fmaxf(v, 0.0f);
    ot[r * ldo + c] = to_bf(v);
  }
}

}  // namespace

// Returns a cudaError_t.
extern "C" int p2m_fused_cheby_conv_commuted(const void* band, const void* x,
                                             const void* Wc, const void* bias, void* out,
                                             int nt, int k, int B, int F, int Fo,
                                             int Fo_pad, int relu, void* stream) {
  const size_t smem = (size_t)(6 * k + 2) * kT * FOC * sizeof(bf16)
                      + (size_t)kWarps * 16 * FOC * sizeof(float);
  if (smem > (size_t)kMaxSmem || Fo_pad % FOC) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      commuted_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  commuted_kernel<<<dim3(nt, B, Fo_pad / FOC), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(band), static_cast<const bf16*>(x),
      static_cast<const bf16*>(Wc), static_cast<const bf16*>(bias),
      static_cast<bf16*>(out), nt, k, B, F, Fo, Fo_pad, relu);
  return cudaGetLastError();
}

extern "C" const char* p2m_fused_cheby_commuted_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
