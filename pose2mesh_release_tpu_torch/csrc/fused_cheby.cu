// Fused K=3 Chebyshev graph conv on a block-banded Laplacian (deploy form).
//
//   y = act([x, Lx, 2L(Lx) - x] @ W + b)  (+ skip | + skip @ skip_w)
//
// Replaces the TPU kernel `fused_conv_flat` (pose2mesh_release_tpu/ops/
// pallas_cheby.py, kernel body `_fused_kernel_factory`).
//
// Layout: band (2k+1, nt, T, T), x (nt*T, B, F), W (3F, Fo_pad) basis-major
// and zero-padded to Fo_pad (a multiple of 16), bias (Fout,), skip
// (nt*T, B, Fs), skip_w (Fs, Fo_pad), out (nt*T, B, Fout); all bf16.
//
// Design: one thread block per (row tile t, batch element).  The block
// walks its (2k+1) band blocks itself: for each chunk of FC input channels
// it computes z1 = Lx on tiles t-k..t+k into a shared-memory halo, then
// z2 = 2 L z1 - x on tile t, keeping z1 and z2 of tile t for all F channels
// in shared memory; the K=3F projection, bias, ReLU and the residual
// epilogue follow, and only y goes to device memory.  Out-of-range
// neighbour tiles are zero blocks and are skipped.  Products run on bf16
// tensor cores (WMMA) with float32 accumulation; z1 and z2 are rounded to
// bf16 where the TPU kernel rounds them.  One launch per conv; nothing
// carries across blocks.
//
// Bound on the H100: the band blocks are ~2% nonzero, so counted at the
// nonzeros the conv does few operations per byte and is bound by device
// memory (x read once, y written once).  This first version recomputes
// the z1 halo (2k+1 times), multiplies dense T x T band blocks and loads
// operands straight from L2 without pipelining, so it sits far from that
// bound; wgmma, TMA and multi-tile row groups are later work.
#include "common.cuh"

using namespace p2m;

namespace {

template <int FC>
__global__ void __launch_bounds__(kThreads)
fused_cheby_kernel(const bf16* __restrict__ band, const bf16* __restrict__ x,
                   const bf16* __restrict__ W, const bf16* __restrict__ bias,
                   const bf16* __restrict__ skip, const bf16* __restrict__ skip_w,
                   bf16* __restrict__ out, int nt, int k, int B, int F, int Fout,
                   int Fo_pad, int Fs, int relu, int skip_mode) {
  constexpr int NJ = FC / 16;
  constexpr int ST = 16 * (FC > 32 ? FC : 32);  // staging floats per warp
  extern __shared__ __align__(128) unsigned char smem[];
  const int nbd = 2 * k + 1;
  const int t = blockIdx.x, bi = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;  // this warp's 16 rows of the tile
  bf16* z1h = reinterpret_cast<bf16*>(smem);    // (nbd, T, FC) halo chunk
  bf16* z1f = z1h + (long)nbd * kT * FC;        // (T, F) z1 of tile t
  bf16* z2f = z1f + (long)kT * F;               // (T, F) z2 of tile t
  float* st = reinterpret_cast<float*>(z2f + (long)kT * F) + warp * ST;
  const long ldx = (long)B * F;
  const bf16* xb = x + (long)bi * F;            // vertex row v at xb + v*ldx
  const bf16* xt = xb + (long)t * kT * ldx;     // this block's row tile
  const long tile = (long)kT * kT;

  for (int c0 = 0; c0 < F; c0 += FC) {
    // hop 1: z1 = L x on tiles t-k .. t+k, channels [c0, c0+FC)
    for (int ai = 0; ai < nbd; ++ai) {
      const int a = t + ai - k;
      if (a < 0 || a >= nt) continue;
      FragC acc[NJ];
      zero(acc);
      for (int d = 0; d < nbd; ++d) {
        const int src = a + d - k;
        if (src < 0 || src >= nt) continue;
        band_rows_mma(acc, band + ((long)d * nt + a) * tile + r0 * kT,
                      xb + (long)src * kT * ldx + c0, ldx);
      }
      stage(st, acc);
      bf16* dst = z1h + ((long)ai * kT + r0) * FC;
      for (int e = lane; e < 16 * FC; e += 32) {
        const bf16 v = to_bf(st[e]);
        dst[e] = v;
        if (ai == k) z1f[(long)(r0 + e / FC) * F + c0 + e % FC] = v;
      }
      __syncwarp();
    }
    __syncthreads();
    // hop 2: z2 = 2 L z1 - x on tile t
    {
      FragC acc[NJ];
      zero(acc);
      for (int d = 0; d < nbd; ++d) {
        const int src = t + d - k;
        if (src < 0 || src >= nt) continue;
        band_rows_mma(acc, band + ((long)d * nt + t) * tile + r0 * kT,
                      z1h + (long)d * kT * FC, FC);
      }
      stage(st, acc);
      for (int e = lane; e < 16 * FC; e += 32) {
        const int r = r0 + e / FC, c = c0 + e % FC;
        z2f[(long)r * F + c] = to_bf(2.0f * st[e] - to_f(xt[r * ldx + c]));
      }
      __syncwarp();
    }
    __syncthreads();
  }

  // projection [x, z1, z2] @ W + b, activation, residual epilogue
  const long lds = (long)B * Fs;
  const bf16* sk = skip_mode ? skip + ((long)t * kT * B + bi) * Fs : nullptr;
  bf16* ot = out + ((long)t * kT * B + bi) * Fout;
  const long ldo = (long)B * Fout;
  for (int ct = 0; ct < Fo_pad / 16; ++ct) {
    FragC acc[1];
    zero(acc);
    rows_mma(acc, xt + r0 * ldx, ldx, W + ct * 16, Fo_pad, F);
    rows_mma(acc, z1f + (long)r0 * F, F, W + (long)F * Fo_pad + ct * 16, Fo_pad, F);
    rows_mma(acc, z2f + (long)r0 * F, F, W + 2L * F * Fo_pad + ct * 16, Fo_pad, F);
    stage(st, acc);
    if (skip_mode == 2) {
      FragC sacc[1];
      zero(sacc);
      rows_mma(sacc, sk + r0 * lds, lds, skip_w + ct * 16, Fo_pad, Fs);
      stage(st + 256, sacc);
    }
    for (int e = lane; e < 256; e += 32) {
      const int r = r0 + e / 16, c = ct * 16 + e % 16;
      if (c >= Fout) continue;
      float v = st[e] + to_f(bias[c]);
      if (relu) v = fmaxf(v, 0.0f);
      if (skip_mode == 1) v += to_f(sk[r * lds + c]);
      else if (skip_mode == 2) v += st[256 + e];
      ot[r * ldo + c] = to_bf(v);
    }
    __syncwarp();
  }
}

template <int FC>
cudaError_t launch(const void* band, const void* x, const void* W, const void* bias,
                   const void* skip, const void* skip_w, void* out, int nt, int k,
                   int B, int F, int Fout, int Fo_pad, int Fs, int relu, int skip_mode,
                   cudaStream_t stream) {
  const size_t smem = ((size_t)(2 * k + 1) * kT * FC + 2 * (size_t)kT * F) * sizeof(bf16)
                      + (size_t)kWarps * 16 * (FC > 32 ? FC : 32) * sizeof(float);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_cheby_kernel<FC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fused_cheby_kernel<FC><<<dim3(nt, B), kThreads, smem, stream>>>(
      static_cast<const bf16*>(band), static_cast<const bf16*>(x),
      static_cast<const bf16*>(W), static_cast<const bf16*>(bias),
      static_cast<const bf16*>(skip), static_cast<const bf16*>(skip_w),
      static_cast<bf16*>(out), nt, k, B, F, Fout, Fo_pad, Fs, relu, skip_mode);
  return cudaGetLastError();
}

}  // namespace

// skip_mode: 0 none, 1 add (Fs == Fout), 2 projection through skip_w.
// fc: input-channel chunk (16, 32 or 64, dividing F).  Returns a cudaError_t.
extern "C" int p2m_fused_cheby_conv(const void* band, const void* x, const void* W,
                                    const void* bias, const void* skip,
                                    const void* skip_w, void* out, int nt, int k, int B,
                                    int F, int Fout, int Fo_pad, int Fs, int relu,
                                    int skip_mode, int fc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fc) {
    case 16:
      return launch<16>(band, x, W, bias, skip, skip_w, out, nt, k, B, F, Fout, Fo_pad,
                        Fs, relu, skip_mode, s);
    case 32:
      return launch<32>(band, x, W, bias, skip, skip_w, out, nt, k, B, F, Fout, Fo_pad,
                        Fs, relu, skip_mode, s);
    case 64:
      return launch<64>(band, x, W, bias, skip, skip_w, out, nt, k, B, F, Fout, Fo_pad,
                        Fs, relu, skip_mode, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* p2m_fused_cheby_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
