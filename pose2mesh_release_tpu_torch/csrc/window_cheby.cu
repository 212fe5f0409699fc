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
// (Vp, B, F); W (3F, Fo_pad) basis-major, zero-padded to Fo_pad (a multiple
// of 16); bias (Fout,); skip (Vp, B, Fs); skip_w (Fs, Fo_pad); out (Vp, B,
// Fout); all bf16.
//
// Design: that of fused_cheby.cu with the hops read through the window:
// one thread block per (row tile t, batch element); for each chunk of FC
// input channels it computes z1 = L x on the 2k+1 tiles that make up rows
// [s_t, s_t + Wd) (tile a as one (T, Wd) slab of win against x rows
// [s_a, s_a + Wd)) into shared memory, then z2 = 2 L z1 - x on tile t as one
// (T, Wd) slab against that halo; z1 and z2 of tile t for all F channels stay
// in shared memory for the K=3F projection, bias, ReLU and the residual
// epilogue.  bf16 tensor cores (WMMA) with float32 accumulation; z1 and z2
// are rounded to bf16 where the TPU kernel rounds them.  One launch per conv.
//
// Bound on the H100: as fused_cheby.cu, device memory (x read once, y
// written once) at the operator's nonzeros.  This first version recomputes
// the z1 halo and multiplies the dense (T, Wd) slabs, so it sits far from
// that bound.
#include "common.cuh"

using namespace p2m;

namespace {

template <int FC>
__global__ void __launch_bounds__(kThreads)
window_cheby_kernel(const bf16* __restrict__ win, const int* __restrict__ woff,
                    const bf16* __restrict__ x, const bf16* __restrict__ W,
                    const bf16* __restrict__ bias, const bf16* __restrict__ skip,
                    const bf16* __restrict__ skip_w, bf16* __restrict__ out, int k, int B,
                    int F, int Fout, int Fo_pad, int Fs, int relu, int skip_mode) {
  constexpr int NJ = FC / 16;
  constexpr int ST = 16 * (FC > 32 ? FC : 32);  // staging floats per warp
  extern __shared__ __align__(128) unsigned char smem[];
  const int nbd = 2 * k + 1, Wd = nbd * kT;
  const int t = blockIdx.x, bi = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;  // this warp's 16 rows of the tile
  bf16* z1h = reinterpret_cast<bf16*>(smem);    // (nbd*T, FC): z1 on rows s_t .. s_t+Wd
  bf16* z1f = z1h + (long)nbd * kT * FC;        // (T, F) z1 of tile t
  bf16* z2f = z1f + (long)kT * F;               // (T, F) z2 of tile t
  float* st = reinterpret_cast<float*>(z2f + (long)kT * F) + warp * ST;
  const long ldx = (long)B * F;
  const bf16* xb = x + (long)bi * F;            // vertex row v at xb + v*ldx
  const bf16* xt = xb + (long)t * kT * ldx;     // this block's row tile
  const int a0 = woff[t] / kT;                  // first tile of the window
  const bf16* wt = win + ((long)t * kT + r0) * Wd;

  for (int c0 = 0; c0 < F; c0 += FC) {
    // hop 1: z1 = L x on tiles a0 .. a0+2k, channels [c0, c0+FC)
    for (int ai = 0; ai < nbd; ++ai) {
      const int a = a0 + ai;
      FragC acc[NJ];
      zero(acc);
      rows_mma(acc, win + ((long)a * kT + r0) * Wd, Wd, xb + (long)woff[a] * ldx + c0,
               ldx, Wd);
      stage(st, acc);
      bf16* dst = z1h + ((long)ai * kT + r0) * FC;
      for (int e = lane; e < 16 * FC; e += 32) {
        const bf16 v = to_bf(st[e]);
        dst[e] = v;
        if (a == t) z1f[(long)(r0 + e / FC) * F + c0 + e % FC] = v;
      }
      __syncwarp();
    }
    __syncthreads();
    // hop 2: z2 = 2 L z1 - x on tile t
    {
      FragC acc[NJ];
      zero(acc);
      rows_mma(acc, wt, Wd, z1h, FC, Wd);
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
cudaError_t launch(const void* win, const void* woff, const void* x, const void* W,
                   const void* bias, const void* skip, const void* skip_w, void* out, int nt,
                   int k, int B, int F, int Fout, int Fo_pad, int Fs, int relu,
                   int skip_mode, cudaStream_t stream) {
  const size_t smem = ((size_t)(2 * k + 1) * kT * FC + 2 * (size_t)kT * F) * sizeof(bf16)
                      + (size_t)kWarps * 16 * (FC > 32 ? FC : 32) * sizeof(float);
  if (smem > (size_t)kMaxSmem || nt < 2 * k + 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      window_cheby_kernel<FC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  window_cheby_kernel<FC><<<dim3(nt, B), kThreads, smem, stream>>>(
      static_cast<const bf16*>(win), static_cast<const int*>(woff),
      static_cast<const bf16*>(x), static_cast<const bf16*>(W),
      static_cast<const bf16*>(bias), static_cast<const bf16*>(skip),
      static_cast<const bf16*>(skip_w), static_cast<bf16*>(out), k, B, F, Fout, Fo_pad, Fs,
      relu, skip_mode);
  return cudaGetLastError();
}

}  // namespace

// skip_mode: 0 none, 1 add (Fs == Fout), 2 projection through skip_w.
// fc: input-channel chunk (16, 32 or 64, dividing F).  Returns a cudaError_t.
extern "C" int p2m_window_cheby_conv(const void* win, const void* woff, const void* x,
                                     const void* W, const void* bias, const void* skip,
                                     const void* skip_w, void* out, int nt, int k, int B,
                                     int F, int Fout, int Fo_pad, int Fs, int relu,
                                     int skip_mode, int fc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fc) {
    case 16:
      return launch<16>(win, woff, x, W, bias, skip, skip_w, out, nt, k, B, F, Fout, Fo_pad,
                        Fs, relu, skip_mode, s);
    case 32:
      return launch<32>(win, woff, x, W, bias, skip, skip_w, out, nt, k, B, F, Fout, Fo_pad,
                        Fs, relu, skip_mode, s);
    case 64:
      return launch<64>(win, woff, x, W, bias, skip, skip_w, out, nt, k, B, F, Fout, Fo_pad,
                        Fs, relu, skip_mode, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* p2m_window_cheby_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
