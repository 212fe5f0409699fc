// Fused K=3 Chebyshev graph conv of the training step (forward).
//
//   u = x, or relu(x*s + c) with (s, c) the previous BatchNorm's affine
//   y = [u, Lu, 2L(Lu) - u] @ W + b,   optionally (sum y, sum y^2) per channel
//
// Replaces the TPU kernel `_fused_call` (pose2mesh_release_tpu/ops/
// pallas_cheby.py, kernel body `_fused_kernel_factory`) in its plain,
// emit_stats, in_fold and in_fold + emit_stats forms.
//
// Layout: band (2k+1, nt, T, T); x (V, B, F) at the real row count V <= nt*T;
// W (3F, Fo_pad) basis-major, zero-padded to Fo_pad (a multiple of 16); bias
// (Fout,); fold scale and shift (F,); y (V, B, Fout); all bf16.  Rows >= V
// read as zero and are never written, so nothing of a pad row reaches the
// statistics or, in the backward, the gradients.
//
// Design: a persistent grid of a fixed number of blocks walks the work items
// (row tile t, batch element, FO-wide slice of the output channels).  Per item
// and per chunk of FC input channels the block stages u on tiles t-2k..t+2k in
// shared memory (masking rows >= V, applying the fold), computes z1 = Lu on
// tiles t-k..t+k and z2 = 2 L z1 - u on tile t on bf16 tensor cores (WMMA,
// float32 accumulation), rounds both to bf16 where the TPU kernel does, and
// adds the chunk's share of the projection to accumulators held in registers.
// Bias, statistics, rounding and the store follow.  The statistics are taken
// from the float32 values after the bias, over real rows only.  Each block
// keeps its partial sums in shared memory (one lane per column and warp, rows
// in order) and writes them once; a second launch adds the blocks' partials in
// block order.  No atomics: two runs give equal bits.
//
// Bound on the H100: counted at the band's nonzeros the conv does few
// operations per byte and is bound by device memory (x read once, y written
// once).  This first version recomputes the z1 halo per item and per output
// slice, multiplies dense T x T band blocks (~2% nonzero), stages operands
// with scalar loads and does not pipeline, so it sits far from that bound.
#include "common.cuh"

using namespace p2m;

namespace {

template <int FC, int NJO>
__global__ void __launch_bounds__(kThreads)
train_conv_kernel(const bf16* __restrict__ band, const bf16* __restrict__ x,
                  const bf16* __restrict__ W, const bf16* __restrict__ bias,
                  const bf16* __restrict__ fold_s, const bf16* __restrict__ fold_c,
                  bf16* __restrict__ out, float* __restrict__ part, int V, int nt, int k,
                  int B, int F, int Fout, int Fo_pad, int emit_stats) {
  constexpr int FO = NJO * 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = warp * 16;
  bf16* uh = reinterpret_cast<bf16*>(smem);         // (4k+1, T, FC) u halo
  bf16* z1h = uh + (long)(4 * k + 1) * kT * FC;     // (2k+1, T, FC) z1 halo
  bf16* z2 = z1h + (long)(2 * k + 1) * kT * FC;     // (T, FC) z2 of tile t
  float* st = reinterpret_cast<float*>(z2 + kT * FC) + warp * 16 * FC;
  float* ssum = reinterpret_cast<float*>(z2 + kT * FC) + kWarps * 16 * FC;
  float* ssq = ssum + kWarps * Fo_pad;                // (kWarps, Fo_pad) each
  if (emit_stats)
    for (int e = threadIdx.x; e < 2 * kWarps * Fo_pad; e += kThreads) ssum[e] = 0.0f;

  const long ldx = (long)B * F;
  const int nz = Fo_pad / FO, items = nt * B * nz;
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const int oz = w % nz, bi = (w / nz) % B, t = w / (nz * B);
    FragC acc[NJO];
    zero(acc);
    for (int c0 = 0; c0 < F; c0 += FC) {
      stage_halo<FC>(uh, x + (long)bi * F, ldx, t, k, V, F, c0, fold_s, fold_c);
      cheby_hops<FC>(band, uh, z1h, z2, st, t, nt, k);
      // this chunk's share of [u, z1, z2] @ W for the warp's 16 rows
      const bf16* wc = W + (long)c0 * Fo_pad + oz * FO;
      rows_mma(acc, uh + ((long)2 * k * kT + r0) * FC, FC, wc, Fo_pad, FC);
      rows_mma(acc, z1h + ((long)k * kT + r0) * FC, FC, wc + (long)F * Fo_pad, Fo_pad, FC);
      rows_mma(acc, z2 + (long)r0 * FC, FC, wc + 2L * F * Fo_pad, Fo_pad, FC);
      __syncthreads();  // the next chunk overwrites the halos
    }
    const int v0 = t * kT + r0;  // the warp's first vertex row
    for (int j = 0; j < NJO; ++j) {
      wmma::store_matrix_sync(st, acc[j], 16, wmma::mem_row_major);
      __syncwarp();
      const int cj = oz * FO + j * 16;
      if (emit_stats && lane < 16 && cj + lane < Fout) {
        const float bc = to_f(bias[cj + lane]);
        float s = 0.0f, s2 = 0.0f;
        for (int r = 0; r < 16 && v0 + r < V; ++r) {
          const float y = st[r * 16 + lane] + bc;
          s += y;
          s2 += y * y;
        }
        ssum[warp * Fo_pad + cj + lane] += s;
        ssq[warp * Fo_pad + cj + lane] += s2;
      }
      for (int e = lane; e < 256; e += 32) {
        const int v = v0 + e / 16, c = cj + e % 16;
        if (v < V && c < Fout)
          out[((long)v * B + bi) * Fout + c] = to_bf(st[e] + to_f(bias[c]));
      }
      __syncwarp();
    }
  }
  if (emit_stats) {
    __syncthreads();
    for (int c = threadIdx.x; c < Fout; c += kThreads) {
      float s = 0.0f, s2 = 0.0f;
      for (int i = 0; i < kWarps; ++i) {
        s += ssum[i * Fo_pad + c];
        s2 += ssq[i * Fo_pad + c];
      }
      part[(long)blockIdx.x * 2 * Fout + c] = s;
      part[(long)blockIdx.x * 2 * Fout + Fout + c] = s2;
    }
  }
}

template <int FC, int NJO>
cudaError_t launch(const void* band, const void* x, const void* W, const void* bias,
                   const void* fold_s, const void* fold_c, void* out, float* part,
                   float* stats, int V, int nt, int k, int B, int F, int Fout, int Fo_pad,
                   int emit_stats, int grid, cudaStream_t stream) {
  const size_t smem = hop_smem(FC, k) + 2 * (size_t)kWarps * Fo_pad * sizeof(float);
  if (smem > (size_t)kMaxSmem || Fo_pad % (NJO * 16) || F % FC) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      train_conv_kernel<FC, NJO>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  train_conv_kernel<FC, NJO><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(band), static_cast<const bf16*>(x),
      static_cast<const bf16*>(W), static_cast<const bf16*>(bias),
      static_cast<const bf16*>(fold_s), static_cast<const bf16*>(fold_c),
      static_cast<bf16*>(out), part, V, nt, k, B, F, Fout, Fo_pad, emit_stats);
  err = cudaGetLastError();
  if (err != cudaSuccess || !emit_stats) return err;
  return launch_reduce(part, grid, 2 * Fout, stats, stream);
}

template <int FC>
cudaError_t launch_fo(int fo, const void* band, const void* x, const void* W,
                      const void* bias, const void* fold_s, const void* fold_c, void* out,
                      float* part, float* stats, int V, int nt, int k, int B, int F,
                      int Fout, int Fo_pad, int emit_stats, int grid, cudaStream_t s) {
  switch (fo) {
#define P2M_FO(N)                                                                      \
  case N * 16:                                                                         \
    return launch<FC, N>(band, x, W, bias, fold_s, fold_c, out, part, stats, V, nt, k, \
                         B, F, Fout, Fo_pad, emit_stats, grid, s);
    P2M_FO(1) P2M_FO(2) P2M_FO(4) P2M_FO(8)
#undef P2M_FO
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// fold_s / fold_c: null without the fold.  part: (grid, 2*Fout) float32
// scratch and stats: (2, Fout) float32 [sum y; sum y^2], used with emit_stats.
// fc: input-channel chunk (16, 32 or 64, dividing F); fo: output channels per
// work item (16, 32, 64 or 128, dividing Fo_pad); grid: the persistent grid's
// block count.  Returns a cudaError_t.
extern "C" int p2m_train_conv(const void* band, const void* x, const void* W,
                              const void* bias, const void* fold_s, const void* fold_c,
                              void* out, void* part, void* stats, int V, int nt, int k,
                              int B, int F, int Fout, int Fo_pad, int emit_stats, int fc,
                              int fo, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* st = static_cast<float*>(stats);
  switch (fc) {
    case 16:
      return launch_fo<16>(fo, band, x, W, bias, fold_s, fold_c, out, p, st, V, nt, k, B,
                           F, Fout, Fo_pad, emit_stats, grid, s);
    case 32:
      return launch_fo<32>(fo, band, x, W, bias, fold_s, fold_c, out, p, st, V, nt, k, B,
                           F, Fout, Fo_pad, emit_stats, grid, s);
    case 64:
      return launch_fo<64>(fo, band, x, W, bias, fold_s, fold_c, out, p, st, V, nt, k, B,
                           F, Fout, Fo_pad, emit_stats, grid, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* p2m_train_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
