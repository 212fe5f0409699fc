// Fused backward of the training step's K=3 Chebyshev graph conv.
//
//   g1 = L g,  h2 = 2 L g1 - g          (both rounded to bf16)
//   G  = [g, g1, h2]                    (V*B, 3*Fout)
//   du = G @ [W0^T; W1^T; W2^T]         (float32)
//   dW = u^T G, db = sum g              (float32; dW returned basis-major)
//   without fold: dx = du;  with fold (u = relu(t), t = x*s + c):
//   dx = (du * 1[t > 0]) * s, ds = sum (du * 1[t > 0]) * x, dc = sum du * 1[t > 0]
//
// Replaces the TPU kernel `_fused_bwd_call` (pose2mesh_release_tpu/ops/
// pallas_cheby.py, kernel body `_bwd_kernel_factory`), with and without
// in_fold.  L is symmetric, so the backward hops the cotangent with the same
// band blocks and never recomputes the forward's basis.
//
// Layout: band (2k+1, nt, T, T); g (V, B, Fout) and x (V, B, F) at the real
// row count V; Wt (Gw, Fp) = [W0^T; W1^T; W2^T] with each block's rows padded
// to Fo_pad (a multiple of 16), Gw = 3*Fo_pad rounded up to 64 and Fp = F
// rounded up to 64, zero elsewhere; bf16 operands, float32 sums.
//
// Design, in launches on one stream (the wrapper counts them as one call):
//   1. hop: a persistent grid walks (row tile, batch element); per chunk of FC
//      cotangent channels it stages g on tiles t-2k..t+2k (rows >= V zero),
//      runs the two hops on bf16 tensor cores (WMMA, float32 accumulation),
//      and writes the rows of G to device memory (G is (Mp, Gw) bf16, Mp =
//      V*B rounded up to 128; the wrapper zeroes rows >= V*B, this kernel the
//      pad columns).  Each block keeps its db partial in shared memory.
//   2. dx: G @ Wt in 128 x 64 tiles with the fold's mask and scale in the
//      epilogue; ds and dc partials per block as for db.
//   3. dW: u^T G as K-split products: block (f tile, G-column tile, row slice)
//      stages u (the fold applied, rows >= V*B zero) and writes one float32
//      partial tile; nothing is accumulated across blocks.
//   4. the partials are added in a fixed order (dW into the basis-major
//      (3F, Fout) layout; db; ds and dc).  No atomics: equal bits run to run.
// The TPU kernel keeps G in VMEM and accumulates dW in its own body across an
// ordered grid; here G goes through device memory once and dW is a second
// hand-written product over it.
//
// Bound on the H100: two hops counted at the band's nonzeros plus the dx and
// dW products (3*Fout x F per row each) over ~V*B rows; at F, Fout >= 64 the
// products' operations about match the bytes of g, x and dx, so the bound is
// near the balance point.  This first version writes and re-reads G,
// multiplies dense T x T band blocks, stages with scalar loads and does not
// pipeline, so it sits far from that bound.
#include "common.cuh"

using namespace p2m;

namespace {

using FragAc = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;

template <int FC>
__global__ void __launch_bounds__(kThreads)
bwd_hop_kernel(const bf16* __restrict__ band, const bf16* __restrict__ g,
               bf16* __restrict__ G, float* __restrict__ part, int V, int nt, int k, int B,
               int Fout, int Fo_pad, int Gw) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = warp * 16;
  bf16* gh = reinterpret_cast<bf16*>(smem);         // (4k+1, T, FC) g halo
  bf16* g1h = gh + (long)(4 * k + 1) * kT * FC;     // (2k+1, T, FC) g1 halo
  bf16* h2 = g1h + (long)(2 * k + 1) * kT * FC;     // (T, FC) h2 of tile t
  float* st = reinterpret_cast<float*>(h2 + kT * FC) + warp * 16 * FC;
  float* sdb = reinterpret_cast<float*>(h2 + kT * FC) + kWarps * 16 * FC;  // (kWarps, Fo_pad)
  for (int e = threadIdx.x; e < kWarps * Fo_pad; e += kThreads) sdb[e] = 0.0f;

  const long ldg = (long)B * Fout;
  const int tail = Gw - 3 * Fo_pad;
  for (int w = blockIdx.x; w < nt * B; w += gridDim.x) {
    const int bi = w % B, t = w / B;
    const int v0 = t * kT + r0;  // the warp's first vertex row
    for (int c0 = 0; c0 < Fo_pad; c0 += FC) {
      stage_halo<FC>(gh, g + (long)bi * Fout, ldg, t, k, V, Fout, c0, nullptr, nullptr);
      cheby_hops<FC>(band, gh, g1h, h2, st, t, nt, k);
      const bf16* gt = gh + ((long)2 * k * kT + r0) * FC;
      const bf16* g1t = g1h + ((long)k * kT + r0) * FC;
      const bf16* h2t = h2 + (long)r0 * FC;
      for (int e = lane; e < 16 * FC; e += 32) {
        const int v = v0 + e / FC;
        if (v >= V) continue;
        bf16* row = G + ((long)v * B + bi) * Gw + c0 + e % FC;
        row[0] = gt[e];
        row[Fo_pad] = g1t[e];
        row[2 * Fo_pad] = h2t[e];
      }
      for (int c = lane; c < FC; c += 32) {
        float s = 0.0f;
        for (int r = 0; r < 16 && v0 + r < V; ++r) s += to_f(gt[r * FC + c]);
        sdb[warp * Fo_pad + c0 + c] += s;
      }
      __syncthreads();  // the next chunk overwrites the halos
    }
    for (int e = threadIdx.x; e < kT * tail; e += kThreads) {
      const int v = t * kT + e / tail;
      if (v < V) G[((long)v * B + bi) * Gw + 3 * Fo_pad + e % tail] = to_bf(0.0f);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < Fout; c += kThreads) {
    float s = 0.0f;
    for (int i = 0; i < kWarps; ++i) s += sdb[i * Fo_pad + c];
    part[(long)blockIdx.x * Fout + c] = s;
  }
}

// dx = G @ Wt over M = V*B rows, 128 x 64 tiles; fold epilogue and ds/dc partials.
__global__ void __launch_bounds__(kThreads)
bwd_dx_kernel(const bf16* __restrict__ G, const bf16* __restrict__ Wt,
              const bf16* __restrict__ x, const bf16* __restrict__ fold_s,
              const bf16* __restrict__ fold_c, bf16* __restrict__ dx,
              float* __restrict__ part, int M, int F, int Fp, int Gw) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* st = reinterpret_cast<float*>(smem) + warp * 256;
  float* sds = reinterpret_cast<float*>(smem) + kWarps * 256;  // (kWarps, Fp)
  float* sdc = sds + kWarps * Fp;
  const bool fold = fold_s != nullptr;
  if (fold)
    for (int e = threadIdx.x; e < 2 * kWarps * Fp; e += kThreads) sds[e] = 0.0f;
  __syncthreads();

  const int nn = Fp / 64, items = (M + 127) / 128 * nn;
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const int m0 = (w / nn) * 128 + warp * 16, f0 = (w % nn) * 64;
    FragC acc[4];
    zero(acc);
    rows_mma(acc, G + (long)m0 * Gw, Gw, Wt + f0, Fp, Gw);
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(st, acc[j], 16, wmma::mem_row_major);
      __syncwarp();
      const int fj = f0 + j * 16;
      for (int e = lane; e < 256; e += 32) {
        const int m = m0 + e / 16, f = fj + e % 16;
        if (m >= M || f >= F) continue;
        float d = st[e];
        if (fold) {
          const float s = to_f(fold_s[f]);
          const float t = __fadd_rn(__fmul_rn(to_f(x[(long)m * F + f]), s), to_f(fold_c[f]));
          d = t > 0.0f ? d * s : 0.0f;
        }
        dx[(long)m * F + f] = to_bf(d);
      }
      if (fold && lane < 16 && fj + lane < F) {
        const int f = fj + lane;
        const float s = to_f(fold_s[f]), c = to_f(fold_c[f]);
        float a = 0.0f, b = 0.0f;
        for (int r = 0; r < 16 && m0 + r < M; ++r) {
          const float xv = to_f(x[(long)(m0 + r) * F + f]);
          const float t = __fadd_rn(__fmul_rn(xv, s), c);
          const float d = t > 0.0f ? st[r * 16 + lane] : 0.0f;
          a += d * xv;
          b += d;
        }
        sds[warp * Fp + f] += a;
        sdc[warp * Fp + f] += b;
      }
      __syncwarp();
    }
  }
  if (fold) {
    __syncthreads();
    for (int f = threadIdx.x; f < F; f += kThreads) {
      float a = 0.0f, b = 0.0f;
      for (int i = 0; i < kWarps; ++i) {
        a += sds[i * Fp + f];
        b += sdc[i * Fp + f];
      }
      part[(long)blockIdx.x * 2 * F + f] = a;
      part[(long)blockIdx.x * 2 * F + F + f] = b;
    }
  }
}

// One K-slice of dW_cf = u^T G: block (f tile fm, G-column tile nn, slice s)
// writes part[s][fm*64 .. +64][nn*64 .. +64].  Warp w owns f rows (w % 4)*16
// and G columns (w / 4)*32 .. +32 of the tile.
__global__ void __launch_bounds__(kThreads)
bwd_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ G,
              const bf16* __restrict__ fold_s, const bf16* __restrict__ fold_c,
              float* __restrict__ part, int M, int Mp, int F, int Fp, int Gw, int S,
              int slice_rows) {
  __shared__ __align__(128) bf16 us[64 * 64];  // u rows m0 .. m0+64, f tile
  const int warp = threadIdx.x / 32;
  const int ng = Gw / 64;
  const int s = blockIdx.x % S, nn = (blockIdx.x / S) % ng, fm = blockIdx.x / (S * ng);
  const int fw = (warp % 4) * 16, cw = nn * 64 + (warp / 4) * 32;
  FragC acc[2];
  zero(acc);
  const int m_end = min(Mp, (s + 1) * slice_rows);
  for (int m0 = s * slice_rows; m0 < m_end; m0 += 64) {
    for (int e = threadIdx.x; e < 64 * 64; e += kThreads) {
      const int m = m0 + e / 64, f = fm * 64 + e % 64;
      bf16 u = to_bf(0.0f);
      if (m < M && f < F) {
        u = x[(long)m * F + f];
        if (fold_s)
          u = to_bf(fmaxf(__fadd_rn(__fmul_rn(to_f(u), to_f(fold_s[f])), to_f(fold_c[f])),
                          0.0f));
      }
      us[e] = u;
    }
    __syncthreads();
    for (int kk = 0; kk < 64; kk += 16) {
      FragAc fa;  // (f, m) = us[m * 64 + f]
      wmma::load_matrix_sync(fa, us + kk * 64 + fw, 64);
      for (int j = 0; j < 2; ++j) {
        FragB fb;
        wmma::load_matrix_sync(fb, G + (long)(m0 + kk) * Gw + cw + j * 16, Gw);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();
  }
  float* out = part + ((long)s * Fp + fm * 64 + fw) * Gw + cw;
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(out + j * 16, acc[j], Gw, wmma::mem_row_major);
}

// dW[(b*F + f)*Fout + o] = sum over s of part[s][f][b*Fo_pad + o], s in order.
__global__ void dw_reduce_kernel(const float* __restrict__ part, int S, int F, int Fp,
                                 int Gw, int Fout, int Fo_pad, float* __restrict__ dW) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 3 * F * Fout) return;
  const int o = i % Fout, f = (i / Fout) % F, b = i / (Fout * F);
  const float* p = part + (long)f * Gw + b * Fo_pad + o;
  float sum = 0.0f;
  for (int s = 0; s < S; ++s) sum += p[(long)s * Fp * Gw];
  dW[i] = sum;
}

template <int FC>
cudaError_t launch_hop(const void* band, const void* g, void* G, float* part, int V,
                       int nt, int k, int B, int Fout, int Fo_pad, int Gw, int grid,
                       cudaStream_t stream) {
  const size_t smem = hop_smem(FC, k) + (size_t)kWarps * Fo_pad * sizeof(float);
  if (smem > (size_t)kMaxSmem || Fo_pad % FC) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_hop_kernel<FC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  bwd_hop_kernel<FC><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(band), static_cast<const bf16*>(g), static_cast<bf16*>(G),
      part, V, nt, k, B, Fout, Fo_pad, Gw);
  return cudaGetLastError();
}

}  // namespace

// Pointers: band, g, x, Wt, fold_s, fold_c (null without the fold) in; G
// (Mp, Gw) bf16 scratch; dx (V, B, F) bf16, dW (3F, Fout), db (Fout,) and
// dsdc (2, F) [ds; dc] float32 out; part_hop (grid_hop, Fout), part_dx
// (grid_dx, 2F) and part_dw (S, Fp, Gw) float32 scratch.  fc: cotangent-channel
// chunk (16, 32 or 64, dividing Fo_pad); S row slices of slice_rows rows (a
// multiple of 64) for dW.  Returns a cudaError_t.
extern "C" int p2m_fused_cheby_bwd(const void* band, const void* g, const void* x,
                                   const void* Wt, const void* fold_s, const void* fold_c,
                                   void* G, void* dx, void* dW, void* db, void* dsdc,
                                   void* part_hop, void* part_dx, void* part_dw, int V,
                                   int nt, int k, int B, int F, int Fout, int Fo_pad,
                                   int Gw, int Fp, int fc, int grid_hop, int grid_dx, int S,
                                   int slice_rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ph = static_cast<float*>(part_hop);
  float* px = static_cast<float*>(part_dx);
  float* pw = static_cast<float*>(part_dw);
  const int M = V * B, Mp = (M + 127) / 128 * 128;
  if (Gw % 64 || Fp % 64 || slice_rows % 64) return cudaErrorInvalidValue;
  cudaError_t err;
  switch (fc) {
    case 16: err = launch_hop<16>(band, g, G, ph, V, nt, k, B, Fout, Fo_pad, Gw, grid_hop, s); break;
    case 32: err = launch_hop<32>(band, g, G, ph, V, nt, k, B, Fout, Fo_pad, Gw, grid_hop, s); break;
    case 64: err = launch_hop<64>(band, g, G, ph, V, nt, k, B, Fout, Fo_pad, Gw, grid_hop, s); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;

  const size_t smem_dx = ((size_t)kWarps * 256 + 2 * (size_t)kWarps * Fp) * sizeof(float);
  err = cudaFuncSetAttribute(bwd_dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dx);
  if (err != cudaSuccess) return err;
  bwd_dx_kernel<<<grid_dx, kThreads, smem_dx, s>>>(
      static_cast<const bf16*>(G), static_cast<const bf16*>(Wt),
      static_cast<const bf16*>(x), static_cast<const bf16*>(fold_s),
      static_cast<const bf16*>(fold_c), static_cast<bf16*>(dx), px, M, F, Fp, Gw);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  bwd_dw_kernel<<<(Fp / 64) * (Gw / 64) * S, kThreads, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(G),
      static_cast<const bf16*>(fold_s), static_cast<const bf16*>(fold_c), pw, M, Mp, F,
      Fp, Gw, S, slice_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int n = 3 * F * Fout;
  dw_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(pw, S, F, Fp, Gw, Fout, Fo_pad,
                                                   static_cast<float*>(dW));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = launch_reduce(ph, grid_hop, Fout, static_cast<float*>(db), s)) != cudaSuccess)
    return err;
  if (fold_s) return launch_reduce(px, grid_dx, 2 * F, static_cast<float*>(dsdc), s);
  return cudaSuccess;
}

extern "C" const char* p2m_fused_cheby_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
