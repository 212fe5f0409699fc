// The projection of the K=3 Chebyshev convs, one GEMM over three operands:
//
//   y[m, :Fout] = epi(A0[m] W0 + A1[m] W1 + A2[m] W2 + b)   for m < M
//
// A0, A1, A2 are (M, F) row-major (u or x, z1 = L u, z2 = 2 L z1 - u),
// read as the three K-blocks of the basis-major W (3F, Np) = [W0; W1; W2];
// nothing is concatenated.  The operand type T is bf16 (float32
// accumulation, one rounding to bf16) or float32 (the float32 instances:
// 3xTF32 products on wgmma, cheby_proj_f32_kernel, and nothing rounded);
// every operand and output but the float32 scratch and statistics is of
// type T.
// Used by the training conv K1 (csrc/fused_cheby_train.cu), the group
// deploy conv (csrc/fused_cheby.cu) and the strip and window convs in basis
// order (csrc/strip_cheby.cu) after two launches of the hop engine
// (band_hop.cuh) have written z1 and z2, and by the commuted deploy conv
// (csrc/fused_cheby_commuted.cu) and the strip conv in commuted order before
// their two hops.
//
// Epilogues (a template parameter, so each instance carries only its own):
//   kEpiBias   y = acc + b
//   kEpiStats  y = acc + b, and per column the float32 sums of y and y^2 over
//              the M rows (after the bias, before rounding): one partial per
//              block, rows in a fixed order, each (row group, column) slot in
//              shared memory owned by one lane; launch_reduce adds the
//              blocks' partials in block order.  No atomics.
//   kEpiDeploy y = act(acc + b), then + skip (Fs == Fout) or + skip @ skip_w:
//              the skip projection is a fourth K-loop into the same
//              registers, run after the bias and the ReLU are applied.
//   kEpiCommuted one operand x (M, F) against Wc (3F, fo) = [W0 - W2; W1; W2]
//              (fo = Np / 3, Fout rounded up to 16): the output columns are
//              three blocks of fo, and a tile (BN divides fo) lies in one
//              block s, whose K-loop reads Wc's rows sF .. (s+1)F.  Block 0
//              writes a = x (W0 - W2) + b and block 1 p1 = x W1 to yf (2, M,
//              fo) in float32, unrounded as the TPU kernel adds them; block 2
//              writes p2 = x W2 to y (M, fo) in T.  Packed pairs straight
//              from registers (float2 / bf16x2), no staging.
//   kEpiCommutedT the same three blocks, all stored to y (3, M, fo) in T:
//              [p | t0 | u] = T([x (W0 - W2) + b | x W1 | x W2]), the strip
//              kernel's rounding points (in float32 none).
//   kEpiF32    one operand, one block: yf (M, Np) = A0 W in float32, no
//              bias (the strip conv's skip projection skip @ skip_w, added
//              after the activation by its last hop).
//
// Design (Hopper; mma.sync m16n8k16 bf16 on tensor cores):
//   * Output tiles of 128 rows x BN columns (BN 16, 32, 64 or 128; W padded
//     to Np, a multiple of BN, so Fout = 3 computes 16 columns and stores
//     3); a persistent grid walks the tiles m-major, so the blocks in flight
//     share the rows of A in L2.
//   * A and W k-tiles of 32 rows through a 3-stage 16-byte cp.async ring in
//     shared memory (rows >= M and k >= K zero-filled by the copy),
//     fragments by ldmatrix (.trans for W).
//   * The tile is staged in shared memory as T and written with 16-byte
//     stores where Fout is a multiple of the vector, element by element
//     otherwise.
//   * float32 (cheby_proj_f32_kernel, gemm_f32.cuh): the same 128 x BN
//     tiles (BN up to 128), one warp-specialized block an SM: a producer
//     warpgroup copies 32-deep k-tiles of A and W raw into a cp.async ring
//     and splits each element once into double-buffered TF32 planes (W
//     transposed to K-major by that pass), two consumer warpgroups (64 rows
//     each) run three wgmma.m64nBNk8 products a k8 step into a k-tile
//     partial and one IEEE add a k-tile; the epilogues store from
//     registers.
// Bound on the H100: at F, Fout >= 64 the product does ~3 Fout / 2 operations
// per byte of A, far below the 295 of the tensor cores' balance point, so
// device memory bounds it: A0-A2 read once (M x 3F bf16), y written once.
#pragma once

#include "gemm_f32.cuh"

namespace p2m {

constexpr int kEpiBias = 0, kEpiStats = 1, kEpiDeploy = 2, kEpiCommuted = 3,
              kEpiCommutedT = 4, kEpiF32 = 5;
constexpr int kProjBM = 128;           // output tile rows
constexpr int kProjBK = 32;            // k-tile rows
constexpr int kProjStages = 3;         // cp.async ring depth
constexpr int kProjBlocksPerSm = 2;    // registers: at most 128 a thread
// staged A row stride: 16 bytes of pad (bf16), 4 elements (float32)
template <typename T>
__host__ __device__ constexpr int proj_ald() { return kProjBK + (sizeof(T) == 2 ? 8 : 4); }

template <typename T>
struct ProjArgsT {
  const T* a[3];        // A0, A1, A2: (M, F)
  const T* W;           // (3F, Np) basis-major, zero beyond Fout
  const T* bias;        // (Fout,)
  const T* skip;        // kEpiDeploy: (M, Fs), or null
  const T* skip_w;      // kEpiDeploy: (Fs, Np) for the skip projection, null for the add
  T* y;                 // (M, Fout)
  float* part;          // kEpiStats: (gridDim.x, 2 Fout) [sum y; sum y^2] per block
  int M, F, Fout, Np, Fs, relu;
  float* yf = nullptr;  // kEpiCommuted: (2, M, Np / 3) float32 [a; p1]; kEpiF32: (M, Np)
};
using ProjArgs = ProjArgsT<bf16>;

// the epilogues of one operand x against column blocks of W (commuted_tile)
__host__ __device__ constexpr bool proj_blocks(int epi) {
  return epi == kEpiCommuted || epi == kEpiCommutedT || epi == kEpiF32;
}

// warps across the tile's columns: 2 for BN >= 64, else 1
__host__ __device__ constexpr int proj_wc(int BN) { return BN >= 64 ? 2 : 1; }

// the float32 instance's producer threads (two warpgroups, beside two
// consumer warpgroups: registers rebalanced by setmaxnreg)
constexpr int kProjProducer = 256;
// the float32 instances' raw ring: 3 stages, 2 where 128-column planes and
// the statistics' slots would pass a block's 227 KB
__host__ __device__ constexpr int proj_f32_stages(int BN, bool stats) {
  return BN == 128 && stats ? 2 : 3;
}

// Dynamic shared memory of the projection (ops/fused_cheby.py proj_smem):
// the ring, or the staged output tile if larger, then the statistics slots
// (float32: the planes and the raw ring, then the slots of 8 row groups).
template <typename T>
__host__ __device__ constexpr size_t proj_smem(int BN, int Np, bool stats) {
  if (sizeof(T) == 4)
    return gemm_f32_smem(kProjBM, BN, proj_f32_stages(BN, stats)) +
           (stats ? (size_t)2 * kWarps * Np * sizeof(float) : 0);
  const size_t ring =
      (size_t)kProjStages * (kProjBM * proj_ald<T>() + kProjBK * (BN + 8)) * sizeof(T);
  const size_t tile = (size_t)kProjBM * (BN + 8) * sizeof(T);
  return (ring > tile ? ring : tile) +
         (stats ? (size_t)2 * (kWarps / proj_wc(BN)) * Np * sizeof(float) : 0);
}

// ops[b] for b < 3 without indexing the parameter array at run time
template <typename T>
__device__ __forceinline__ const T* proj_operand(const ProjArgsT<T>& p, int b) {
  return b == 0 ? p.a[0] : (b == 1 ? p.a[1] : p.a[2]);
}

// acc += [ops over K columns] @ Wk[:, n0 .. n0+BN) for the tile at row m0,
// Wk of row stride ldw.  The k-th column of the operand block is column
// k % lda of operand k / lda (the skip and the commuted conv: one operand,
// lda = K).  Warp (wr, wc) owns rows wr*WM .. +WM and columns wc*WN .. +WN
// of the tile.  Ends with the ring drained and synced.
template <int BN, typename T, int MI, int NI>
__device__ __forceinline__ void proj_kloop(float (&acc)[MI][NI][4], const ProjArgsT<T>& p,
                                           bool skip_ops, int lda, int K, const T* Wk,
                                           int ldw, int m0, int n0, T* As, T* Bs) {
  constexpr int WC = proj_wc(BN), WM = kProjBM / (kWarps / WC), WN = BN / WC;
  constexpr int ALD = proj_ald<T>(), LDB = BN + 8, SA = kProjBM * ALD, SB = kProjBK * LDB;
  constexpr int VE = vec_elems<T>();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp / WC, wc = warp % WC;
  const int KT = (K + kProjBK - 1) / kProjBK;
  auto load = [&](int buf, int kt) {
    T* a_s = As + buf * SA;
    T* b_s = Bs + buf * SB;
    for (int e = threadIdx.x; e < kProjBM * kProjBK / VE; e += kThreads) {
      const int r = e / (kProjBK / VE), c = (e % (kProjBK / VE)) * VE;
      const int kk = kt * kProjBK + c;
      const long m = m0 + r;
      const bool ok = m < p.M && kk < K;
      const int b = ok ? kk / lda : 0;
      const T* src = skip_ops ? p.skip : proj_operand(p, b);
      cp_async16(a_s + r * ALD + c, ok ? src + m * lda + (kk - b * lda) : Wk, ok);
    }
    for (int e = threadIdx.x; e < kProjBK * BN / VE; e += kThreads) {
      const int r = e / (BN / VE), c = (e % (BN / VE)) * VE;
      const int kk = kt * kProjBK + r;
      cp_async16(b_s + r * LDB + c, kk < K ? Wk + (long)kk * ldw + n0 + c : Wk, kk < K);
    }
  };
#pragma unroll
  for (int s = 0; s < kProjStages - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kProjStages - 2>();
    __syncthreads();
    if (kt + kProjStages - 1 < KT) load((kt + kProjStages - 1) % kProjStages, kt + kProjStages - 1);
    cp_async_commit();
    const T* a_s = As + (kt % kProjStages) * SA;
    const T* b_s = Bs + (kt % kProjStages) * SB;
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int k16 = 0; k16 < kProjBK; k16 += 16) {
        unsigned af[MI][4];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          ldmatrix_x4(af[mi], a_s + (wr * WM + mi * 16 + lane % 16) * ALD + k16 +
                                  (lane / 16) * 8);
#pragma unroll
        for (int q = 0; q < NI / 2; ++q) {
          unsigned bq[4];
          ldmatrix_x4_trans(bq, b_s + (k16 + lane % 16) * LDB + wc * WN + q * 16 +
                                    (lane / 16) * 8);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            mma16816(acc[mi][2 * q], af[mi], bq[0], bq[1]);
            mma16816(acc[mi][2 * q + 1], af[mi], bq[2], bq[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
}

// The epilogues of proj_blocks: the tile (m0, n0) of [a | p1 | p2]
// (kEpiCommuted), of [p | t0 | u] (kEpiCommutedT) or of the one block
// (kEpiF32), stored from registers.
template <int BN, int EPI, typename T, int MI, int NI>
__device__ __forceinline__ void commuted_tile(float (&acc)[MI][NI][4], const ProjArgsT<T>& p,
                                              int m0, int n0, T* As, T* Bs) {
  constexpr int WC = proj_wc(BN), WM = kProjBM / (kWarps / WC), WN = BN / WC;
  const int fo = EPI == kEpiF32 ? p.Np : p.Np / 3, s = n0 / fo, nl = n0 - s * fo;
  proj_kloop<BN>(acc, p, false, p.F, p.F, p.W + (long)s * p.F * fo, fo, m0, nl, As, Bs);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, cq = lane & 3, wr = warp / WC, wc = warp % WC;
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    const int f = nl + wc * WN + ni * 8 + 2 * cq;
    const float b0 = s == 0 && p.bias && f < p.Fout ? to_f(p.bias[f]) : 0.0f;
    const float b1 = s == 0 && p.bias && f + 1 < p.Fout ? to_f(p.bias[f + 1]) : 0.0f;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long m = m0 + wr * WM + mi * 16 + gq + 8 * h;
        if (m >= p.M) continue;
        const float v0 = acc[mi][ni][2 * h] + b0, v1 = acc[mi][ni][2 * h + 1] + b1;
        if (EPI == kEpiCommutedT)
          store2(p.y + ((long)s * p.M + m) * fo + f, v0, v1);
        else if (EPI == kEpiCommuted && s == 2)
          store2(p.y + m * fo + f, v0, v1);
        else
          *reinterpret_cast<float2*>(p.yf + ((long)s * p.M + m) * fo + f) = make_float2(v0, v1);
      }
  }
}

template <typename T, int BN, int EPI>
__global__ void __launch_bounds__(kThreads, kProjBlocksPerSm)
cheby_proj_kernel(ProjArgsT<T> p) {
  constexpr int WC = proj_wc(BN), WR = kWarps / WC;
  constexpr int WM = kProjBM / WR, WN = BN / WC, MI = WM / 16, NI = WN / 8;
  constexpr int LDO = BN + 8, VE = vec_elems<T>();
  constexpr size_t kRing = proj_smem<T>(BN, 0, false);
  extern __shared__ __align__(128) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + kProjStages * kProjBM * proj_ald<T>();
  T* os = As;  // (kProjBM, LDO) output tile, over the ring after the k-loops
  float* ssum = reinterpret_cast<float*>(smem + kRing);  // (WR, Np)
  float* ssq = ssum + WR * p.Np;                         // (WR, Np)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, cq = lane & 3, wr = warp / WC, wc = warp % WC;
  if constexpr (EPI == kEpiStats) {
    for (int e = threadIdx.x; e < 2 * WR * p.Np; e += kThreads) ssum[e] = 0.0f;
    __syncthreads();
  }

  const int nn = p.Np / BN, items = (p.M + kProjBM - 1) / kProjBM * nn;
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const int m0 = (w / nn) * kProjBM, n0 = (w % nn) * BN;
    float acc[MI][NI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.0f;
    if constexpr (proj_blocks(EPI)) {
      commuted_tile<BN, EPI>(acc, p, m0, n0, As, Bs);
      continue;  // the k-loop ended with the ring drained and synced: the next tile refills it
    }
    proj_kloop<BN>(acc, p, false, p.F, 3 * p.F, p.W, p.Np, m0, n0, As, Bs);

    // bias (and the activation) in registers
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int f = n0 + wc * WN + ni * 8 + 2 * cq;
      const float b0 = f < p.Fout ? to_f(p.bias[f]) : 0.0f;
      const float b1 = f + 1 < p.Fout ? to_f(p.bias[f + 1]) : 0.0f;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = acc[mi][ni][2 * h] + b0, v1 = acc[mi][ni][2 * h + 1] + b1;
          if (EPI == kEpiDeploy && p.relu) {
            v0 = fmaxf(v0, 0.0f);
            v1 = fmaxf(v1, 0.0f);
          }
          acc[mi][ni][2 * h] = v0;
          acc[mi][ni][2 * h + 1] = v1;
        }
    }
    if constexpr (EPI == kEpiDeploy) {
      if (p.skip_w)  // + skip @ skip_w, after the activation
        proj_kloop<BN>(acc, p, true, p.Fs, p.Fs, p.skip_w, p.Np, m0, n0, As, Bs);
    }

    if constexpr (EPI == kEpiStats) {
      // column sums over the warp's rows (lanes of equal lane % 4), then into
      // the (row group, column) slot this lane alone owns
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        float s[2] = {0.0f, 0.0f}, q[2] = {0.0f, 0.0f};
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (m0 + wr * WM + mi * 16 + gq + 8 * h >= p.M) continue;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float v = acc[mi][ni][2 * h + j];
              s[j] += v;
              q[j] += v * v;
            }
          }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int off = 4; off < 32; off *= 2) {
            s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
            q[j] += __shfl_xor_sync(0xffffffffu, q[j], off);
          }
        if (gq == 0)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int f = n0 + wc * WN + ni * 8 + 2 * cq + j;
            if (f < p.Fout) {
              ssum[wr * p.Np + f] += s[j];
              ssq[wr * p.Np + f] += q[j];
            }
          }
      }
    }

    // stage the tile as T (the skip add in float32 first)
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wr * WM + mi * 16 + gq + 8 * h;
        const long m = m0 + r;
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const int cl = wc * WN + ni * 8 + 2 * cq, f = n0 + cl;
          float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
          if constexpr (EPI == kEpiDeploy) {
            if (p.skip && !p.skip_w && m < p.M) {
              if (f < p.Fout) v0 += to_f(p.skip[m * p.Fs + f]);
              if (f + 1 < p.Fout) v1 += to_f(p.skip[m * p.Fs + f + 1]);
            }
          }
          store2(os + r * LDO + cl, v0, v1);
        }
      }
    __syncthreads();
    if (p.Fout % VE == 0) {
      for (int e = threadIdx.x; e < kProjBM * BN / VE; e += kThreads) {
        const int r = e / (BN / VE), c = (e % (BN / VE)) * VE;
        const long m = m0 + r;
        if (m < p.M && n0 + c < p.Fout)
          *reinterpret_cast<uint4*>(p.y + m * p.Fout + n0 + c) =
              *reinterpret_cast<const uint4*>(os + r * LDO + c);
      }
    } else {
      for (int e = threadIdx.x; e < kProjBM * BN; e += kThreads) {
        const int r = e / BN, c = e % BN;
        const long m = m0 + r;
        if (m < p.M && n0 + c < p.Fout) p.y[m * p.Fout + n0 + c] = os[r * LDO + c];
      }
    }
    __syncthreads();  // the next tile's loads refill the ring
  }
  if constexpr (EPI == kEpiStats) {
    for (int f = threadIdx.x; f < p.Fout; f += kThreads) {
      float s = 0.0f, q = 0.0f;
      for (int i = 0; i < WR; ++i) {
        s += ssum[i * p.Np + f];
        q += ssq[i * p.Np + f];
      }
      p.part[(long)blockIdx.x * 2 * p.Fout + f] = s;
      p.part[(long)blockIdx.x * 2 * p.Fout + p.Fout + f] = q;
    }
  }
}

// The float32 projection, warp-specialized on wgmma (gemm_f32.cuh): the
// contract of cheby_proj_kernel (every epilogue, the persistent grid over
// 128 x BN tiles m-major), one block an SM of two consumer warpgroups and
// a producer warpgroup.  The producer walks the block's tiles' k-tiles in
// one sequence (the three operands' K-blocks, or x against Wc's block s,
// then the skip projection's), copies each raw into the ring and splits it
// into the planes; consumer warp w owns rows 16 w .. +16 of the tile and all
// BN columns, and stores its results straight from registers.
template <int BN, int EPI>
__global__ void __launch_bounds__(kThreads + kProjProducer, 1)
cheby_proj_f32_kernel(ProjArgsT<float> p) {
  constexpr int NI = BN / 8, S = proj_f32_stages(BN, EPI == kEpiStats);
  constexpr int NT = kThreads + kProjProducer;
  extern __shared__ __align__(128) unsigned char smem[];
  const F32Smem sm(smem, kProjBM, BN);
  float* ssum = reinterpret_cast<float*>(smem + gemm_f32_smem(kProjBM, BN, S));  // (8, Np)
  float* ssq = ssum + kWarps * p.Np;                                             // (8, Np)
  if constexpr (EPI == kEpiStats)
    for (int e = threadIdx.x; e < 2 * kWarps * p.Np; e += NT) ssum[e] = 0.0f;
  __syncthreads();

  constexpr bool kBlocks = proj_blocks(EPI);
  const int fo = EPI == kEpiF32 ? p.Np : p.Np / 3;  // a column block of kBlocks
  const int nn = p.Np / BN, items = (p.M + kProjBM - 1) / kProjBM * nn;
  const int tiles = (int)blockIdx.x < items ? (items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int K = kBlocks ? p.F : 3 * p.F, KT = (K + kF32BK - 1) / kF32BK;
  const int KT2 = EPI == kEpiDeploy && p.skip_w ? (p.Fs + kF32BK - 1) / kF32BK : 0;
  const int T = KT + KT2;  // k-tiles a tile

  if (threadIdx.x >= kThreads) {  // the producer warpgroups
    regs_producer();
    const int t = threadIdx.x - kThreads;
    auto load = [&](int st, int q) {
      const int w = blockIdx.x + (q / T) * gridDim.x, j = q % T;
      const int m0 = (w / nn) * kProjBM, n0 = (w % nn) * BN;
      const bool skip_ops = j >= KT;
      const int kt = skip_ops ? j - KT : j, s = kBlocks ? n0 / fo : 0;
      const int lda = skip_ops ? p.Fs : p.F, Kx = skip_ops ? p.Fs : K;
      const float* Wk = skip_ops ? p.skip_w : p.W + (long)s * p.F * fo;
      const int ldw = kBlocks && !skip_ops ? fo : p.Np, nl = n0 - s * fo;
      float* ra = sm.raw_a(st);
      float* rb = sm.raw_b(st);
      for (int e = t; e < kProjBM * kF32BK / 4; e += kProjProducer) {
        const int r = e >> 3, c = (e & 7) * 4, kk = kt * kF32BK + c;
        const long m = m0 + r;
        const bool ok = m < p.M && kk < Kx;
        const int b = ok ? kk / lda : 0;
        const float* src = skip_ops ? p.skip : proj_operand(p, b);
        cp_async16(ra + e * 4, ok ? src + m * lda + (kk - b * lda) : Wk, ok);
      }
      for (int e = t; e < kF32BK * BN / 4; e += kProjProducer) {
        const int r = e / (BN / 4), c = (e % (BN / 4)) * 4, kk = kt * kF32BK + r;
        cp_async16(rb + r * BN + c, kk < Kx ? Wk + (long)kk * ldw + nl + c : Wk, kk < Kx);
      }
    };
    f32_produce<S, kProjProducer>(tiles * T, NT, load, [&](int st, int, int b) {
      split_rows<kProjBM, kProjProducer>(sm.raw_a(st), sm.a_big(b), sm.a_small(b));
      split_cols<BN, kProjProducer>(sm.raw_b(st), sm.b_big(b), sm.b_small(b),
                                   [](float4&, int, int) {});
    });
    return;
  }

  // the consumer warpgroups
  regs_consumer();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, cq = lane & 3, a_row0 = (warp / 4) * 64;
  int q = 0;
  for (int i = 0; i < tiles; ++i) {
    const int w = blockIdx.x + i * gridDim.x;
    const int m0 = (w / nn) * kProjBM, n0 = (w % nn) * BN;
    const int s = kBlocks ? n0 / fo : 0, nl = n0 - s * fo;
    float acc[1][NI][4];
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[0][ni][j] = 0.0f;
    for (int kt = 0; kt < KT; ++kt) f32_consume<BN>(acc, sm, q++, a_row0, NT);

    // bias (and the activation) in registers
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int f = nl + ni * 8 + 2 * cq;
      const bool has_bias = p.bias && (!kBlocks || s == 0);
      const float b0 = has_bias && f < p.Fout ? p.bias[f] : 0.0f;
      const float b1 = has_bias && f + 1 < p.Fout ? p.bias[f + 1] : 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = acc[0][ni][2 * h] + b0, v1 = acc[0][ni][2 * h + 1] + b1;
        if (EPI == kEpiDeploy && p.relu) {
          v0 = fmaxf(v0, 0.0f);
          v1 = fmaxf(v1, 0.0f);
        }
        acc[0][ni][2 * h] = v0;
        acc[0][ni][2 * h + 1] = v1;
      }
    }
    for (int kt = 0; kt < KT2; ++kt) f32_consume<BN>(acc, sm, q++, a_row0, NT);  // + skip @ skip_w

    if constexpr (EPI == kEpiStats) {
      // column sums over the warp's rows (lanes of equal lane % 4), then into
      // the (row group, column) slot this lane alone owns
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        float sm0[2] = {0.0f, 0.0f}, sq[2] = {0.0f, 0.0f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (m0 + warp * 16 + gq + 8 * h >= p.M) continue;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float v = acc[0][ni][2 * h + j];
            sm0[j] += v;
            sq[j] += v * v;
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int off = 4; off < 32; off *= 2) {
            sm0[j] += __shfl_xor_sync(0xffffffffu, sm0[j], off);
            sq[j] += __shfl_xor_sync(0xffffffffu, sq[j], off);
          }
        if (gq == 0)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int f = n0 + ni * 8 + 2 * cq + j;
            if (f < p.Fout) {
              ssum[warp * p.Np + f] += sm0[j];
              ssq[warp * p.Np + f] += sq[j];
            }
          }
      }
    }

    if constexpr (EPI == kEpiDeploy) {  // the skip add in float32, every load before a store
      if (p.skip && !p.skip_w) {
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const int f = n0 + ni * 8 + 2 * cq;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const long m = m0 + warp * 16 + gq + 8 * h;
            if (m >= p.M) continue;
            if (p.Fs % 2 == 0 && f + 1 < p.Fout) {
              const float2 v = __ldg(reinterpret_cast<const float2*>(p.skip + m * p.Fs + f));
              acc[0][ni][2 * h] += v.x;
              acc[0][ni][2 * h + 1] += v.y;
            } else {
              if (f < p.Fout) acc[0][ni][2 * h] += __ldg(p.skip + m * p.Fs + f);
              if (f + 1 < p.Fout) acc[0][ni][2 * h + 1] += __ldg(p.skip + m * p.Fs + f + 1);
            }
          }
        }
      }
    }

    // stores straight from registers
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int f = nl + ni * 8 + 2 * cq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long m = m0 + warp * 16 + gq + 8 * h;
        if (m >= p.M) continue;
        const float v0 = acc[0][ni][2 * h], v1 = acc[0][ni][2 * h + 1];
        if constexpr (kBlocks) {
          if (EPI == kEpiCommutedT)
            store2(p.y + ((long)s * p.M + m) * fo + f, v0, v1);
          else if (EPI == kEpiCommuted && s == 2)
            store2(p.y + m * fo + f, v0, v1);
          else
            *reinterpret_cast<float2*>(p.yf + ((long)s * p.M + m) * fo + f) = make_float2(v0, v1);
        } else {
          float* y = p.y + m * p.Fout + f;
          if (p.Fout % 2 == 0 && f + 1 < p.Fout) {
            *reinterpret_cast<float2*>(y) = make_float2(v0, v1);
          } else {
            if (f < p.Fout) y[0] = v0;
            if (f + 1 < p.Fout) y[1] = v1;
          }
        }
      }
    }
  }
  if constexpr (EPI == kEpiStats) {
    bar_sync(kBarConsumer, kThreads);
    for (int f = threadIdx.x; f < p.Fout; f += kThreads) {
      float s = 0.0f, q2 = 0.0f;
      for (int i = 0; i < kWarps; ++i) {
        s += ssum[i * p.Np + f];
        q2 += ssq[i * p.Np + f];
      }
      p.part[(long)blockIdx.x * 2 * p.Fout + f] = s;
      p.part[(long)blockIdx.x * 2 * p.Fout + p.Fout + f] = q2;
    }
  }
}

template <typename T, int BN, int EPI>
inline cudaError_t launch_proj_bn(const ProjArgsT<T>& p, int grid, cudaStream_t stream) {
  const size_t smem = proj_smem<T>(BN, p.Np, EPI == kEpiStats);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 4) {
    cudaError_t err = cudaFuncSetAttribute(cheby_proj_f32_kernel<BN, EPI>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    cheby_proj_f32_kernel<BN, EPI><<<grid, kThreads + kProjProducer, smem, stream>>>(p);
  } else {
    cudaError_t err = cudaFuncSetAttribute(cheby_proj_kernel<T, BN, EPI>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    cheby_proj_kernel<T, BN, EPI><<<grid, kThreads, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

// One projection launch over the plan's grid (ops/fused_cheby.py proj_plan,
// commuted_plan): bn columns per tile (16, 32, 64 or 128, dividing Np, and
// with kEpiCommuted or kEpiCommutedT dividing Np / 3); with kEpiStats also
// the ordered reduction of the blocks' partials into stats (2, Fout).
template <int EPI, typename T>
inline cudaError_t launch_proj(const ProjArgsT<T>& p, int bn, int grid, float* stats,
                               cudaStream_t stream) {
  if (p.M <= 0 || p.F % 16 || p.Fout <= 0 || p.Fout > p.Np || bn <= 0 || p.Np % bn ||
      grid <= 0 || (p.skip_w && p.Fs % 16) || (p.skip && !p.skip_w && p.Fs != p.Fout))
    return cudaErrorInvalidValue;
  const int fo = EPI == kEpiF32 ? p.Np : p.Np / 3;  // a column block of proj_blocks
  if (proj_blocks(EPI) &&
      ((EPI != kEpiF32 && p.Np % 3) || fo % bn || fo % 16 || p.Fout > fo || p.skip ||
       (EPI != kEpiCommutedT) != (p.yf != nullptr) || (EPI == kEpiF32) == (p.y != nullptr) ||
       reinterpret_cast<uintptr_t>(p.yf) % 8))
    return cudaErrorInvalidValue;
  uintptr_t al = reinterpret_cast<uintptr_t>(p.a[0]) | reinterpret_cast<uintptr_t>(p.a[1]) |
                 reinterpret_cast<uintptr_t>(p.a[2]) | reinterpret_cast<uintptr_t>(p.W) |
                 reinterpret_cast<uintptr_t>(p.skip_w) |
                 (p.skip_w ? reinterpret_cast<uintptr_t>(p.skip) : 0) |
                 (p.Fout % vec_elems<T>() == 0 ? reinterpret_cast<uintptr_t>(p.y) : 0);
  if (al % 16) return cudaErrorMisalignedAddress;
  cudaError_t err;
  switch (bn) {
    case 16: err = launch_proj_bn<T, 16, EPI>(p, grid, stream); break;
    case 32: err = launch_proj_bn<T, 32, EPI>(p, grid, stream); break;
    case 64: err = launch_proj_bn<T, 64, EPI>(p, grid, stream); break;
    case 128: err = launch_proj_bn<T, 128, EPI>(p, grid, stream); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || EPI != kEpiStats) return err;
  return launch_reduce(p.part, grid, 2 * p.Fout, stats, stream);
}

}  // namespace p2m
