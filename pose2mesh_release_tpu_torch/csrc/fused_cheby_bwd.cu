// Fused backward of the training step's K=3 Chebyshev graph conv (K2).
//
//   g1 = L g,  h2 = 2 L g1 - g          (both rounded to bf16)
//   du = g W0^T + g1 W1^T + h2 W2^T     (float32)
//   dW = u^T [g, g1, h2], db = sum g    (float32; dW returned basis-major)
//   without fold: dx = du;  with fold (u = relu(t), t = x*s + c):
//   dx = (du * 1[t > 0]) * s, ds = sum (du * 1[t > 0]) * x, dc = sum du * 1[t > 0]
//
// Replaces the TPU kernel `_fused_bwd_call` (pose2mesh_release_tpu/ops/
// pallas_cheby.py, kernel body `_bwd_kernel_factory`), with and without
// in_fold.  L is symmetric, so the backward hops the cotangent with the same
// band blocks and never recomputes the forward's basis.
//
// Layout: band (2k+1, nt, T, T); g (V, B, Fo_pad) and x (V, B, F) at the real
// row count V (the wrapper pads g's channels to Fo_pad, a multiple of 16, only
// where Fout is not one); g1 and h2 (V, B, Fo_pad) in g's layout; bf16: Wt (Gw, Fp)
// = [W0^T; W1^T; W2^T] with each block's rows padded to Fo_pad, Gw = 3*Fo_pad
// rounded up to 64 and Fp = F rounded up to 64, zero elsewhere; bf16 operands,
// float32 sums; or float32 operands (the float32 instances, the `f32`
// argument: g1 and h2 not rounded, the hops by exact FFMA
// (band_hop_f32.cuh), dx and dW by 3xTF32 on wgmma (gemm_f32.cuh), and W
// read in its own basis-major layout (3F, Fo_pad) in place of Wt).
//
// Design, in launches on one stream (the wrapper counts them as one call):
//   1-2. g1 and h2: two launches of the banded hop engine (band_hop.cuh) over
//      g viewed as (V, B*Fo_pad): band resident per row tile, zero sub-tiles
//      skipped, cp.async staging, h2 = 2 L g1 - g rounded once.
//   3. dx: a tensor-core GEMM (mma.sync m16n8k16) of 128 x 64 output tiles
//      over K = 3*Fo_pad, the three operands g, g1, h2 read as the three
//      K-blocks (nothing is concatenated), Wt streamed in 32-row k-tiles;
//      A and B tiles through a 3-stage cp.async ring into shared memory,
//      fragments by ldmatrix; the fold's mask and scale in the epilogue, the
//      tile staged in shared memory and written with 16-byte stores; ds and
//      dc kept per block in shared memory, one owner lane per (row group,
//      column).
//   4. dW and db: split-K over row slices, block (f tile, G-column tile,
//      slice): u (x, or relu(x*s + c) formed in shared memory without FMA)
//      and the G columns through the same 3-stage ring, one float32 partial
//      tile per block; the blocks of the first f tile that hold g's columns
//      also sum them for db, rows in order.
//   5. the partials are added in a fixed order (dW into the basis-major
//      (3F, Fout) layout; db; ds and dc).  No atomics: equal bits run to run.
//   float32 (gemm_f32.cuh): warp-specialized blocks on wgmma, a producer
//      warpgroup copying 32-deep k-tiles raw into a cp.async ring and
//      splitting them once into double-buffered TF32 planes, consumer
//      warpgroups multiplying (three products a k8 step, a k-tile partial,
//      one IEEE add a k-tile) and storing from registers.  dx: 128 x DN
//      tiles (DN = 128 where Fp is a multiple of 128, else 64), two
//      consumers, one block an SM, W read as (3F, Fo_pad): each basis
//      block's rows f hold its k contiguously, K-major as it lies.  dW: 64 x
//      64 tiles, one consumer; u and G M-major, transposed to K-major and u
//      folded by the split pass, db from G's raw rows in order.  The
//      reductions as in bf16.
// The TPU kernel keeps G = [g, g1, h2] in VMEM and carries dW across its
// ordered grid; here g1 and h2 go through device memory once (about 2 x the
// bytes of g written and read again), and the products are separate passes.
//
// Bound on the H100: two hops counted at the band's nonzeros plus the dx and
// dW products (3*Fout x F per row each) over V*B rows; at F, Fout >= 64 the
// products' operations about match the bytes of g, x and dx, so the bound is
// near the balance point.
#include "gemm_f32.cuh"

using namespace p2m;

namespace {

// the three cotangent operands g, g1, h2, each (M, Fo_pad) row-major
template <typename T>
struct Cot {
  const T* op[3];
};

// cot.op[b] for b < 3 without indexing the parameter array at run time
template <typename T>
__device__ __forceinline__ const T* operand(const Cot<T>& cot, int b) {
  return b == 0 ? cot.op[0] : (b == 1 ? cot.op[1] : cot.op[2]);
}

constexpr int kBK = 32;                       // k-tile rows of both products
constexpr int kStages = 3;                    // cp.async ring depth (bf16)
constexpr int kDxBM = 128, kDxBN = 64;        // dx output tile (bf16)
constexpr int kBLd = kDxBN + 8, kOLd = kDxBN + 8;
constexpr int kStageB = kBK * kBLd;           // elements
constexpr int kDwThreads = 128;               // dW: 4 warps on a 64 x 64 tile
constexpr int kTLd = 64 + 8;                  // dW staged row stride (bf16)
constexpr int kALd = kBK + 8;                 // dx staged A row stride: 16 bytes of pad
constexpr int kStageA = kDxBM * kALd;         // elements

// dx's float32 tile width: 128 where Fp is a multiple of 128, else 64; its
// raw ring depth (2 at 128 columns, where the ds / dc slots beside 3 stages
// would pass 227 KB) and dW's (3)
__host__ __device__ constexpr int dx_f32_bn(int Fp) { return Fp % 128 ? 64 : 128; }
__host__ __device__ constexpr int dx_f32_stages(int DN) { return DN == 128 ? 2 : 3; }
constexpr int kDwF32Stages = 3;
// the float32 producers: two warpgroups, beside dx's two consumers
// (registers rebalanced by setmaxnreg) and dW's one
constexpr int kDxProducer = 256, kDwProducer = 256;

// Shared memory of the dx kernel (ops/fused_cheby_train.py dx_smem): the ring
// (float32: the planes and the raw ring), then the ds / dc slots of each row
// group (bf16 4, float32 8).
template <typename T>
__host__ __device__ constexpr size_t dx_smem(int Fp) {
  if (sizeof(T) == 2)
    return (size_t)kStages * (kStageA + kStageB) * sizeof(T) + 8 * (size_t)Fp * sizeof(float);
  return gemm_f32_smem(kDxBM, dx_f32_bn(Fp), dx_f32_stages(dx_f32_bn(Fp))) +
         2 * kWarps * (size_t)Fp * sizeof(float);
}

// Shared memory of the dW kernel (dw_smem): bf16 static, float32 dynamic.
template <typename T>
__host__ __device__ constexpr size_t dw_smem() {
  return sizeof(T) == 2 ? 2 * (size_t)kStages * kBK * kTLd * sizeof(T)
                        : gemm_f32_smem(64, 64, kDwF32Stages);
}

// dx = [g, g1, h2] @ Wt over M = V*B rows; fold epilogue and ds/dc partials.
// Warp (wr, wc) = (warp / 2, warp % 2) owns rows 32 wr .. +32 and columns
// 32 wc .. +32 of the tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_dx_kernel(Cot<T> cot, const T* __restrict__ Wt, const T* __restrict__ x,
              const T* __restrict__ fold_s, const T* __restrict__ fold_c,
              T* __restrict__ dx, float* __restrict__ part, int M, int F, int Fo_pad,
              int Gw, int Fp) {
  constexpr int VE = vec_elems<T>();
  extern __shared__ __align__(128) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + kStages * kStageA;
  float* sds = reinterpret_cast<float*>(Bs + kStages * kStageB);  // (4, Fp)
  float* sdc = sds + 4 * Fp;                                       // (4, Fp)
  T* os = As;  // (kDxBM, kOLd) output tile, over the ring after the k loop
  const bool fold = fold_s != nullptr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, cq = lane & 3, wr = warp >> 1, wc = warp & 1;
  for (int e = threadIdx.x; e < 8 * Fp; e += kThreads) sds[e] = 0.0f;
  __syncthreads();

  const int nn = Fp / kDxBN, items = (M + kDxBM - 1) / kDxBM * nn, KT = Gw / kBK;
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const int m0 = (w / nn) * kDxBM, n0 = (w % nn) * kDxBN;
    auto load = [&](int buf, int kt) {
      T* a_s = As + buf * kStageA;
      T* b_s = Bs + buf * kStageB;
      for (int e = threadIdx.x; e < kDxBM * kBK / VE; e += kThreads) {
        const int r = e / (kBK / VE), c = (e % (kBK / VE)) * VE;
        const int kk = kt * kBK + c, b = kk / Fo_pad, o = kk % Fo_pad;
        const long m = m0 + r;
        const bool ok = m < M && b < 3;
        cp_async16(a_s + r * kALd + c, ok ? operand(cot, b) + m * Fo_pad + o : Wt, ok);
      }
      for (int e = threadIdx.x; e < kBK * kDxBN / VE; e += kThreads) {
        const int r = e / (kDxBN / VE), c = (e % (kDxBN / VE)) * VE;
        cp_async16(b_s + r * kBLd + c, Wt + (long)(kt * kBK + r) * Fp + n0 + c, true);
      }
    };
    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.0f;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < KT) load(s, s);
      cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      if (kt + kStages - 1 < KT) load((kt + kStages - 1) % kStages, kt + kStages - 1);
      cp_async_commit();
      const T* a_s = As + (kt % kStages) * kStageA;
      const T* b_s = Bs + (kt % kStages) * kStageB;
#pragma unroll
      for (int k16 = 0; k16 < kBK; k16 += 16) {
        unsigned af[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldmatrix_x4(af[mi], a_s + (wr * 32 + mi * 16 + lane % 16) * kALd + k16 +
                                  (lane / 16) * 8);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          unsigned bq[4];
          ldmatrix_x4_trans(bq, b_s + (k16 + lane % 16) * kBLd + wc * 32 + p * 16 +
                                    (lane / 16) * 8);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma16816(acc[mi][2 * p], af[mi], bq[0], bq[1]);
            mma16816(acc[mi][2 * p + 1], af[mi], bq[2], bq[3]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring: os reuses it

    float ps[4][2], pc[4][2];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) ps[ni][0] = ps[ni][1] = pc[ni][0] = pc[ni][1] = 0.0f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wr * 32 + mi * 16 + gq + 8 * h;
        const long m = m0 + r;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int cl = wc * 32 + ni * 8 + 2 * cq, f = n0 + cl;
          float d0 = acc[mi][ni][2 * h], d1 = acc[mi][ni][2 * h + 1];
          if (fold && m < M && f < F) {
            const float2 xv = load2(x + m * F + f);
            const float2 sv = load2(fold_s + f);
            const float2 cv = load2(fold_c + f);
            d0 = __fadd_rn(__fmul_rn(xv.x, sv.x), cv.x) > 0.0f ? d0 : 0.0f;
            d1 = __fadd_rn(__fmul_rn(xv.y, sv.y), cv.y) > 0.0f ? d1 : 0.0f;
            ps[ni][0] += d0 * xv.x;
            ps[ni][1] += d1 * xv.y;
            pc[ni][0] += d0;
            pc[ni][1] += d1;
            d0 *= sv.x;
            d1 *= sv.y;
          }
          store2(os + r * kOLd + cl, d0, d1);
        }
      }
    if (fold) {
      // column sums over the warp's 32 rows (lanes of equal lane % 4), then
      // into the (row group, column) slot this lane alone owns
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int off = 4; off < 32; off *= 2) {
            ps[ni][j] += __shfl_xor_sync(0xffffffffu, ps[ni][j], off);
            pc[ni][j] += __shfl_xor_sync(0xffffffffu, pc[ni][j], off);
          }
      if (gq == 0)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int f = n0 + wc * 32 + ni * 8 + 2 * cq + j;
            if (f < F) {
              sds[wr * Fp + f] += ps[ni][j];
              sdc[wr * Fp + f] += pc[ni][j];
            }
          }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kDxBM * kDxBN / VE; e += kThreads) {
      const int r = e / (kDxBN / VE), c = (e % (kDxBN / VE)) * VE;
      const long m = m0 + r;
      if (m < M && n0 + c < F)
        *reinterpret_cast<uint4*>(dx + m * F + n0 + c) =
            *reinterpret_cast<const uint4*>(os + r * kOLd + c);
    }
    __syncthreads();  // the next tile's loads refill the ring
  }
  if (fold) {
    for (int f = threadIdx.x; f < F; f += kThreads) {
      float a = 0.0f, b = 0.0f;
      for (int i = 0; i < 4; ++i) {
        a += sds[i * Fp + f];
        b += sdc[i * Fp + f];
      }
      part[(long)blockIdx.x * 2 * F + f] = a;
      part[(long)blockIdx.x * 2 * F + F + f] = b;
    }
  }
}

// One K-slice of dW_cf = u^T [g, g1, h2]: block (f tile fm, G-column tile nn,
// slice s) writes part[s][fm*64 .. +64][nn*64 .. +64]; the blocks with fm = 0
// whose columns hold g also write part_db[s][o] = sum of g[:, o] over the
// slice.  Warp (wf, wn) = (warp / 2, warp % 2) owns f rows 32 wf .. +32 and
// G columns 32 wn .. +32 of the tile.
template <typename T>
__global__ void __launch_bounds__(kDwThreads)
bwd_dw_kernel(Cot<T> cot, const T* __restrict__ x, const T* __restrict__ fold_s,
              const T* __restrict__ fold_c, float* __restrict__ part,
              float* __restrict__ part_db, int M, int F, int Fout, int Fo_pad, int Fp, int Gw,
              int S, int slice_rows) {
  constexpr int NS = kStages, VE = vec_elems<T>(), VPR = 64 / VE;
  __shared__ __align__(128) T us[NS][kBK * kTLd];  // u rows of the k-tile, f tile
  __shared__ __align__(128) T gs[NS][kBK * kTLd];  // G rows of the k-tile, column tile
  const int ng = Gw / 64;
  const int s = blockIdx.x % S, nn = (blockIdx.x / S) % ng, fm = blockIdx.x / (S * ng);
  const int f0 = fm * 64, n0 = nn * 64;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, cq = lane & 3, wf = warp >> 1, wn = warp & 1;
  const bool fold = fold_s != nullptr;
  const int r_begin = s * slice_rows, r_end = min(M, r_begin + slice_rows);
  const int KT = r_end > r_begin ? (r_end - r_begin + kBK - 1) / kBK : 0;
  const bool do_db = fm == 0 && n0 < Fo_pad && threadIdx.x < 64;
  float dbs = 0.0f;
  // the VE u columns this thread stages in every k-tile, and their fold
  const int fc0 = (threadIdx.x % VPR) * VE;
  float sf[VE], cf[VE];
#pragma unroll
  for (int i = 0; i < VE; ++i) {
    const bool ok = fold && f0 + fc0 + i < F;
    sf[i] = ok ? to_f(fold_s[f0 + fc0 + i]) : 0.0f;
    cf[i] = ok ? to_f(fold_c[f0 + fc0 + i]) : 0.0f;
  }

  auto load = [&](int buf, int kt) {
    const int mb = r_begin + kt * kBK;
    for (int e = threadIdx.x; e < kBK * VPR; e += kDwThreads) {
      const int r = e / VPR, c = (e % VPR) * VE;
      const long m = mb + r;
      const bool ok = m < r_end && f0 + c < F;
      cp_async16(&us[buf][r * kTLd + c], ok ? x + m * F + f0 + c : x, ok);
      const int j = n0 + c, b = j / Fo_pad, o = j % Fo_pad;
      const bool okg = m < r_end && b < 3;
      cp_async16(&gs[buf][r * kTLd + c], okg ? operand(cot, b) + m * Fo_pad + o : x, okg);
    }
  };
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.0f;
#pragma unroll
  for (int st = 0; st < NS - 1; ++st) {
    if (st < KT) load(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    const int buf = kt % NS;
    cp_async_wait<NS - 2>();
    if (fold && f0 + fc0 < F) {  // u = relu(x*s + c) on the vectors this thread copied
      const int mb = r_begin + kt * kBK;
      for (int e = threadIdx.x; e < kBK * VPR; e += kDwThreads) {
        const int r = e / VPR;
        if (mb + r >= r_end) continue;
        uint4* u = reinterpret_cast<uint4*>(&us[buf][r * kTLd + fc0]);
        uint4 v = *u;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(h[i]);
          h[i] = __floats2bfloat162_rn(
              fmaxf(__fadd_rn(__fmul_rn(f.x, sf[2 * i]), cf[2 * i]), 0.0f),
              fmaxf(__fadd_rn(__fmul_rn(f.y, sf[2 * i + 1]), cf[2 * i + 1]), 0.0f));
        }
        *u = v;
      }
    }
    __syncthreads();
    if (kt + NS - 1 < KT) load((kt + NS - 1) % NS, kt + NS - 1);
    cp_async_commit();
    if (do_db)
      for (int r = 0; r < kBK; ++r) dbs += to_f(gs[buf][r * kTLd + threadIdx.x]);
#pragma unroll
    for (int k16 = 0; k16 < kBK; k16 += 16) {
      unsigned af[2][4];  // A = u^T: ldmatrix.trans of u's (m, f) rows
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4_trans(af[mi], &us[buf][(k16 + lane % 8 + 8 * (lane / 16)) * kTLd +
                                           wf * 32 + mi * 16 + 8 * ((lane / 8) % 2)]);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        unsigned bq[4];
        ldmatrix_x4_trans(bq, &gs[buf][(k16 + lane % 16) * kTLd + wn * 32 + p * 16 +
                                       (lane / 16) * 8]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma16816(acc[mi][2 * p], af[mi], bq[0], bq[1]);
          mma16816(acc[mi][2 * p + 1], af[mi], bq[2], bq[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  float* out = part + (long)s * Fp * Gw;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = f0 + wf * 32 + mi * 16 + gq + 8 * h;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        *reinterpret_cast<float2*>(out + (long)f * Gw + n0 + wn * 32 + ni * 8 + 2 * cq) =
            make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
    }
  if (do_db && n0 + (int)threadIdx.x < Fout) part_db[(long)s * Fout + n0 + threadIdx.x] = dbs;
}

// The float32 dx: dx = [g, g1, h2] @ W^T in 128 x DN tiles, warp-specialized
// on wgmma (gemm_f32.cuh): a producer warpgroup copies G's and W's 32-deep
// k-tiles raw into the ring (W read as (3F, Fo_pad) basis-major: each
// block's rows f hold that block's k contiguously) and splits them into the
// planes; two consumer warpgroups multiply, then apply the fold's mask and
// scale and keep the ds / dc partials as in bf16 (8 row groups: warp w owns
// rows 16 w .. +16), storing dx straight from registers.
template <int DN>
__global__ void __launch_bounds__(kThreads + kDxProducer, 1)
bwd_dx_f32_kernel(Cot<float> cot, const float* __restrict__ W, const float* __restrict__ x,
                  const float* __restrict__ fold_s, const float* __restrict__ fold_c,
                  float* __restrict__ dx, float* __restrict__ part, int M, int F, int Fo_pad,
                  int Fp) {
  constexpr int S = dx_f32_stages(DN), NT = kThreads + kDxProducer;
  extern __shared__ __align__(128) unsigned char smem[];
  const F32Smem sm(smem, kDxBM, DN);
  float* sds = reinterpret_cast<float*>(smem + gemm_f32_smem(kDxBM, DN, S));  // (8, Fp)
  float* sdc = sds + kWarps * Fp;                                               // (8, Fp)
  const bool fold = fold_s != nullptr;
  for (int e = threadIdx.x; e < 2 * kWarps * Fp; e += NT) sds[e] = 0.0f;
  __syncthreads();

  const int K = 3 * Fo_pad, KT = (K + kBK - 1) / kBK;
  const int nn = Fp / DN, items = (M + kDxBM - 1) / kDxBM * nn;
  const int tiles = (int)blockIdx.x < items ? (items - 1 - blockIdx.x) / gridDim.x + 1 : 0;

  if (threadIdx.x >= kThreads) {  // the producer warpgroups
    regs_producer();
    const int t = threadIdx.x - kThreads;
    auto load = [&](int st, int q) {
      const int w = blockIdx.x + (q / KT) * gridDim.x, kt = q % KT;
      const int m0 = (w / nn) * kDxBM, n0 = (w % nn) * DN;
      float* ra = sm.raw_a(st);
      float* rb = sm.raw_b(st);
      for (int e = t; e < kDxBM * kBK / 4; e += kDxProducer) {
        const int r = e >> 3, kk = kt * kBK + (e & 7) * 4, b = kk / Fo_pad, o = kk % Fo_pad;
        const long m = m0 + r;
        const bool ok = m < M && b < 3;
        cp_async16(ra + e * 4, ok ? operand(cot, b) + m * Fo_pad + o : W, ok);
      }
      for (int e = t; e < DN * kBK / 4; e += kDxProducer) {
        const int n = e >> 3, kk = kt * kBK + (e & 7) * 4, b = kk / Fo_pad, o = kk % Fo_pad;
        const bool ok = n0 + n < F && b < 3;
        cp_async16(rb + e * 4, ok ? W + ((long)b * F + n0 + n) * Fo_pad + o : W, ok);
      }
    };
    f32_produce<S, kDxProducer>(tiles * KT, NT, load, [&](int st, int, int b) {
      split_rows<kDxBM, kDxProducer>(sm.raw_a(st), sm.a_big(b), sm.a_small(b));
      split_rows<DN, kDxProducer>(sm.raw_b(st), sm.b_big(b), sm.b_small(b));
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
    const int m0 = (w / nn) * kDxBM, n0 = (w % nn) * DN;
    float acc[1][DN / 8][4];
#pragma unroll
    for (int ni = 0; ni < DN / 8; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[0][ni][j] = 0.0f;
    for (int kt = 0; kt < KT; ++kt) f32_consume<DN>(acc, sm, q++, a_row0, NT);

    if (fold) {
      // the mask and scale in registers, every load before a store; the
      // column sums over the warp's 16 rows (lanes of equal lane % 4), then
      // into the (row group, column) slot this lane alone owns
#pragma unroll
      for (int ni = 0; ni < DN / 8; ++ni) {
        const int f = n0 + ni * 8 + 2 * cq;
        float ps[2] = {0.0f, 0.0f}, pc[2] = {0.0f, 0.0f};
        if (f < F) {
          const float2 sv = load2(fold_s + f), cv = load2(fold_c + f);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const long m = m0 + warp * 16 + gq + 8 * h;
            if (m >= M) continue;
            const float2 xv = __ldg(reinterpret_cast<const float2*>(x + m * F + f));
            float d0 = acc[0][ni][2 * h], d1 = acc[0][ni][2 * h + 1];
            d0 = __fadd_rn(__fmul_rn(xv.x, sv.x), cv.x) > 0.0f ? d0 : 0.0f;
            d1 = __fadd_rn(__fmul_rn(xv.y, sv.y), cv.y) > 0.0f ? d1 : 0.0f;
            ps[0] += d0 * xv.x;
            ps[1] += d1 * xv.y;
            pc[0] += d0;
            pc[1] += d1;
            acc[0][ni][2 * h] = d0 * sv.x;
            acc[0][ni][2 * h + 1] = d1 * sv.y;
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int off = 4; off < 32; off *= 2) {
            ps[j] += __shfl_xor_sync(0xffffffffu, ps[j], off);
            pc[j] += __shfl_xor_sync(0xffffffffu, pc[j], off);
          }
        if (gq == 0 && f < F)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            sds[warp * Fp + f + j] += ps[j];
            sdc[warp * Fp + f + j] += pc[j];
          }
      }
    }
#pragma unroll
    for (int ni = 0; ni < DN / 8; ++ni) {
      const int f = n0 + ni * 8 + 2 * cq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long m = m0 + warp * 16 + gq + 8 * h;
        if (m < M && f < F)
          *reinterpret_cast<float2*>(dx + m * F + f) =
              make_float2(acc[0][ni][2 * h], acc[0][ni][2 * h + 1]);
      }
    }
  }
  if (fold) {
    bar_sync(kBarConsumer, kThreads);
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

// The float32 dW: one K-slice of dW_cf = u^T [g, g1, h2] as bwd_dw_kernel's,
// warp-specialized on wgmma (gemm_f32.cuh): a producer warpgroup copies the
// u (x) and G k-tiles (M-major) raw into the ring, sums db from G's raw rows
// in order, and splits both into K-major planes, applying the fold to u
// (thread t always splits u column f0 + t % 64, so its s and c stay in
// registers); one consumer warpgroup multiplies, warp w owning f rows
// 16 w .. +16 and all 64 G columns of the tile.
__global__ void __launch_bounds__(kDwThreads + kDwProducer, 1)
bwd_dw_f32_kernel(Cot<float> cot, const float* __restrict__ x, const float* __restrict__ fold_s,
                  const float* __restrict__ fold_c, float* __restrict__ part,
                  float* __restrict__ part_db, int M, int F, int Fout, int Fo_pad, int Fp,
                  int Gw, int S, int slice_rows) {
  constexpr int NS = kDwF32Stages, NT = kDwThreads + kDwProducer;
  extern __shared__ __align__(128) unsigned char smem[];
  const F32Smem sm(smem, 64, 64);
  const int ng = Gw / 64;
  const int s = blockIdx.x % S, nn = (blockIdx.x / S) % ng, fm = blockIdx.x / (S * ng);
  const int f0 = fm * 64, n0 = nn * 64;
  const int r_begin = s * slice_rows, r_end = min(M, r_begin + slice_rows);
  const int KT = r_end > r_begin ? (r_end - r_begin + kBK - 1) / kBK : 0;

  if (threadIdx.x >= kDwThreads) {  // the producer warpgroups
    const int t = threadIdx.x - kDwThreads;
    const bool do_db = fm == 0 && n0 < Fo_pad && t < 64;
    float dbs = 0.0f;
    const int fu = f0 + t % 64;  // the u column this thread splits
    const bool folds = fold_s != nullptr && fu < F;
    const float sf = folds ? fold_s[fu] : 0.0f, cf = folds ? fold_c[fu] : 0.0f;
    auto load = [&](int st, int kt) {
      float* ru = sm.raw_a(st);
      float* rg = sm.raw_b(st);
      const int mb = r_begin + kt * kBK;
      for (int e = t; e < kBK * 16; e += kDwProducer) {
        const int r = e / 16, c = (e % 16) * 4;
        const long m = mb + r;
        const bool ok = m < r_end && f0 + c < F;
        cp_async16(ru + r * 64 + c, ok ? x + m * F + f0 + c : x, ok);
        const int j = n0 + c, b = j / Fo_pad, o = j % Fo_pad;
        const bool okg = m < r_end && b < 3;
        cp_async16(rg + r * 64 + c, okg ? operand(cot, b) + m * Fo_pad + o : x, okg);
      }
    };
    f32_produce<NS, kDwProducer>(KT, NT, load, [&](int st, int kt, int b) {
      const int mb = r_begin + kt * kBK;
      const float* rg = sm.raw_b(st);
      if (do_db)  // db: g's columns summed over the k-tile's rows, in order
        for (int r = 0; r < kBK; ++r) dbs += rg[r * 64 + t];
      split_cols<64, kDwProducer>(sm.raw_a(st), sm.a_big(b), sm.a_small(b),
                                 [&](float4& v, int, int c) {
                                   if (!folds) return;  // u = x (or zero columns)
                                   float* h = reinterpret_cast<float*>(&v);
#pragma unroll
                                   for (int i = 0; i < 4; ++i)
                                     if (mb + 4 * c + i < r_end)
                                       h[i] = fmaxf(__fadd_rn(__fmul_rn(h[i], sf), cf), 0.0f);
                                 });
      split_cols<64, kDwProducer>(rg, sm.b_big(b), sm.b_small(b), [](float4&, int, int) {});
    });
    if (do_db && n0 + t < Fout) part_db[(long)s * Fout + n0 + t] = dbs;
    return;
  }

  // the consumer warpgroup
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, cq = lane & 3;
  float acc[1][8][4];
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[0][ni][j] = 0.0f;
  for (int kt = 0; kt < KT; ++kt) f32_consume<64>(acc, sm, kt, 0, NT);
  float* out = part + (long)s * Fp * Gw;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = f0 + warp * 16 + gq + 8 * h;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
      *reinterpret_cast<float2*>(out + (long)f * Gw + n0 + ni * 8 + 2 * cq) =
          make_float2(acc[0][ni][2 * h], acc[0][ni][2 * h + 1]);
  }
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

template <typename T>
cudaError_t fused_bwd(const void* band, const void* g, const void* x, const void* Wt,
                      const void* fold_s, const void* fold_c, void* g1, void* h2, void* dx,
                      void* dW, void* db, void* dsdc, void* part_db, void* part_dx,
                      void* part_dw, int V, int nt, int k, int B, int F, int Fout, int Fo_pad,
                      int Gw, int Fp, int hop_cc, int hop_grid, int hop_per_block, int grid_dx,
                      int S, int slice_rows, int stages, cudaStream_t st) {
  const int M = V * B;
  const T* gb = static_cast<const T*>(g);
  T* g1b = static_cast<T*>(g1);
  T* h2b = static_cast<T*>(h2);
  const T* bb = static_cast<const T*>(band);
  const int C = B * Fo_pad;
  cudaError_t err = cudaSuccess;
  if (stages & 1) {
    err = launch_band_hop(HopArgsT<T>{bb, gb, nullptr, g1b, 1.0f, 0.0f, V, nt, k, C}, hop_cc,
                          hop_grid, hop_per_block, st);
    if (err != cudaSuccess) return err;
    err = launch_band_hop(HopArgsT<T>{bb, g1b, gb, h2b, 2.0f, -1.0f, V, nt, k, C}, hop_cc,
                          hop_grid, hop_per_block, st);
    if (err != cudaSuccess) return err;
  }

  const Cot<T> cot{{gb, g1b, h2b}};
  const auto* fs = static_cast<const T*>(fold_s);
  const auto* fc = static_cast<const T*>(fold_c);
  const auto* xb = static_cast<const T*>(x);
  if (stages & 2) {
    const size_t smem_dx = dx_smem<T>(Fp);
    if (smem_dx > (size_t)kMaxSmem) return cudaErrorInvalidValue;
    if constexpr (sizeof(T) == 4) {
      auto kernel = dx_f32_bn(Fp) == 128 ? bwd_dx_f32_kernel<128> : bwd_dx_f32_kernel<64>;
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem_dx);
      if (err != cudaSuccess) return err;
      kernel<<<grid_dx, kThreads + kDxProducer, smem_dx, st>>>(
          cot, static_cast<const float*>(Wt), xb, fs, fc, static_cast<float*>(dx),
          static_cast<float*>(part_dx), M, F, Fo_pad, Fp);
    } else {
      err = cudaFuncSetAttribute(bwd_dx_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem_dx);
      if (err != cudaSuccess) return err;
      bwd_dx_kernel<T><<<grid_dx, kThreads, smem_dx, st>>>(
          cot, static_cast<const T*>(Wt), xb, fs, fc, static_cast<T*>(dx),
          static_cast<float*>(part_dx), M, F, Fo_pad, Gw, Fp);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (!(stages & 4)) return cudaSuccess;

  float* pw = static_cast<float*>(part_dw);
  float* pdb = static_cast<float*>(part_db);
  const int dw_grid = (Fp / 64) * (Gw / 64) * S;
  if constexpr (sizeof(T) == 4) {
    const size_t smem_dw = dw_smem<float>();
    err = cudaFuncSetAttribute(bwd_dw_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_dw);
    if (err != cudaSuccess) return err;
    bwd_dw_f32_kernel<<<dw_grid, kDwThreads + kDwProducer, smem_dw, st>>>(
        cot, xb, fs, fc, pw, pdb, M, F, Fout, Fo_pad, Fp, Gw, S, slice_rows);
  } else {
    bwd_dw_kernel<T><<<dw_grid, kDwThreads, 0, st>>>(cot, xb, fs, fc, pw, pdb, M, F, Fout,
                                                     Fo_pad, Fp, Gw, S, slice_rows);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int n = 3 * F * Fout;
  dw_reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(pw, S, F, Fp, Gw, Fout, Fo_pad,
                                                   static_cast<float*>(dW));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = launch_reduce(pdb, S, Fout, static_cast<float*>(db), st)) != cudaSuccess)
    return err;
  if (fold_s)
    return launch_reduce(static_cast<const float*>(part_dx), grid_dx, 2 * F,
                         static_cast<float*>(dsdc), st);
  return cudaSuccess;
}

}  // namespace

// Pointers: band, g (V, B, Fo_pad), x, Wt (bf16: Wt (Gw, Fp); float32: W
// itself, (3F, Fo_pad)), fold_s, fold_c (null without the fold) in; g1, h2
// (V, B, Fo_pad) scratch; dx (V, B, F) out, all bf16 or all float32 (f32);
// dW (3F, Fout), db (Fout,) and dsdc (2, F) [ds; dc] float32 out; part_db
// (S, Fout), part_dx (grid_dx, 2F) and part_dw (S, Fp, Gw) float32 scratch.
// The launch plan (ops/fused_cheby_train.py bwd_plan): the hop engine's
// chunk, grid and items per block; grid_dx; S row slices of slice_rows rows
// (a multiple of 32) for dW.  stages: which launches run, 1 the two hops, 2
// dx (and the ds/dc partials), 4 dW, db and every reduction; 7 is the whole
// backward (the parts alone only time the split).  Returns a cudaError_t.
extern "C" int p2m_fused_cheby_bwd(const void* band, const void* g, const void* x,
                                   const void* Wt, const void* fold_s, const void* fold_c,
                                   void* g1, void* h2, void* dx, void* dW, void* db,
                                   void* dsdc, void* part_db, void* part_dx, void* part_dw,
                                   int V, int nt, int k, int B, int F, int Fout, int Fo_pad,
                                   int Gw, int Fp, int hop_cc, int hop_grid,
                                   int hop_per_block, int grid_dx, int S, int slice_rows,
                                   int stages, int f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = V * B;
  if (Fo_pad % 16 || Fout > Fo_pad || F % 16 || Gw % 64 || Gw < 3 * Fo_pad || Fp % 64 ||
      Fp < F || slice_rows % kBK || (long)S * slice_rows < M || grid_dx <= 0)
    return cudaErrorInvalidValue;
  auto run = [&](auto zero) {
    return fused_bwd<decltype(zero)>(band, g, x, Wt, fold_s, fold_c, g1, h2, dx, dW, db, dsdc,
                                     part_db, part_dx, part_dw, V, nt, k, B, F, Fout, Fo_pad,
                                     Gw, Fp, hop_cc, hop_grid, hop_per_block, grid_dx, S,
                                     slice_rows, stages, st);
  };
  return f32 ? run(0.0f) : run(bf16{});
}

extern "C" const char* p2m_fused_cheby_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
