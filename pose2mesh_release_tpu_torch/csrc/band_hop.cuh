// The banded hop engine: y[:, cols] = bf16(act(alpha * (L x)[:, cols] + beta * add[:, cols]))
// for the block-banded Laplacian L, float32 accumulation, one rounding.
//
// Used by K4 (csrc/banded_hop.cu: alpha = 1, beta = 0), by the fused training
// backward K2 (csrc/fused_cheby_bwd.cu: g1 = L g, then h2 = 2 L g1 - g with
// alpha = 2, beta = -1, add = g), by the training conv K1 and the group deploy
// conv (z1 = L u, z2 = 2 L z1 - u), by the commuted deploy conv (a float32
// add operand and the ReLU) and by the window conv (L read in its window
// form), in place of the TPU kernels' hop bodies
// (pose2mesh_release_tpu/ops/pallas_cheby.py `_hop_kernel_factory`, and the
// hops of `_bwd_kernel_factory`, `_commuted_kernel_factory`, ...).
//
// Layouts of L (the template parameter WIN), both read through two strides,
// ld between the operator's rows and dstride between the 2k+1 blocks of one
// row, and a source row v0(t), the x row of a row tile's first band column:
//   block band  band (2k+1, nt, T, T): ld = T, dstride = nt*T*T,
//               v0(t) = (t - k) T; out-of-range neighbour blocks are skipped;
//   window form win (nt*T, (2k+1)*T) with offsets woff (nt,) int32 (ops/
//               window_cheby.py window_cat): ld = (2k+1) T, dstride = T,
//               v0(t) = woff[t]; every window is in range (the edge tiles'
//               entries are shifted), so no block is skipped.
// Warp w of row tile t reads its 16 band rows at band + (t T + 16 w) ld, and
// sub-tile j = 8 d + cg (16 x 16) at + d dstride + 16 cg; it multiplies x rows
// v0(t) + 16 j .. + 16.  ops/hop.py hop_layout mirrors this addressing.
// x, add, y (V, C) bf16 row-major, C a multiple of 16, V <= nt*T.  Rows >= V
// read as zero and are never written.  The add operand is bf16 or, with the
// template parameter F32ADD, float32 (read as float2; 8-byte aligned), then
// the ReLU where `relu` is set.
//
// Design (Hopper; mma.sync m16n8k16 bf16 on tensor cores, cp.async staging):
//   * Work items are (row tile t, CC-column chunk), t-major.  A persistent
//     grid (about two blocks per SM) gives each block a contiguous run of
//     items, so a block walks many column chunks of one row tile.
//   * Band resident: when a block enters a row tile, each warp reads its 16
//     band rows once, marks every 16 x 16 sub-tile that is all zero (warp
//     ballot over the bytes it reads; 63-67% of them on the SMPL levels) and
//     keeps the A fragments of its first kHopCap nonzero sub-tiles in
//     registers for all the chunks it walks.  Nonzero sub-tiles beyond that
//     (dense test bands) take their fragments from L2 per chunk.
//   * Only the 16-row groups of x that some warp's nonzero sub-tiles touch are
//     staged: 16-byte cp.async into a two-stage ring, chunk j+1 loading while
//     chunk j multiplies; rows >= V are zero-filled by the copy.
//   * B fragments come from shared memory through ldmatrix.trans; the sum of
//     the nonzero sub-tiles stays in registers; the epilogue writes packed
//     bf16 pairs (4 bytes per lane, neighbouring lanes on neighbouring
//     addresses) with no float32 staging.
// Bound on the H100: at the band's nonzeros the hop does ~1 operation per
// byte, so device memory bounds it (x read once, y written once).
#pragma once

#include <cstdint>

#include "common.cuh"

namespace p2m {

// nonzero 16 x 16 band sub-tiles whose A fragments a warp keeps in registers
constexpr int kHopCap = 12;
// the engine's pipeline depth (x chunks in flight)
constexpr int kHopStages = 2;
// blocks the engine keeps on an SM (registers: 65536 / (256 x this))
constexpr int kHopBlocksPerSm = 2;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// d += a (16 x 16, row-major fragment) @ b (16 x 8, column-major fragment)
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// 16-byte asynchronous copy to shared memory; with valid false the 16 bytes
// are zero-filled and src is not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The A fragment of m16n8k16 from a 16 x 16 row-major tile (leading dimension
// ld) in device memory: rows lane/4 and lane/4 + 8, column pairs 2*(lane%4)
// and 2*(lane%4) + 8.
__device__ __forceinline__ void load_a_global(unsigned (&a)[4], const bf16* tile, int ld) {
  const int lane = threadIdx.x % 32, g = lane >> 2, c = 2 * (lane & 3);
  a[0] = *reinterpret_cast<const unsigned*>(tile + g * ld + c);
  a[1] = *reinterpret_cast<const unsigned*>(tile + (g + 8) * ld + c);
  a[2] = *reinterpret_cast<const unsigned*>(tile + g * ld + c + 8);
  a[3] = *reinterpret_cast<const unsigned*>(tile + (g + 8) * ld + c + 8);
}

// acc[q] += a @ rows[:, 8q .. 8q+8) for q < NQ, rows 16 x (8 NQ) bf16 in
// shared memory, row-major with leading dimension ld.
template <int NQ>
__device__ __forceinline__ void mma_rows(float (&acc)[NQ][4], const unsigned (&a)[4],
                                         const bf16* rows, int ld) {
  const int lane = threadIdx.x % 32;
  const bf16* p = rows + (lane % 16) * ld + (lane / 16) * 8;
#pragma unroll
  for (int q = 0; q < NQ; q += 2) {
    unsigned b[4];
    ldmatrix_x4_trans(b, p + q * 8);
    mma16816(acc[q], a, b[0], b[1]);
    mma16816(acc[q + 1], a, b[2], b[3]);
  }
}

struct HopArgs {
  const bf16* band;  // the block band, or the window form (WIN)
  const bf16* x;
  const bf16* add;  // bf16 add operand; null: beta is not used (without F32ADD)
  bf16* y;
  float alpha, beta;
  int V, nt, k, C;
  const float* addf = nullptr;  // F32ADD: the float32 add operand (V, C)
  const int* woff = nullptr;    // WIN: the window offsets (nt,)
  int relu = 0;                 // F32ADD: ReLU after the add
};

// Shared memory of the engine's x ring for CC-column chunks (must match
// ops/hop.py hop_plan).
__host__ __device__ constexpr size_t band_hop_smem(int CC, int k) {
  return (size_t)kHopStages * (2 * k + 1) * kT * (CC + 8) * sizeof(bf16);
}

template <int CC, bool WIN, bool F32ADD>
__global__ void __launch_bounds__(kThreads, kHopBlocksPerSm)
band_hop_kernel(HopArgs a, int per_block) {
  constexpr int LD = CC + 8;  // staged row stride: 16 bytes of pad against bank conflicts
  constexpr int NQ = CC / 8;  // n8 tiles of a chunk
  constexpr int VPR = CC / 8; // 16-byte vectors of a staged row
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ unsigned long long wmask[kWarps];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  const int nbd = 2 * a.k + 1, ngrp = nbd * 8;  // 16-row source groups of a row tile
  const int stage_elems = ngrp * 16 * LD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, cq = lane & 3;
  // the operator's strides: ld between its rows, and block d of a row at
  // d * dstride (recomputed where it is used: held in registers it spills)
  const int ld = WIN ? nbd * kT : kT;
  const long tile = (long)kT * kT;
  auto block = [&](int d) -> long { return WIN ? (long)d * kT : (long)d * a.nt * tile; };
  const int nch = a.C / CC, items = a.nt * nch;
  int it = blockIdx.x * per_block;
  const int it_end = min(items, it + per_block);

  while (it < it_end) {
    const int t = it / nch;
    const int n = min(it_end, (t + 1) * nch) - it;  // chunks of tile t in this run
    // 1. this warp's nonzero sub-tiles of band rows t*T + 16*warp .. +16
    const bf16* brow = a.band + (long)t * kT * ld + warp * 16 * ld;
    unsigned long long mine = 0;
    for (int d = 0; d < nbd; ++d) {
      if (!WIN && (t + d - a.k < 0 || t + d - a.k >= a.nt)) continue;
      const bf16* bb = brow + block(d) + (lane / 2) * ld + (lane % 2) * 8;
      uint4 v[8];
#pragma unroll
      for (int cg = 0; cg < 8; ++cg) v[cg] = *reinterpret_cast<const uint4*>(bb + cg * 16);
#pragma unroll
      for (int cg = 0; cg < 8; ++cg)
        if (__ballot_sync(0xffffffffu, (v[cg].x | v[cg].y | v[cg].z | v[cg].w) != 0u))
          mine |= 1ull << (d * 8 + cg);
    }
    unsigned af[kHopCap][4];
    {
      unsigned long long rem = mine;
#pragma unroll
      for (int s = 0; s < kHopCap; ++s) {
        if (rem) {
          const int j = __ffsll((long long)rem) - 1;
          rem &= rem - 1;
          load_a_global(af[s], brow + block(j / 8) + (j % 8) * 16, ld);
        }
      }
    }
    if (lane == 0) wmask[warp] = mine;
    __syncthreads();
    unsigned long long need = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) need |= wmask[w];

    // 2. stage the needed x rows of a chunk: source rows v0(t) + r
    auto stage = [&](int buf, int c0) {
      bf16* dst = xs + buf * stage_elems;
      const long v0 = WIN ? (long)a.woff[t] : (long)(t - a.k) * kT;
      for (int e = threadIdx.x; e < ngrp * 16 * VPR; e += kThreads) {
        const int r = e / VPR, col = (e % VPR) * 8;
        if (!((need >> (r / 16)) & 1ull)) continue;
        const long v = v0 + r;
        const bool ok = v >= 0 && v < a.V;
        cp_async16(dst + r * LD + col, ok ? a.x + v * a.C + c0 + col : a.x, ok);
      }
    };
    stage(0, (it % nch) * CC);
    cp_async_commit();
    for (int i = 0; i < n; ++i) {
      if (i + 1 < n) stage((i + 1) % kHopStages, ((it + i + 1) % nch) * CC);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const bf16* xb = xs + (i % kHopStages) * stage_elems;
      float acc[NQ][4];
#pragma unroll
      for (int q = 0; q < NQ; ++q) acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.0f;
      unsigned long long rem = mine;
#pragma unroll
      for (int s = 0; s < kHopCap; ++s) {
        if (!rem) break;
        const int j = __ffsll((long long)rem) - 1;
        rem &= rem - 1;
        mma_rows<NQ>(acc, af[s], xb + j * 16 * LD, LD);
      }
      while (rem) {  // beyond the register slots: fragments from L2
        const int j = __ffsll((long long)rem) - 1;
        rem &= rem - 1;
        unsigned fa[4];
        load_a_global(fa, brow + block(j / 8) + (j % 8) * 16, ld);
        mma_rows<NQ>(acc, fa, xb + j * 16 * LD, LD);
      }
      // 3. epilogue: y = act(alpha * acc + beta * add), packed bf16 pairs
      const int c0 = ((it + i) % nch) * CC + 2 * cq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long v = (long)t * kT + warp * 16 + gq + 8 * h;
        if (v >= a.V) continue;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const long off = v * a.C + c0 + q * 8;
          float y0 = __fmul_rn(a.alpha, acc[q][2 * h]);
          float y1 = __fmul_rn(a.alpha, acc[q][2 * h + 1]);
          if constexpr (F32ADD) {
            const float2 ad = *reinterpret_cast<const float2*>(a.addf + off);
            y0 = __fadd_rn(y0, __fmul_rn(a.beta, ad.x));
            y1 = __fadd_rn(y1, __fmul_rn(a.beta, ad.y));
            if (a.relu) {
              y0 = fmaxf(y0, 0.0f);
              y1 = fmaxf(y1, 0.0f);
            }
          } else if (a.add) {
            const float2 ad =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.add + off));
            y0 = __fadd_rn(y0, __fmul_rn(a.beta, ad.x));
            y1 = __fadd_rn(y1, __fmul_rn(a.beta, ad.y));
          }
          *reinterpret_cast<__nv_bfloat162*>(a.y + off) = __floats2bfloat162_rn(y0, y1);
        }
      }
      __syncthreads();  // the buffer is restaged two chunks on
    }
    it += n;
  }
}

template <int CC, bool WIN, bool F32ADD>
inline cudaError_t launch_band_hop_cc(const HopArgs& a, int grid, int per_block, size_t smem,
                                      cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(band_hop_kernel<CC, WIN, F32ADD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  band_hop_kernel<CC, WIN, F32ADD><<<grid, kThreads, smem, stream>>>(a, per_block);
  return cudaGetLastError();
}

// One engine launch over the plan's grid (ops/hop.py hop_plan): cc columns
// per chunk (16, 32 or 64, dividing C), grid blocks of per_block items each.
// WIN: L in its window form (a.woff set, nt >= 2k+1); F32ADD: the float32
// add operand a.addf (and a.relu).
template <bool WIN = false, bool F32ADD = false>
inline cudaError_t launch_band_hop(const HopArgs& a, int cc, int grid, int per_block,
                                   cudaStream_t stream) {
  const long items = (long)a.nt * (a.C / (cc > 0 ? cc : 1));
  if (cc <= 0 || a.C % cc || a.k < 1 || a.k > 2 || grid <= 0 || per_block <= 0 ||
      (long)grid * per_block < items || a.V > a.nt * kT || WIN != (a.woff != nullptr) ||
      (WIN && a.nt < 2 * a.k + 1) || F32ADD != (a.addf != nullptr) || (F32ADD && a.add))
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.y) |
       reinterpret_cast<uintptr_t>(a.add)) % 16 ||
      reinterpret_cast<uintptr_t>(a.addf) % 8)
    return cudaErrorMisalignedAddress;
  const size_t smem = band_hop_smem(cc, a.k);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  switch (cc) {
    case 16: return launch_band_hop_cc<16, WIN, F32ADD>(a, grid, per_block, smem, stream);
    case 32: return launch_band_hop_cc<32, WIN, F32ADD>(a, grid, per_block, smem, stream);
    case 64: return launch_band_hop_cc<64, WIN, F32ADD>(a, grid, per_block, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace p2m
