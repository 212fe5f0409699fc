// The banded hop engine: y[:, cols] = T(act(alpha * (L x)[:, cols] + beta * add[:, cols])
// (+ post[:, cols])) for the banded Laplacian L, float32 accumulation, one rounding
// (the bf16 operand type T; float32 operands go to the float32 engine,
// band_hop_f32.cuh, through the same launch_band_hop).
//
// Used by K4 (csrc/banded_hop.cu: alpha = 1, beta = 0), by the fused training
// backward K2 (csrc/fused_cheby_bwd.cu: g1 = L g, then h2 = 2 L g1 - g with
// alpha = 2, beta = -1, add = g), by the training conv K1 and the group deploy
// conv (z1 = L u, z2 = 2 L z1 - u), by the commuted deploy conv (a float32
// add operand and the ReLU) and by the strip and window convs (L read in its
// strip form; in commuted order also the ReLU and the skip after it), in
// place of the TPU kernels' hop bodies (pose2mesh_release_tpu/ops/
// pallas_cheby.py `_hop_kernel_factory`, the hops of `_bwd_kernel_factory`,
// `_commuted_kernel_factory`, ..., ops/pallas_strip.py `hop`).
//
// Layouts of L (the template parameter STRIP), both read as 16 x 16 sub-tiles
// of a warp's 16 operator rows, against 16-row groups of x:
//   block band  band (2k+1, nt, T, T): ld = T between the operator's rows,
//               block d of a row at d nt T^2; sub-tile j = 8 d + cg of warp w
//               in row tile t at band + (t T + 16 w) ld + d nt T^2 + 16 cg,
//               against x rows (t - k) T + 16 j; out-of-range neighbour
//               blocks are skipped.  Every warp of a tile stages the same
//               (2k+1) T rows.
//   strip form  strip (nt*T, Wd) row-major, Wd a multiple of 16, with
//               offsets off (nt*T / h,) int32 for strip tiles of h rows (a
//               multiple of 16 dividing nt*T): row r holds
//               L[r, off[r / h] .. + Wd).  Warp w of row tile t reads its
//               nsub = Wd / 16 sub-tiles at strip + (t T + 16 w) Wd + 16 j
//               against x rows v0(t, w) + 16 j, v0(t, w) = off[(t T + 16 w) / h]
//               (its 16 rows lie in one strip tile), from the table
//               wrow (nt, 8) int32 of v0 (ops/strip_cheby.py gathers it once
//               per offsets tensor: no division in the kernel).  The offsets
//               are non-decreasing and differ by multiples of 16 within a row
//               tile (graphs/artifact.py strip_offset), so the block stages
//               the union of its warps' source groups from vmin(t) = v0(t, 0),
//               `span` groups at most (ops/hop.py hop_layout; at most 64, the
//               bits of the staged-group mask), and warp w reads staged group
//               (v0(t, w) - vmin(t)) / 16 + j.  The window form of the
//               window conv (ops/window_cheby.py window_cat) is this layout
//               with h = T, Wd = (2k+1) T and off = its window offsets.
// ops/hop.py hop_layout mirrors this addressing.
// L, x, add, post, y (V, C) of the operand type T row-major, C a multiple
// of 16, V <= nt*T.  Rows >= V read as zero and are never written.  The
// epilogue (the template parameter EPI): kHopAdd an add operand of type T
// (or none), then the ReLU where `relu` is set; kHopF32Add a float32 add
// operand (read as float2; 8-byte aligned), then the ReLU; kHopSkipAdd and
// kHopSkipProj as kHopAdd, then a T (skip add) or float32 (skip projection)
// `post` operand added after the activation, before the one rounding (the
// strip conv's commuted order with a skip).
//
// Design (Hopper; mma.sync m16n8k16 bf16 on tensor cores, cp.async staging):
//   * Work items are (row tile t, CC-column chunk), t-major.  A persistent
//     grid (about two blocks per SM) gives each block a contiguous run of
//     items, so a block walks many column chunks of one row tile.
//   * Band resident: when a block enters a row tile, each warp reads its 16
//     band rows once, marks every 16 x 16 sub-tile that is all zero (warp
//     ballot over the bytes it reads, 8 sub-tiles a batch; 63-67% of them on
//     the SMPL levels) and keeps the A fragments of its first kHopCap nonzero
//     sub-tiles in registers for all the chunks it walks.  Nonzero sub-tiles
//     beyond that (dense test bands) take their fragments from L2 per chunk.
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

#include "band_hop_f32.cuh"
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

// 16-row source groups the engine stages for the block band
__host__ __device__ constexpr int band_span(int k) { return 8 * (2 * k + 1); }

// Shared memory of the engine's bf16 x ring for CC-column chunks and `span`
// staged 16-row groups (must match ops/hop.py hop_smem).
__host__ __device__ constexpr size_t band_hop_smem(int CC, int span) {
  return (size_t)kHopStages * span * 16 * (CC + 8) * sizeof(bf16);
}

template <typename T, int CC, bool STRIP, int EPI>
__global__ void __launch_bounds__(kThreads, kHopBlocksPerSm)
band_hop_kernel(HopArgsT<T> a, int per_block) {
  constexpr int LD = CC + 8;  // staged row stride: 8 elements of pad against bank conflicts
  constexpr int NQ = CC / 8;  // n8 tiles of a chunk
  constexpr int VE = vec_elems<T>();
  constexpr int VPR = CC / VE;  // 16-byte vectors of a staged row
  constexpr int CAP = kHopCap;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ unsigned long long wmask[kWarps];
  __shared__ int wshift[kWarps];  // STRIP: each warp's staged-row offset into the ring
  T* xs = reinterpret_cast<T*>(smem);
  const int nbd = 2 * a.k + 1;
  const int ngrp = STRIP ? a.span : band_span(a.k);  // staged 16-row groups of a row tile
  const int stage_elems = ngrp * 16 * LD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, cq = lane & 3;
  // the operator's row stride, and sub-tile j of a warp's rows at sub(j)
  // (recomputed where it is used: held in registers it spills)
  const int ld = STRIP ? a.ld : kT;
  const long tile = (long)kT * kT;
  auto sub = [&](int j) -> long {
    return STRIP ? 16L * j : (long)(j / 8) * a.nt * tile + (j % 8) * 16;
  };
  const int nch = a.C / CC, items = a.nt * nch;
  int it = blockIdx.x * per_block;
  const int it_end = min(items, it + per_block);

  while (it < it_end) {
    const int t = it / nch;
    const int n = min(it_end, (t + 1) * nch) - it;  // chunks of tile t in this run
    // 1. this warp's nonzero sub-tiles of operator rows t*T + 16*warp .. +16,
    // in batches of 8 (the strip form's last batch may be partial); a lane
    // reads 8 elements of a sub-tile's row
    const T* brow = a.band + (long)t * kT * ld + warp * 16 * ld;
    const int nsub = STRIP ? a.ld / 16 : 8 * nbd;
    unsigned long long mine = 0;
    for (int d = 0; 8 * d < nsub; ++d) {
      if (!STRIP && (t + d - a.k < 0 || t + d - a.k >= a.nt)) continue;
      const T* bb = brow + sub(8 * d) + (lane / 2) * ld + (lane % 2) * 8;
      uint4 v[8];
#pragma unroll
      for (int cg = 0; cg < 8; ++cg) {
        v[cg] = !STRIP || 8 * d + cg < nsub ? *reinterpret_cast<const uint4*>(bb + cg * 16)
                                            : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int cg = 0; cg < 8; ++cg)
        if (__ballot_sync(0xffffffffu, (v[cg].x | v[cg].y | v[cg].z | v[cg].w) != 0u))
          mine |= 1ull << (d * 8 + cg);
    }
    unsigned af[CAP][4];
    {
      unsigned long long rem = mine;
#pragma unroll
      for (int s = 0; s < CAP; ++s) {
        if (rem) {
          const int j = __ffsll((long long)rem) - 1;
          rem &= rem - 1;
          load_a_global(af[s], brow + sub(j), ld);
        }
      }
    }
    if (lane == 0) {
      if constexpr (STRIP) {
        // the warp's sub-tile j multiplies staged group shift + j, shift =
        // (v0(t, w) - vmin(t)) / 16: its mask and its pointer into the ring
        // move by shift (the offset re-read from shared memory each chunk:
        // held in a register, or applied to `mine` and brow, it spills the
        // 64-column instances)
        const int shift = (a.wrow[t * kWarps + warp] - a.wrow[t * kWarps]) / 16;
        wshift[warp] = shift * 16 * LD;
        wmask[warp] = mine << shift;
      } else {
        wmask[warp] = mine;
      }
    }
    __syncthreads();
    unsigned long long need = 0;  // the staged groups some warp needs
#pragma unroll
    for (int w = 0; w < kWarps; ++w) need |= wmask[w];

    // 2. stage the needed x rows of a chunk: source rows vmin(t) + r
    auto stage = [&](int buf, int c0) {
      T* dst = xs + buf * stage_elems;
      const long v0 = STRIP ? (long)a.wrow[t * kWarps] : (long)(t - a.k) * kT;
      for (int e = threadIdx.x; e < ngrp * 16 * VPR; e += kThreads) {
        const int r = e / VPR, col = (e % VPR) * VE;
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
      const T* xb = xs + (i % kHopStages) * stage_elems + (STRIP ? wshift[warp] : 0);
      float acc[NQ][4];
#pragma unroll
      for (int q = 0; q < NQ; ++q) acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.0f;
      unsigned long long rem = mine;
#pragma unroll
      for (int s = 0; s < CAP; ++s) {
        if (!rem) break;
        const int j = __ffsll((long long)rem) - 1;
        rem &= rem - 1;
        mma_rows<NQ>(acc, af[s], xb + j * 16 * LD, LD);
      }
      while (rem) {  // beyond the register slots: fragments from L2
        const int j = __ffsll((long long)rem) - 1;
        rem &= rem - 1;
        unsigned fa[4];
        load_a_global(fa, brow + sub(j), ld);
        mma_rows<NQ>(acc, fa, xb + j * 16 * LD, LD);
      }
      // 3. epilogue: y = act(alpha * acc + beta * add) (+ post), packed pairs
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
          if constexpr (EPI == kHopF32Add) {
            const float2 ad = *reinterpret_cast<const float2*>(a.addf + off);
            y0 = __fadd_rn(y0, __fmul_rn(a.beta, ad.x));
            y1 = __fadd_rn(y1, __fmul_rn(a.beta, ad.y));
          } else if (a.add) {
            const float2 ad = load2(a.add + off);
            y0 = __fadd_rn(y0, __fmul_rn(a.beta, ad.x));
            y1 = __fadd_rn(y1, __fmul_rn(a.beta, ad.y));
          }
          if (a.relu) {
            y0 = fmaxf(y0, 0.0f);
            y1 = fmaxf(y1, 0.0f);
          }
          if constexpr (EPI == kHopSkipAdd) {
            const float2 ps = load2(a.post + off);
            y0 = __fadd_rn(y0, ps.x);
            y1 = __fadd_rn(y1, ps.y);
          } else if constexpr (EPI == kHopSkipProj) {
            const float2 ps = *reinterpret_cast<const float2*>(a.postf + off);
            y0 = __fadd_rn(y0, ps.x);
            y1 = __fadd_rn(y1, ps.y);
          }
          store2(a.y + off, y0, y1);
        }
      }
      __syncthreads();  // the buffer is restaged two chunks on
    }
    it += n;
  }
}

template <typename T, int CC, bool STRIP, int EPI>
inline cudaError_t launch_band_hop_cc(const HopArgsT<T>& a, int grid, int per_block,
                                      size_t smem, cudaStream_t stream) {
  static_assert(sizeof(T) == 2, "float32 hops run on band_hop_f32.cuh");
  cudaError_t err = cudaFuncSetAttribute(band_hop_kernel<T, CC, STRIP, EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  band_hop_kernel<T, CC, STRIP, EPI><<<grid, kThreads, smem, stream>>>(a, per_block);
  return cudaGetLastError();
}

// The layout's arguments and the operands the epilogue EPI reads, as both
// engines take them.
template <bool STRIP, int EPI, typename T>
inline bool hop_args_ok(const HopArgsT<T>& a) {
  bool ok = a.V <= a.nt * kT && STRIP == (a.wrow != nullptr) &&
            (EPI == kHopF32Add) == (a.addf != nullptr) && !(EPI == kHopF32Add && a.add) &&
            (EPI == kHopSkipAdd) == (a.post != nullptr) &&
            (EPI == kHopSkipProj) == (a.postf != nullptr);
  if (STRIP)
    return ok && a.ld > 0 && a.ld % 16 == 0 && a.ld <= a.nt * kT && a.span >= a.ld / 16 &&
           a.span <= 64;
  return ok && a.k >= 1 && a.k <= 2;
}

// One engine launch over the plan's grid (ops/hop.py hop_plan).  bf16: cc
// columns per chunk (16, 32 or 64, dividing C); float32: the float32
// engine (band_hop_f32.cuh), cc 128.  grid blocks of per_block items
// each.  STRIP: L in its strip form (a.wrow, a.ld and a.span set; a.k is
// not read); otherwise the block band at band_k a.k in {1, 2}, of which the
// bf16 engine stages band_span(a.k) groups.  EPI: the epilogue and the
// operands it reads.
template <bool STRIP = false, int EPI = kHopAdd, typename T>
inline cudaError_t launch_band_hop(const HopArgsT<T>& a0, int cc, int grid, int per_block,
                                   cudaStream_t stream) {
  if (!hop_args_ok<STRIP, EPI>(a0)) return cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 4) {
    return launch_band_hop_f32<STRIP, EPI>(a0, cc, grid, per_block, stream);
  } else {
    HopArgsT<T> a = a0;
    if (!STRIP) a.span = band_span(a.k);
    const long items = (long)a.nt * (a.C / (cc > 0 ? cc : 1));
    if (cc <= 0 || a.C % cc || grid <= 0 || per_block <= 0 || (long)grid * per_block < items)
      return cudaErrorInvalidValue;
    if ((reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.y) |
         reinterpret_cast<uintptr_t>(a.add) | reinterpret_cast<uintptr_t>(a.post)) % 16 ||
        (reinterpret_cast<uintptr_t>(a.addf) | reinterpret_cast<uintptr_t>(a.postf)) % 8)
      return cudaErrorMisalignedAddress;
    const size_t smem = band_hop_smem(cc, a.span);
    if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
    switch (cc) {
      case 16: return launch_band_hop_cc<T, 16, STRIP, EPI>(a, grid, per_block, smem, stream);
      case 32: return launch_band_hop_cc<T, 32, STRIP, EPI>(a, grid, per_block, smem, stream);
      case 64: return launch_band_hop_cc<T, 64, STRIP, EPI>(a, grid, per_block, smem, stream);
      default: return cudaErrorInvalidValue;
    }
  }
}

}  // namespace p2m
