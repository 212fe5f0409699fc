// The banded hop engine's float32 form: y[:, cols] = act(alpha * (L x)[:, cols]
// + beta * add[:, cols]) (+ post[:, cols]) for the banded Laplacian L, every
// operand float32, exact float32 FMAs over the band's nonzeros, nothing
// rounded but each FMA and the epilogue's IEEE multiplies and adds.
//
// It computes the hops of every float32 instance: K4 (csrc/banded_hop.cu),
// the hops of K1, K2, the group and commuted deploy convs and of the strip
// and window convs (launch_band_hop in band_hop.cuh sends T = float here), in
// place of the TPU kernels' hop bodies at float32 (pose2mesh_release_tpu/
// ops/pallas_cheby.py `_hop_kernel_factory` and the hops of the fused
// kernels, ops/pallas_strip.py `hop`).  Its contract is the bf16 engine's
// (band_hop.cuh): the same HopArgsT, both layouts of L (the block band at
// band_k 1 or 2, its out-of-range neighbour blocks skipped; the strip form
// through `wrow`, `ld`, with the window form its case h = T) and the four
// epilogues, which at float32 reduce to an optional add operand `add` (add,
// or addf of kHopF32Add) and an optional post-activation operand `post`
// (post of kHopSkipAdd, postf of kHopSkipProj).  Rows >= V are never
// written; source rows < 0 or >= V contribute nothing and x is not read
// there.
//
// Design (Hopper; CUDA cores, no tensor cores):
//   * Work items are (row tile t, 128-column chunk), t-major; each block
//     takes a run of them (ops/hop.py hop_plan: one chunk a block, which
//     measured fastest once the list pass took the band reads out of the
//     blocks).
//   * The list pass (band_hop_f32_lists, launched just before the stream
//     on the same stream): a block for each (row tile, warp), a warp for
//     each of that warp's 16 operator rows, every 128-column step of the
//     row loaded together (a float4 a lane); a ballot and a popcount per
//     column of a lane's float4 count and place the row's nonzeros, the
//     rows' counts give their offsets.  It writes each warp's list (rows in
//     order, columns in order within a row, each entry (source row,
//     value)) and its 17 row offsets to stream-ordered scratch, so a hop
//     reads the band once, not once for each run of chunks.  When a block
//     of the stream enters a row tile, each warp copies its list into
//     shared memory; the list serves every chunk of the block's run in
//     that tile.  A warp with more than kF32ListCap entries (only dense
//     test bands) keeps the first kF32ListCap there and walks the rest in
//     batches, rebuilt from the band rows in L2 for each chunk.
//   * The stream: all lanes work on one operator row at a time (rows of
//     unequal length do not diverge), a lane on a float4 of the chunk.  Per
//     row: the loads of x[s, cols] for kF32Batch entries issued together
//     (predicated: no remainder loop), then acc = fmaf(v, x[s, cols], acc)
//     in list order, then the epilogue with __fmul_rn / __fadd_rn and one
//     float4 store; the add operand of the next row loads while this row
//     sums.  Only one row's sum is live; no block barrier.
//   * x is read at each entry through the read-only path: a source row is
//     read again by each of its ~7 neighbours, from L1 or L2 (a warp's 16
//     rows read ~2 entries per distinct source, a row tile ~3).  y, add and
//     post are streamed (evict first), so they do not push x and the band
//     out of L2.  Measured and dropped (PERF.md): staging the row tile's
//     source groups in a shared-memory cp.async ring (32- or 64-column
//     chunks), each warp's list in source order with its rows' sums in
//     shared memory, each source loaded once for four rows with their sums
//     in registers, 64-column chunks or two float4s a lane, a block barrier
//     after each chunk, two band rows loaded per round of the list build,
//     a shared-memory carve-out hint for a larger L1, band loads that
//     bypass L1.
//   * The summation order is fixed and there are no atomics: two runs give
//     equal bits.
// Bound on the H100: at the band's nonzeros a hop does 2 operations per
// nonzero and column against 8 bytes per vertex and column (x read once, y
// written once), ~1.75 operations per byte at SMPL: an order of magnitude
// under float32's ridge, so device memory bounds it and exact FMAs cost
// nothing against the tensor cores' 3xTF32.  It runs at ~2.1x that bound at
// SMPL's 6890 level (tools/hop_sweep.py): the list pass and one chunk a
// block took it from ~2.8x, where loading each source once for four rows (a
// third fewer x loads) had not moved it.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace p2m {

// entries of a warp's nonzero list (ops/hop.py F32_LIST_CAP)
constexpr int kF32ListCap = 256;
// columns of a chunk (a float4 a lane; ops/hop.py F32_CHUNK), entries of a
// row whose loads a warp issues together, blocks an SM (the launch bounds)
constexpr int kF32Chunk = 128;
constexpr int kF32Batch = 8;
constexpr int kF32BlocksPerSm = 3;
// 128-column steps of a band row (a strip row of 64 groups at most) and the
// list pass's threads (a warp for each of a warp's 16 rows)
constexpr int kF32Steps = 8;
constexpr int kF32ListThreads = 16 * 32;

// Static shared memory of one block: each warp's list and its 17 row
// offsets (must match ops/hop.py hop_f32_smem).
__host__ __device__ constexpr size_t band_hop_f32_smem() {
  return (size_t)kWarps * (kF32ListCap * 8 + 17 * 4);
}

// Device scratch of the lists of nt row tiles: each warp's first
// kF32ListCap entries, then each warp's 17 row offsets.
__host__ __device__ constexpr size_t band_hop_f32_scratch(int nt) {
  return (size_t)nt * kWarps * (kF32ListCap * 8 + 17 * 4);
}

// A row's nonzeros in list order are its band columns in order, kept where
// the value is nonzero and the source row lies in [0, V).  steps_nonzeros
// loads G of the 128-column steps of row r of warp `warp` in row tile t
// from step s0 on (a float4 a lane, all together; a block-band step is one
// neighbour block, skipped out of range; none where `live` is false) and
// ballots each column of a lane's float4: `v` the values, `m` the ballots,
// `src` the x row of the lane's first column of step s0.  Returns the
// entries.
template <bool STRIP, int G>
__device__ __forceinline__ int steps_nonzeros(const HopArgsT<float>& a, int t, int warp, int r,
                                              int s0, bool live, float4 (&v)[G],
                                              unsigned (&m)[G][4], long& src) {
  const int lane = threadIdx.x % 32;
  const int ld = STRIP ? a.ld : kT;
  const float* brow = a.band + ((long)t * kT + warp * 16 + r) * ld;
  const int steps = STRIP ? (a.ld + 127) / 128 : 2 * a.k + 1;
  src = (STRIP ? (long)a.wrow[t * kWarps + warp] : (long)(t - a.k) * kT) + s0 * 128 + 4 * lane;
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const int s = s0 + q, c = s * 128 + 4 * lane;
    const bool in = live && s < steps &&
                    (STRIP ? c < a.ld : t + s - a.k >= 0 && t + s - a.k < a.nt);
    const float* p = brow + (STRIP ? (long)c : (long)s * a.nt * kT * kT + 4 * lane);
    v[q] = in ? __ldg(reinterpret_cast<const float4*>(p)) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  int n = 0;
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const float val[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long x = src + q * 128 + e;
      m[q][e] = __ballot_sync(0xffffffffu, val[e] != 0.0f && x >= 0 && x < a.V);
      n += __popc(m[q][e]);
    }
  }
  return n;
}

// The entries of steps_nonzeros' steps, the first of them entry `pos` of
// the warp's list, into list[0 ..): those in [lo, lo + kF32ListCap) at
// list[i - lo]; in a step, every kept column of the lower lanes first.
template <int G>
__device__ __forceinline__ void steps_entries(const float4 (&v)[G], const unsigned (&m)[G][4],
                                              long src, int pos, int lo, int2* list) {
  const int lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const float val[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
    int p = pos;
#pragma unroll
    for (int e = 0; e < 4; ++e) p += __popc(m[q][e] & below);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if ((m[q][e] >> lane) & 1u) {
        if (p >= lo && p < lo + kF32ListCap)
          list[p - lo] = make_int2((int)(src + q * 128 + e), __float_as_int(val[e]));
        ++p;
      }
      pos += __popc(m[q][e]);
    }
  }
}

// The list pass: block t * kWarps + w (a warp for each of warp w's 16 rows
// of row tile t, every step of its row loaded together) writes warp w's
// first kF32ListCap entries to lists[block][..] and its 17 row offsets (the
// rows' first entries, then the count) to roffs[block][..]; nothing for a
// warp with no rows below V.
template <bool STRIP>
__global__ void __launch_bounds__(kF32ListThreads)
band_hop_f32_lists(HopArgsT<float> a, int2* __restrict__ lists, int* __restrict__ roffs) {
  __shared__ int count[16];
  const int t = blockIdx.x / kWarps, warp = blockIdx.x % kWarps, r = threadIdx.x / 32;
  const int rows = min(16, a.V - (t * kT + warp * 16));
  if (rows <= 0) return;
  float4 v[kF32Steps];
  unsigned m[kF32Steps][4];
  long src;
  const int n = steps_nonzeros<STRIP, kF32Steps>(a, t, warp, r, 0, r < rows, v, m, src);
  if (threadIdx.x % 32 == 0) count[r] = n;  // 0 for the rows >= V
  __syncthreads();
  int pos = 0, total = 0;
  for (int i = 0; i < 16; ++i) {
    pos += i < r ? count[i] : 0;
    total += count[i];
  }
  int* roff = roffs + (long)blockIdx.x * 17;
  if (threadIdx.x % 32 == 0 && r < rows) roff[r] = pos;
  if (threadIdx.x == 0) roff[rows] = total;
  if (r < rows) steps_entries(v, m, src, pos, 0, lists + (long)blockIdx.x * kF32ListCap);
}

// Entries lo .. lo + kF32ListCap of the warp's list (roff set), rebuilt
// from the band rows into list[0 ..): the rows from the one holding entry
// lo until entry lo + kF32ListCap is reached, one step of a row at a time
// (more registers here spill the strip layout's stream).  Only a warp with
// more than kF32ListCap entries (dense test bands) walks it.
template <bool STRIP>
__device__ __forceinline__ void hop_list_batch(const HopArgsT<float>& a, int t, int warp,
                                               int rows, int lo, int2* list, const int* roff) {
  const int steps = STRIP ? (a.ld + 127) / 128 : 2 * a.k + 1;
  __syncwarp();
  int r = 0;
  while (roff[r + 1] <= lo) ++r;
  for (; r < rows && roff[r] < lo + kF32ListCap; ++r) {
    int pos = roff[r];
    for (int s0 = 0; s0 < steps; ++s0) {
      float4 v[1];
      unsigned m[1][4];
      long src;
      const int n = steps_nonzeros<STRIP, 1>(a, t, warp, r, s0, true, v, m, src);
      steps_entries(v, m, src, pos, lo, list);
      pos += n;
    }
  }
  __syncwarp();
}

// acc += sum over the list entries beg .. end, in order, of v * x[s, c0 ..
// c0 + 4) (c0 includes the lane's offset; nothing where c0 >= C):
// kF32Batch entries at a time, their loads issued together (predicated, no
// remainder loop), then their FMAs in order.
__device__ __forceinline__ void fma_row(float (&acc)[4], const int2* list, int beg, int end,
                                        const HopArgsT<float>& a, int c0) {
  if (c0 >= a.C) return;
  for (int e = beg; e < end; e += kF32Batch) {
    float v[kF32Batch], xv[kF32Batch][4];
#pragma unroll
    for (int j = 0; j < kF32Batch; ++j) {
      const int2 en = e + j < end ? list[e + j] : make_int2(0, 0);
      v[j] = __int_as_float(en.y);
      const float4 u = e + j < end
                           ? __ldg(reinterpret_cast<const float4*>(a.x + (long)en.x * a.C + c0))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      xv[j][0] = u.x, xv[j][1] = u.y, xv[j][2] = u.z, xv[j][3] = u.w;
    }
#pragma unroll
    for (int j = 0; j < kF32Batch; ++j)
      if (e + j < end)
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[n] = fmaf(v[j], xv[j][n], acc[n]);
  }
}

// 4 floats of row v at the lane's columns c0 .. c0 + 4 of the (V, C) operand
// p, or zeros where p is null or c0 >= C; read once, so streamed (evict
// first) past L2, where x and the band stay
__device__ __forceinline__ float4 load_operand(const float* p, long v, int C, int c0) {
  return p && c0 < C ? __ldcs(reinterpret_cast<const float4*>(p + v * C + c0))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
}

// One chunk of the warp's rows r0 + r, r < rows: y[r0 + r, c0 .. c0 + 4) =
// act(alpha * sum over the row's entries of v * x[s, c0 ..) + beta * add)
// (+ post), one row after the other; the add operand of the next row loads
// while this row sums.  The warp's list runs in batches of kF32ListCap
// where nb > 1 (`held` the batch the list holds).
template <bool STRIP>
__device__ __forceinline__ void hop_rows(const HopArgsT<float>& a, const float* add,
                                         const float* post, int t, int warp, int rows,
                                         int total, int nb, int& held, int2* list, int* roff,
                                         int c0) {
  const long r0 = (long)t * kT + warp * 16;
  float acc[4] = {};
  float4 ad = load_operand(add, r0, a.C, c0);
  float4 ad_next = load_operand(rows > 1 ? add : nullptr, r0 + 1, a.C, c0);
  int r = 0;
  for (int b = 0; b < nb; ++b) {
    const int lo = b * kF32ListCap, hi = min(total, lo + kF32ListCap);
    if (b != held) {
      hop_list_batch<STRIP>(a, t, warp, rows, lo, list, roff);
      held = b;
    }
    for (; r < rows; ++r) {
      const int end = roff[r + 1];
      const float4 ps = load_operand(end <= hi ? post : nullptr, r0 + r, a.C, c0);
      fma_row(acc, list - lo, max(roff[r], lo), min(end, hi), a, c0);
      if (end > hi) break;  // the row goes on in the next batch
      if (c0 < a.C) {  // epilogue: y = act(alpha * acc + beta * add) (+ post)
        const float av[4] = {ad.x, ad.y, ad.z, ad.w}, pv[4] = {ps.x, ps.y, ps.z, ps.w};
        float y[4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          y[n] = __fmul_rn(a.alpha, acc[n]);
          if (add) y[n] = __fadd_rn(y[n], __fmul_rn(a.beta, av[n]));
          if (a.relu) y[n] = fmaxf(y[n], 0.0f);
          if (post) y[n] = __fadd_rn(y[n], pv[n]);
          acc[n] = 0.0f;
        }
        // written once: streamed past L2
        __stcs(reinterpret_cast<float4*>(a.y + (r0 + r) * a.C + c0),
               make_float4(y[0], y[1], y[2], y[3]));
      }
      ad = ad_next;
      ad_next = load_operand(r + 2 < rows ? add : nullptr, r0 + r + 2, a.C, c0);
    }
  }
}

template <bool STRIP>
__global__ void __launch_bounds__(kThreads, kF32BlocksPerSm)
band_hop_f32_kernel(HopArgsT<float> a, const float* __restrict__ add,
                    const float* __restrict__ post, const int2* __restrict__ lists,
                    const int* __restrict__ roffs, int per_block) {
  __shared__ int2 wlists[kWarps][kF32ListCap];
  __shared__ int wroffs[kWarps][17];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int2* list = wlists[warp];
  int* roff = wroffs[warp];
  const int nch = (a.C + kF32Chunk - 1) / kF32Chunk, items = a.nt * nch;
  int it = blockIdx.x * per_block;
  const int it_end = min(items, it + per_block);
  while (it < it_end) {
    const int t = it / nch;
    const int n = min(it_end, (t + 1) * nch) - it;  // chunks of tile t in this run
    const int rows = min(16, a.V - (t * kT + warp * 16));  // the warp's rows below V
    if (rows > 0) {  // the warp's list from the list pass
      const long g = (long)t * kWarps + warp;
      for (int i = lane; i <= rows; i += 32) roff[i] = __ldg(roffs + g * 17 + i);
      const int total = __ldg(roffs + g * 17 + rows);
      for (int i = lane; i < min(total, kF32ListCap); i += 32)
        list[i] = __ldg(lists + g * kF32ListCap + i);
      __syncwarp();
      const int nb = max(1, (total + kF32ListCap - 1) / kF32ListCap);
      int held = 0;
      for (int i = 0; i < n; ++i)
        hop_rows<STRIP>(a, add, post, t, warp, rows, total, nb, held, list, roff,
                        ((it + i) % nch) * kF32Chunk + 4 * lane);
    }
    it += n;
  }
}

// One launch of the float32 engine over the plan's grid (ops/hop.py
// hop_plan at 4-byte elements): cc must be kF32Chunk (C a multiple of 16,
// the last chunk masked); grid blocks of per_block items each.  The caller
// (launch_band_hop) has checked the layout's arguments and the epilogue's
// operands.
template <bool STRIP, int EPI>
inline cudaError_t launch_band_hop_f32(const HopArgsT<float>& a, int cc, int grid,
                                       int per_block, cudaStream_t stream) {
  const float* add = EPI == kHopF32Add ? a.addf : a.add;
  const float* post = EPI == kHopSkipAdd ? a.post : EPI == kHopSkipProj ? a.postf : nullptr;
  const long items = (long)a.nt * ((a.C + kF32Chunk - 1) / kF32Chunk);
  if (cc != kF32Chunk || a.C <= 0 || a.C % 16 || grid <= 0 || per_block <= 0 ||
      (long)grid * per_block < items)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(a.band) | reinterpret_cast<uintptr_t>(a.x) |
       reinterpret_cast<uintptr_t>(a.y) | reinterpret_cast<uintptr_t>(add) |
       reinterpret_cast<uintptr_t>(post)) % 16)
    return cudaErrorMisalignedAddress;
  // the lists, stream-ordered scratch from the device's pool, which keeps
  // what is freed (no release at each synchronization)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static bool pool_kept[64] = {};
  if (dev < 64 && !pool_kept[dev]) {
    cudaMemPool_t pool;
    unsigned long long keep = ~0ull;
    err = cudaDeviceGetDefaultMemPool(&pool, dev);
    if (err == cudaSuccess)
      err = cudaMemPoolSetAttribute(pool, cudaMemPoolAttrReleaseThreshold, &keep);
    if (err != cudaSuccess) return err;
    pool_kept[dev] = true;
  }
  const int warps = a.nt * kWarps;
  int2* lists = nullptr;
  err = cudaMallocAsync(reinterpret_cast<void**>(&lists), band_hop_f32_scratch(a.nt), stream);
  if (err != cudaSuccess) return err;
  int* roffs = reinterpret_cast<int*>(lists + (size_t)warps * kF32ListCap);
  band_hop_f32_lists<STRIP><<<warps, kF32ListThreads, 0, stream>>>(a, lists, roffs);
  band_hop_f32_kernel<STRIP><<<grid, kThreads, 0, stream>>>(a, add, post, lists, roffs,
                                                            per_block);
  err = cudaGetLastError();
  const cudaError_t freed = cudaFreeAsync(lists, stream);
  return err != cudaSuccess ? err : freed;
}

}  // namespace p2m
