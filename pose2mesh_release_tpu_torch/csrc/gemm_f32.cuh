// The float32 instances' matrix products on Hopper: 3xTF32 on wgmma, every
// operand element split once.
//
//   D[64 rows, N) (+)= A[64, K) B[K, N)   per warpgroup, in float32
//
// Used by the float32 projection GEMM (cheby_proj.cuh, the float32 instance
// of cheby_proj_kernel: K1, the group, commuted, strip and window convs) and
// by K2's float32 dx and dW products (fused_cheby_bwd.cu), in place of the
// per-warp mma.sync 3xTF32 k-loop of the first float32 instances.  Each
// product replaces part of a TPU kernel's body: the projections of
// `_fused_kernel_factory`, `_commuted_kernel_factory`, `_fused_call`'s kernel
// (pose2mesh_release_tpu/ops/pallas_cheby.py), of ops/pallas_strip.py and
// ops/pallas_window.py, and the dx and dW products of `_bwd_kernel_factory`.
//
// Scheme, a warp-specialized block: consumer warpgroups first, then the
// producer warpgroups (one or two), for 32-deep k-tiles:
//   * the producers copy each k-tile raw (float32) into an S-stage cp.async
//     ring and split every element x of A and of B, once per block, into
//     its TF32 parts big = rna(x) and small = rna(x - big) (x = big + small
//     to about 2^-22 of x; cvt.rna.tf32.f32's rounding, as an integer add
//     and mask): four planes, A big, A small, B big, B small, in two
//     buffers; FULL / FREE named barriers hand a buffer to the consumers and
//     back (f32_produce), so the split and the copies run while the tensor
//     cores multiply;
//   * each plane is K-major (a row holds the tile's 32 k of one M or N index,
//     128 bytes) in the 128-byte swizzle of wgmma's descriptors: row r's
//     16-byte chunk c (k = 4c .. 4c + 3) sits at byte r * 128 + ((c ^ (r % 8))
//     * 16) of a 1024-byte-aligned plane.  A raw tile that is K-major (the
//     projection's A, dx's A and B) is split row by row; one that is M- or
//     N-major (the projection's W, dW's u and G) is transposed by the same
//     pass.  Both are free of bank conflicts;
//   * each consumer warpgroup issues per k8 step three wgmma.m64nNk8.tf32
//     products, small x big, big x small, big x big (small x small is below
//     float32's precision), into a partial of the k-tile (the first with
//     scale-d 0), then adds it into the running sum with IEEE adds
//     (f32_consume): the partial-and-add of the mma.sync scheme at a quarter
//     of its adds.
// The wgmma accumulator repeats mma.sync m16n8's C fragment over N / 8: warp
// w of a warpgroup holds rows 16 w + lane / 4 (+ 8) and columns 8 i + 2 (lane
// % 4) (+ 1) in d[4 i .. 4 i + 3], so the GEMMs' epilogues read it as the
// m16n8 tiles acc[0][i][0 .. 3] of a 16-row warp.
//
// Bound on the H100: 3 products on TF32 tensor cores, 495 / 3 TFLOP/s for the
// float32 product; at 128 -> 128 a projection does ~48 operations per byte of
// A, the balance point of that rate and 3.35 TB/s, so operations and bytes
// bound it alike.
#pragma once

#include <cstdint>

#include "band_hop.cuh"

namespace p2m {

constexpr int kF32BK = 32;      // k-tile depth: one 128-byte swizzle row of TF32
constexpr int kF32Align = 1024; // plane alignment (the 128-byte swizzle's atom)
// the warp-specialized block: consumer warpgroups first (wgmma), then the
// producer warpgroups (cp.async, the split pass); named barriers FULL and
// FREE of each of the two plane buffers, one among the producers' threads,
// one among the consumers'
constexpr int kBarFull = 1, kBarFree = 3, kBarProducer = 5, kBarConsumer = 6;
// registers a thread of the projection's and dx's blocks (two consumer and
// two producer warpgroups: 65536 in all) after setmaxnreg
constexpr int kF32ConsumerRegs = 168, kF32ProducerRegs = 88;

// The shared memory of a float32 GEMM block of an RA-row A tile and RB-row B
// tile: two buffers of four planes, then the ring of `stages` raw k-tiles (A
// then B, RA x 32 and 32 x RB float32), after up to kF32Align bytes of
// alignment slack; each a multiple of 1024 bytes.
__host__ __device__ constexpr size_t gemm_f32_smem(int RA, int RB, int stages) {
  return (size_t)kF32Align + (size_t)(4 + stages) * (RA + RB) * kF32BK * 4;
}

// Pointers into that shared memory: plane buffer p, raw stage s.
struct F32Smem {
  uint32_t* planes;
  int ra, rb;
  __device__ F32Smem(unsigned char* smem, int RA, int RB) : ra(RA), rb(RB) {
    planes = reinterpret_cast<uint32_t*>(
        smem + ((kF32Align - smem_u32(smem) % kF32Align) % kF32Align));
  }
  __device__ uint32_t* a_big(int p) const { return planes + p * 2 * (ra + rb) * kF32BK; }
  __device__ uint32_t* a_small(int p) const { return a_big(p) + ra * kF32BK; }
  __device__ uint32_t* b_big(int p) const { return a_small(p) + ra * kF32BK; }
  __device__ uint32_t* b_small(int p) const { return b_big(p) + rb * kF32BK; }
  __device__ float* raw_a(int s) const {
    return reinterpret_cast<float*>(planes + (4 + s) * (ra + rb) * kF32BK);
  }
  __device__ float* raw_b(int s) const { return raw_a(s) + ra * kF32BK; }
};

// x rounded to TF32, to nearest with ties away from zero (its float32 bits,
// the low 13 bits zero): cvt.rna.tf32.f32's rounding, bit for bit on finite
// x, as one integer add and one mask (the split pass's hot loop)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// Row r's chunk c (k = 4c .. 4c+3) of a plane: its big and small TF32 parts.
__device__ __forceinline__ void put_split(uint32_t* big, uint32_t* small, int r, int c,
                                          float4 v) {
  uint4 hb, hs;
  hb.x = tf32_rna(v.x);
  hb.y = tf32_rna(v.y);
  hb.z = tf32_rna(v.z);
  hb.w = tf32_rna(v.w);
  hs.x = tf32_rna(v.x - __uint_as_float(hb.x));
  hs.y = tf32_rna(v.y - __uint_as_float(hb.y));
  hs.z = tf32_rna(v.z - __uint_as_float(hb.z));
  hs.w = tf32_rna(v.w - __uint_as_float(hb.w));
  const int off = r * kF32BK + ((c ^ (r & 7)) << 2);
  *reinterpret_cast<uint4*>(big + off) = hb;
  *reinterpret_cast<uint4*>(small + off) = hs;
}

// Split a K-major raw tile (R rows of 32 float32) into its planes; NT threads.
template <int R, int NT>
__device__ __forceinline__ void split_rows(const float* raw, uint32_t* big, uint32_t* small) {
#pragma unroll 4
  for (int e = threadIdx.x % NT; e < R * 8; e += NT)
    put_split(big, small, e >> 3, e & 7, *reinterpret_cast<const float4*>(raw + e * 4));
}

// Split an M- or N-major raw tile (32 k rows of R float32) into the planes
// of its transpose; op(v, n, c) may rewrite row n's values at k = 4c .. 4c+3
// first.  NT threads, NT a multiple of R or R of NT.
template <int R, int NT, typename Op>
__device__ __forceinline__ void split_cols(const float* raw, uint32_t* big, uint32_t* small,
                                           Op op) {
#pragma unroll 4
  for (int e = threadIdx.x % NT; e < R * 8; e += NT) {
    const int n = e % R, c = e / R;
    const float* q = raw + 4 * c * R + n;
    float4 v = make_float4(q[0], q[R], q[2 * R], q[3 * R]);
    op(v, n, c);
    put_split(big, small, n, c, v);
  }
}

// Make the split pass's shared-memory stores visible to wgmma (the async
// proxy); a barrier follows.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The descriptor of a K-major plane in the 128-byte swizzle: rows 128 bytes
// apart, 8-row atoms 1024 bytes apart (SBO), LBO unused (1).
__device__ __forceinline__ uint64_t gmma_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// keeps the compiler from moving wgmma's accumulator registers across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}


// d (+)= A @ B for one k8 step of the planes' descriptors; scale_d 0 writes d
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], uint64_t a, uint64_t b,
                                           int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[8], uint64_t a, uint64_t b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], uint64_t a, uint64_t b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], uint64_t a, uint64_t b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], uint64_t a, uint64_t b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// part = the warpgroup's 64 rows of A @ B over one k-tile of plane buffer
// p: the three products of each k8 step, issued without waiting (a_row0:
// the warpgroup's first A row).
template <int N>
__device__ __forceinline__ void tf32x3_issue(float (&part)[N / 2], const F32Smem& sm, int p,
                                             int a_row0) {
  const uint64_t ab = gmma_desc(sm.a_big(p) + a_row0 * kF32BK);
  const uint64_t as = gmma_desc(sm.a_small(p) + a_row0 * kF32BK);
  const uint64_t bb = gmma_desc(sm.b_big(p)), bs = gmma_desc(sm.b_small(p));
  fence_operands(part);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int k8 = 0; k8 < kF32BK / 8; ++k8) {
    const uint64_t o = 2 * k8;  // 32 bytes a k8 step, in 16-byte units
    wgmma_tf32<N>(part, as + o, bb + o, k8 > 0);
    wgmma_tf32<N>(part, ab + o, bs + o, 1);
    wgmma_tf32<N>(part, ab + o, bb + o, 1);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void regs_producer() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kF32ProducerRegs));
}
__device__ __forceinline__ void regs_consumer() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kF32ConsumerRegs));
}

// The NP producer threads' side of a block's work (NP / 128 warpgroups):
// `count` k-tiles in one sequence (over all its output tiles).  load(s, q)
// issues k-tile q's raw cp.async copies into raw stage s; split(s, q, b)
// splits raw stage s (k-tile q) into plane buffer b.  S raw stages in flight; plane buffer q % 2 is
// refilled once the consumers have released it (FREE), then handed to them
// (FULL).  `threads`: the block's.
template <int S, int NP, typename Load, typename Split>
__device__ __forceinline__ void f32_produce(int count, int threads, Load load, Split split) {
#pragma unroll
  for (int st = 0; st < S; ++st) {
    if (st < count) load(st, st);
    cp_async_commit();
  }
  for (int q = 0; q < count; ++q) {
    // k-tile q is cp.async group q: the prologue's S groups, then one group
    // (empty past the last k-tile) each iteration from q = 1 on
    if (q == 0)
      cp_async_wait<S - 1>();
    else
      cp_async_wait<S - 2>();
    bar_sync(kBarProducer, NP);  // k-tile q landed; the split of q - 1 is done
    if (q > 0) {  // refill the stage k-tile q - 1 was split from
      if (q - 1 + S < count) load((q - 1) % S, q - 1 + S);
      cp_async_commit();
    }
    if (q >= 2) bar_sync(kBarFree + (q & 1), threads);
    split(q % S, q, q & 1);
    fence_proxy_async();
    bar_arrive(kBarFull + (q & 1), threads);
  }
  cp_async_wait<0>();
}

// A consumer warpgroup's side of k-tile q: acc[0][i][j] += its rows
// (a_row0 ..) of A @ B over the k-tile once the producer has handed plane
// buffer q % 2 over; the buffer is released as soon as the products landed.
template <int N>
__device__ __forceinline__ void f32_consume(float (&acc)[1][N / 8][4], const F32Smem& sm, int q,
                                            int a_row0, int threads) {
  float part[N / 2];
  bar_sync(kBarFull + (q & 1), threads);
  tf32x3_issue<N>(part, sm, q & 1, a_row0);
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_operands(part);
  bar_arrive(kBarFree + (q & 1), threads);
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[0][i][j] = __fadd_rn(acc[0][i][j], part[4 * i + j]);
}

}  // namespace p2m
