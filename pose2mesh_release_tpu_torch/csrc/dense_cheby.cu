// The dense levels' K=3 Chebyshev basis over L's nonzeros, forward and
// backward, one launch each.
//
// Replaces no TPU kernel.  The JAX package computes a dense level's hop as an
// XLA product (ops/spmm.py spmm_dense: jnp.dot of the (V, V) matrix on the
// MXU) and stacks the basis with jnp.stack (ops/cheby.py chebyshev_stack).
// Ported as they were, those became a float32 SIMT GEMM over a matrix whose
// entries are 98.7-99.5% zero (SMPL's 520 / 276 / 148 / 88 vertices hold 7
// nonzeros a row on average) and a stack copy; this kernel takes their place
// on the card (ops/dense_cheby.py dense_cheby_stack).
//
// Forward: x (V, C) -> out (V, 3C) fin-major, out[v, 3c + k] = [x, z1, z2][k][v, c]:
//   z1 = R(L x),   z2 = R(2 R(L z1) - x)
// Backward (L symmetric, so the VJP of a hop is the same hop): the cotangent
// g (V, 3C) = [g0, g1, g2] fin-major -> dx (V, C):
//   u = R(g1 + 2 R(L g2)),   dx = R(R(g0 - g2) + R(L u))
// R rounds to the operand type T (bf16; float32: no rounding), at the points
// where the plain version (chebyshev_stack and autograd through it) rounds;
// sums accumulate in float32 (bf16 products are exact in float32, so the bf16
// forward differs from the plain version only in the order of its sums).
// L comes as rows: ptr (V+1) int32, col (nnz) int32, val (nnz) of type T
// (graphs/artifact.py dense_rows: the level's ELL form without its zeros).
//
// Design (a bandwidth and latency problem: 2 nnz multiply-adds a column per
// hop, ~14 a column over V = 520 rows, against 4 elements moved):
//   * L acts on the vertex axis alone, so the columns are independent.  Block
//     b takes the w-column slice [b w, b w + w) of all V rows: it stages L's
//     rows as (column, float value) pairs, and the slice of its input, in
//     shared memory, runs both hops there (the first hop's result in a second
//     buffer), and writes its output: no grid-wide sync, one launch.
//   * Thread i of the block's n takes the column pair p = i % (w/2) and the
//     rows i / (w/2) + k 2n/w: a warp reads one 128-byte run of a source row
//     per nonzero (w = 64 bf16, 32 float32) or the runs of 2-16 rows
//     (narrower slices).  n (ops/dense_cheby.py dense_plan: up to 1024, one
//     thread a (row, pair)) is wide because a block holds its SM's shared
//     memory alone at the widest slices: its warps hide each other's
//     shared-memory latency.
//   * The backward reads each row's run of the cotangent (3w elements) whole
//     and keeps g2 and g1 in the two buffers (the first hop turns g1 into u
//     in place, each thread on its own elements); g0 is read at the end.
//   * w (a power of two, 2..64 bf16, 2..32 float32) is chosen by ops/
//     dense_cheby.py dense_plan from V, nnz, the element size and C: the widest
//     slice whose buffers fit 200 KB and whose grid covers the SMs, else the
//     narrowest, so narrow inputs (the joint graph at 5 channels, batch 1)
//     still spread over the card.
//   * The stack is written where the projection reads it: each thread writes
//     its pair's six values (x, z1, z2 of each column) as three 2-element
//     stores, so a warp stores one contiguous run of 3 x (its columns) a row.
//     Where C is odd (or a pointer is not pair-aligned) every access is
//     scalar.
// Bound on the H100: bytes.  SMPL's 520 level at 256 channels, batch 64: x
// 17 MB read, the stack 51 MB written: 20 us at 3.35 TB/s bf16, 41 us float32.
#include <cstdint>

#include "common.cuh"

using namespace p2m;

namespace {

constexpr int kDenseMaxThreads = 1024;

struct Nz {
  int col;
  float val;
};

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }

// v rounded to T, as a float.
template <typename T>
__device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

// Columns c and c + 1 of one row, p at column c and `stride` elements
// between columns, `left` = C - c columns in range (a column out of range
// reads 0); one 2-element load where `pair` (stride 1, aligned).
template <typename T>
__device__ __forceinline__ float2 load_cols(const T* p, int stride, bool pair, int left) {
  if (left <= 0) return make_float2(0.0f, 0.0f);
  if (pair) return load2(p);
  return make_float2(to_f(p[0]), left > 1 ? to_f(p[stride]) : 0.0f);
}

// Shared memory: the (col, val) table, the row offsets, then two V x w
// buffers of T (16-byte aligned).  ops/dense_cheby.py dense_smem mirrors it.
__host__ __device__ inline size_t dense_table_bytes(int V, int nnz) {
  return ((size_t)8 * nnz + (size_t)4 * (V + 1) + 15) / 16 * 16;
}

template <typename T, bool BWD>
__global__ void __launch_bounds__(kDenseMaxThreads)
dense_cheby_kernel(const int* __restrict__ ptr, const int* __restrict__ col,
                   const T* __restrict__ val, const T* __restrict__ in, T* __restrict__ out,
                   int V, int C, int nnz, int lw) {
  extern __shared__ __align__(16) unsigned char smem[];
  Nz* tab = reinterpret_cast<Nz*>(smem);
  int* rp = reinterpret_cast<int*>(smem + (size_t)8 * nnz);
  const int w = 1 << lw, lp = lw - 1, np = 1 << lp;
  T* b0 = reinterpret_cast<T*>(smem + dense_table_bytes(V, nnz));
  T* b1 = b0 + (size_t)V * w;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int c0 = blockIdx.x * w;
  // 2-element global accesses: C even and the pointers pair-aligned
  const bool pair = (C % 2 == 0) &&
                    reinterpret_cast<uintptr_t>(in) % (2 * sizeof(T)) == 0 &&
                    reinterpret_cast<uintptr_t>(out) % (2 * sizeof(T)) == 0;
  const size_t ld_in = BWD ? (size_t)3 * C : (size_t)C;

  for (int e = tid; e < nnz; e += nth) tab[e] = Nz{col[e], to_f(val[e])};
  for (int r = tid; r <= V; r += nth) rp[r] = ptr[r];
  if (BWD) {
    // each row's run of the cotangent, 3w elements from column 3 c0: g2 into
    // b0, g1 into b1 (g0 is read at the end)
    const int w3 = 3 * w;
    for (int i = tid; i < V * w3; i += nth) {
      const int r = i / w3, j = i - r * w3, c = j / 3, k = j - 3 * c;
      if (k == 0) continue;
      const T v = c0 + c < C ? in[r * ld_in + 3 * c0 + j] : from_f<T>(0.0f);
      (k == 2 ? b0 : b1)[r * w + c] = v;
    }
  } else {
    for (int i = tid; i < (V << lp); i += nth) {
      const int r = i >> lp, c = (i & (np - 1)) * 2, gc = c0 + c;
      const float2 v = load_cols(in + r * ld_in + gc, 1, pair, C - gc);
      store2(b0 + r * w + c, v.x, v.y);
    }
  }
  __syncthreads();

  const int pc = tid & (np - 1), rstep = nth >> lp;
  const int gc = c0 + 2 * pc, left = C - gc;
  // hop 1: L x into b1 (forward), or u = g1 + 2 R(L g2) (backward)
  for (int r = tid >> lp; r < V; r += rstep) {
    float a0 = 0.0f, a1 = 0.0f;
    const int e1 = rp[r + 1];
#pragma unroll 4
    for (int e = rp[r]; e < e1; ++e) {
      const Nz nz = tab[e];
      const float2 v = load2(b0 + nz.col * w + 2 * pc);
      a0 = fmaf(nz.val, v.x, a0);
      a1 = fmaf(nz.val, v.y, a1);
    }
    if (BWD) {  // b1 holds g1 here; this thread alone reads and writes it
      const float2 g1 = load2(b1 + r * w + 2 * pc);
      a0 = g1.x + 2.0f * rnd<T>(a0);
      a1 = g1.y + 2.0f * rnd<T>(a1);
    }
    store2(b1 + r * w + 2 * pc, a0, a1);
  }
  __syncthreads();

  if (left <= 0) return;
  // hop 2 and the output: the stack [x, z1, z2] (forward), or dx (backward)
  for (int r = tid >> lp; r < V; r += rstep) {
    float a0 = 0.0f, a1 = 0.0f;
    const int e1 = rp[r + 1];
#pragma unroll 4
    for (int e = rp[r]; e < e1; ++e) {
      const Nz nz = tab[e];
      const float2 v = load2(b1 + nz.col * w + 2 * pc);
      a0 = fmaf(nz.val, v.x, a0);
      a1 = fmaf(nz.val, v.y, a1);
    }
    const float2 x = load2(b0 + r * w + 2 * pc);  // x, or g2
    if (BWD) {
      const float2 g0 = load_cols(in + r * ld_in + 3 * gc, 3, false, left);
      // autograd's order of the plain version: R(R(g0 - g2) + R(L u))
      const float d0 = rnd<T>(g0.x - x.x) + rnd<T>(a0);
      const float d1 = rnd<T>(g0.y - x.y) + rnd<T>(a1);
      T* o = out + (size_t)r * C + gc;
      if (pair) {
        store2(o, d0, d1);
      } else {
        o[0] = from_f<T>(d0);
        if (left > 1) o[1] = from_f<T>(d1);
      }
    } else {
      const float2 z1 = load2(b1 + r * w + 2 * pc);
      const float z20 = 2.0f * rnd<T>(a0) - x.x, z21 = 2.0f * rnd<T>(a1) - x.y;
      T* o = out + (size_t)r * 3 * C + 3 * gc;
      if (pair) {
        store2(o, x.x, z1.x);
        store2(o + 2, z20, x.y);
        store2(o + 4, z1.y, z21);
      } else {
        o[0] = from_f<T>(x.x);
        o[1] = from_f<T>(z1.x);
        o[2] = from_f<T>(z20);
        if (left > 1) {
          o[3] = from_f<T>(x.y);
          o[4] = from_f<T>(z1.y);
          o[5] = from_f<T>(z21);
        }
      }
    }
  }
}

template <typename T, bool BWD>
cudaError_t launch_dense_cheby(const int* ptr, const int* col, const T* val, const T* in,
                               T* out, int V, int C, int nnz, int lw, int threads,
                               cudaStream_t stream) {
  if (lw < 1 || threads > kDenseMaxThreads || threads % 32 || threads % (1 << (lw - 1)) ||
      V <= 0 || C <= 0)
    return cudaErrorInvalidValue;
  const size_t smem = dense_table_bytes(V, nnz) + (size_t)2 * V * (1 << lw) * sizeof(T);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(dense_cheby_kernel<T, BWD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (C + (1 << lw) - 1) >> lw;
  dense_cheby_kernel<T, BWD><<<grid, threads, smem, stream>>>(ptr, col, val, in, out, V, C,
                                                                nnz, lw);
  return cudaGetLastError();
}

}  // namespace

// in: x (V, C) (forward) or the cotangent g (V, 3C) (bwd); out: the stack
// (V, 3C) or dx (V, C); ptr / col / val: L's rows; lw: log2 of the slice
// width w and threads a block, from ops/dense_cheby.py dense_plan; f32: the
// operands are float32, else bf16.  Returns a cudaError_t.
extern "C" int p2m_dense_cheby(const void* ptr, const void* col, const void* val,
                               const void* in, void* out, int V, int C, int nnz, int lw,
                               int threads, int bwd, int f32, void* stream) {
  auto run = [&](auto zero) {
    using T = decltype(zero);
    auto* p = static_cast<const int*>(ptr);
    auto* c = static_cast<const int*>(col);
    auto* v = static_cast<const T*>(val);
    auto* i = static_cast<const T*>(in);
    auto* o = static_cast<T*>(out);
    auto st = static_cast<cudaStream_t>(stream);
    return bwd ? launch_dense_cheby<T, true>(p, c, v, i, o, V, C, nnz, lw, threads, st)
               : launch_dense_cheby<T, false>(p, c, v, i, o, V, C, nnz, lw, threads, st);
  };
  return f32 ? run(0.0f) : run(bf16{});
}

extern "C" const char* p2m_dense_cheby_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
