// K=3 Chebyshev graph conv over the strip form of a Laplacian (deploy form).
//
//   basis:     z1 = S x,  z2 = 2 S z1 - x,  y = act([x, z1, z2] @ W + b) (+ skip)
//   commuted:  u = x W2,  t = 2 S u + x W1,  y = act(S t + x (W0 - W2) + b) (+ skip)
//              with W = [W0 - W2; W1; W2]
//
// Replaces the TPU kernel `fused_conv_flat_strip` (pose2mesh_release_tpu/ops/
// pallas_strip.py, kernel bodies `_strip_kernel_factory` and
// `_strip_basis_kernel_factory`).
//
// Layout: strip (Vp, Wd): row r holds L[r, off[r / h] + j] for j < Wd, with h
// the strip tile height (a multiple of 16), Wd a multiple of 16 and the offsets
// off (Vp / h,) int32 multiples of 16 from the pack-time table; x (Vp, B, F);
// W (3F, Fo_pad) zero-padded to Fo_pad (a multiple of 16); bias (Fo_pad,);
// skip (Vp, B, Fs) and skip_w (Fs, Fo_pad); out (Vp, B, Fout); all bf16.
//
// Design: the TPU kernel keeps a whole level in VMEM and runs its phases one
// after the other; 227 KB of shared memory cannot hold a level, so here each
// phase is a launch and the intermediates go through device memory in bf16,
// rounded where the TPU kernel rounds them.  Two kernels:
//   strip_hop_kernel: out = bf16(act(alpha * S src + beta * add) (+ skip)).
//     One block per (128 rows, CC columns of one batch element); each warp
//     owns 16 rows, which lie in one strip tile, and multiplies the tile's
//     (16, Wd) strip rows with src rows [o, o + Wd) on bf16 tensor cores
//     (WMMA, float32 accumulation), fragments loaded straight from L2.
//   proj_kernel: out = bf16(act(sum_s A_s W_s + b) (+ skip)) over the
//     Vp*B rows, the K=3F (or K=F) projection as a row-major product.
// basis: hop, hop, proj (3 launches).  commuted: proj u, proj x W1, proj
// x (W0 - W2) + b, hop t (in place), hop y (5 launches); u, t and the bias
// partial are Fo_pad wide, so every hop column chunk is whole.
//
// Bound on the H100: counted at the strip's nonzeros the conv moves far more
// bytes than it does operations per byte, so device memory bounds it (x read
// once, y written once).  This first version round-trips its intermediates
// through device memory, multiplies the dense (h, Wd) strip tiles (the
// nonzeros are ~2-4% of them) and loads fragments without staging, so it sits
// far from that bound.
#include "common.cuh"

using namespace p2m;

namespace {

// Column chunk of a hop or projection launch: the largest of 64, 32, 16
// dividing n.
inline int chunk_of(int n) { return n % 64 == 0 ? 64 : n % 32 == 0 ? 32 : 16; }

struct HopArgs {
  const bf16* strip;
  const int* off;
  int h, Wd, Vp;
  const bf16* src;  // (Vp, B, Fp)
  int B, Fp;
  float alpha;
  const bf16* add;  // (Vp, B, Fp) or null
  float beta;
  int relu, skip_mode;
  const bf16* skip;    // (Vp, B, Fo) for mode 1, (Vp, B, Fs) for mode 2
  const bf16* skip_w;  // (Fs, Fp)
  int Fs;
  bf16* out;  // (Vp, B, Fo), Fo <= Fp: columns >= Fo are not stored
  int Fo;
};

template <int NJ>
__global__ void __launch_bounds__(kThreads) strip_hop_kernel(HopArgs a) {
  constexpr int CC = NJ * 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* st = reinterpret_cast<float*>(smem) + warp * 16 * CC;
  float* sst = reinterpret_cast<float*>(smem) + (kWarps + warp) * 16 * CC;
  const long C = (long)a.B * a.Fp;
  const int c0 = blockIdx.y * CC, bi = c0 / a.Fp, f0 = c0 % a.Fp;
  const long R = (long)blockIdx.x * kT + warp * 16;  // the warp's first row
  const long o = a.off[R / a.h];
  FragC acc[NJ];
  zero(acc);
  rows_mma(acc, a.strip + R * a.Wd, a.Wd, a.src + o * C + c0, C, a.Wd);
  stage(st, acc);
  if (a.skip_mode == 2) {
    FragC sacc[NJ];
    zero(sacc);
    rows_mma(sacc, a.skip + (R * a.B + bi) * a.Fs, (long)a.B * a.Fs, a.skip_w + f0, a.Fp,
             a.Fs);
    stage(sst, sacc);
  }
  for (int e = lane; e < 16 * CC; e += 32) {
    const long r = R + e / CC;
    const int f = f0 + e % CC;
    float v = a.alpha * st[e];
    if (a.add) v += a.beta * to_f(a.add[(r * a.B + bi) * a.Fp + f]);
    if (a.relu) v = fmaxf(v, 0.0f);
    if (f >= a.Fo) continue;
    const long o_idx = (r * a.B + bi) * a.Fo + f;
    if (a.skip_mode == 1) v += to_f(a.skip[o_idx]);
    else if (a.skip_mode == 2) v += sst[e];
    a.out[o_idx] = to_bf(v);
  }
}

struct ProjArgs {
  const bf16* A[3];  // nA row-major (M, K) operands
  int nA, K;
  long M;
  const bf16* W;  // nA (K, ldw) blocks, one after the other
  int ldw;
  const bf16* bias;  // (ldw,) or null
  int relu, skip_mode;
  const bf16* skip;    // (M, ldo) for mode 1, (M, Fs) for mode 2
  const bf16* skip_w;  // (Fs, ldw)
  int Fs;
  bf16* out;  // (M, ldo); columns >= ldo are not stored
  int ldo;
};

template <int NJ>
__global__ void __launch_bounds__(kThreads) proj_kernel(ProjArgs a) {
  constexpr int CC = NJ * 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* st = reinterpret_cast<float*>(smem) + warp * 16 * CC;
  float* sst = reinterpret_cast<float*>(smem) + (kWarps + warp) * 16 * CC;
  const int c0 = blockIdx.y * CC;
  const long R = (long)blockIdx.x * kT + warp * 16;
  FragC acc[NJ];
  zero(acc);
  for (int s = 0; s < a.nA; ++s)
    rows_mma(acc, a.A[s] + R * a.K, a.K, a.W + (long)s * a.K * a.ldw + c0, a.ldw, a.K);
  stage(st, acc);
  if (a.skip_mode == 2) {
    FragC sacc[NJ];
    zero(sacc);
    rows_mma(sacc, a.skip + R * a.Fs, a.Fs, a.skip_w + c0, a.ldw, a.Fs);
    stage(sst, sacc);
  }
  for (int e = lane; e < 16 * CC; e += 32) {
    const long r = R + e / CC;
    const int c = c0 + e % CC;
    if (c >= a.ldo) continue;
    float v = st[e];
    if (a.bias) v += to_f(a.bias[c]);
    if (a.relu) v = fmaxf(v, 0.0f);
    if (a.skip_mode == 1) v += to_f(a.skip[r * a.ldo + c]);
    else if (a.skip_mode == 2) v += sst[e];
    a.out[r * a.ldo + c] = to_bf(v);
  }
}

// Launch one of the kernels on (rows / 128, cols / cc) blocks; per warp
// 16 x cc float32 staging for the product and for the skip projection.
template <typename Args>
cudaError_t launch(void (*kern)(Args), int cc, long rows, long cols, const Args& a,
                   cudaStream_t s) {
  const size_t smem = (size_t)2 * kWarps * 16 * cc * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((unsigned)(rows / kT), (unsigned)(cols / cc)), kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

cudaError_t hop(const HopArgs& a, cudaStream_t s) {
  const int cc = chunk_of(a.Fp);
  void (*kern)(HopArgs) = cc == 64   ? &strip_hop_kernel<4>
                          : cc == 32 ? &strip_hop_kernel<2>
                                     : &strip_hop_kernel<1>;
  return launch(kern, cc, a.Vp, (long)a.B * a.Fp, a, s);
}

cudaError_t proj(const ProjArgs& a, cudaStream_t s) {
  const int cc = chunk_of(a.ldw);
  void (*kern)(ProjArgs) = cc == 64   ? &proj_kernel<4>
                           : cc == 32 ? &proj_kernel<2>
                                      : &proj_kernel<1>;
  return launch(kern, cc, a.M, a.ldw, a, s);
}

}  // namespace

// commuted: 0 basis order, 1 commuted order (W = [W0 - W2; W1; W2]).
// skip_mode: 0 none, 1 add (Fs == Fout), 2 projection through skip_w.
// s1, s2: (Vp, B, F) bf16 scratch for basis; s1, s2, s3: (Vp, B, Fo_pad)
// for commuted.  Returns a cudaError_t.
extern "C" int p2m_strip_cheby_conv(const void* strip, const void* off, const void* x,
                                    const void* W, const void* bias, const void* skip,
                                    const void* skip_w, void* out, void* s1, void* s2,
                                    void* s3, int Vp, int h, int Wd, int B, int F, int Fout,
                                    int Fo_pad, int Fs, int commuted, int relu,
                                    int skip_mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Vp % kT || h % 16 || Wd % 16 || F % 16 || Fo_pad % 16 || (skip_mode == 2 && Fs % 16))
    return cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* Wb = static_cast<const bf16*>(W);
  bf16 *b1 = static_cast<bf16*>(s1), *b2 = static_cast<bf16*>(s2), *b3 = static_cast<bf16*>(s3);
  HopArgs h0{static_cast<const bf16*>(strip), static_cast<const int*>(off), h, Wd, Vp,
             nullptr, B, 0, 1.0f, nullptr, 0.0f, 0, 0, nullptr, nullptr, 0, nullptr, 0};
  ProjArgs p0{{xb, nullptr, nullptr}, 1, F, (long)Vp * B, Wb, Fo_pad, nullptr, 0, 0,
              nullptr, nullptr, 0, nullptr, Fo_pad};
  const bf16* sk = static_cast<const bf16*>(skip);
  const bf16* skw = static_cast<const bf16*>(skip_w);
  cudaError_t err;
  if (!commuted) {
    HopArgs z1 = h0;  // z1 = S x
    z1.src = xb, z1.Fp = F, z1.out = b1, z1.Fo = F;
    if ((err = hop(z1, s)) != cudaSuccess) return err;
    HopArgs z2 = z1;  // z2 = 2 S z1 - x
    z2.src = b1, z2.alpha = 2.0f, z2.add = xb, z2.beta = -1.0f, z2.out = b2;
    if ((err = hop(z2, s)) != cudaSuccess) return err;
    ProjArgs y = p0;  // y = act([x, z1, z2] W + b) (+ skip)
    y.A[1] = b1, y.A[2] = b2, y.nA = 3, y.bias = static_cast<const bf16*>(bias);
    y.relu = relu, y.skip_mode = skip_mode, y.skip = sk, y.skip_w = skw, y.Fs = Fs;
    y.out = static_cast<bf16*>(out), y.ldo = Fout;
    return proj(y, s);
  }
  ProjArgs u = p0;  // u = x W2
  u.W = Wb + 2L * F * Fo_pad, u.out = b1;
  if ((err = proj(u, s)) != cudaSuccess) return err;
  ProjArgs t0 = p0;  // x W1
  t0.W = Wb + (long)F * Fo_pad, t0.out = b2;
  if ((err = proj(t0, s)) != cudaSuccess) return err;
  ProjArgs pb = p0;  // x (W0 - W2) + b
  pb.bias = static_cast<const bf16*>(bias), pb.out = b3;
  if ((err = proj(pb, s)) != cudaSuccess) return err;
  HopArgs t = h0;  // t = 2 S u + x W1, written over x W1
  t.src = b1, t.Fp = Fo_pad, t.alpha = 2.0f, t.add = b2, t.beta = 1.0f, t.out = b2;
  t.Fo = Fo_pad;
  if ((err = hop(t, s)) != cudaSuccess) return err;
  HopArgs y = h0;  // y = act(S t + x (W0 - W2) + b) (+ skip)
  y.src = b2, y.Fp = Fo_pad, y.add = b3, y.beta = 1.0f, y.relu = relu;
  y.skip_mode = skip_mode, y.skip = sk, y.skip_w = skw, y.Fs = Fs;
  y.out = static_cast<bf16*>(out), y.Fo = Fout;
  return hop(y, s);
}

extern "C" const char* p2m_strip_cheby_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
