// Wilson D-slash kernels for Hopper (sm_90a), bound to Python with ctypes
// (see repro_torch/kernels/dslash/kernel.py).
//
// Replaces the JAX package's Pallas kernels:
//   dslash_eo_kernel   <- src/repro/kernels/dslash/kernel.py:180
//                         dslash_eo_split (body _dslash_eo_kernel :118)
//   dslash_full_kernel <- src/repro/kernels/dslash/kernel.py:217
//                         dslash_split (body _dslash_kernel :80)
//
//   out(x) = sum_mu (1 - g_mu) U_mu(x) psi(x+mu) + (1 + g_mu) U_mu(x-mu)^+ psi(x-mu)
//
// Layouts (C-contiguous float32, complex as re/im pairs):
//   psi, out: (X, Y, Z, T, 4, 3, 2)     U: (4, X, Y, Z, T, 3, 3, 2)
// and on the compact checkerboard the same with X/2 in place of X.
//
// Bound.  Both are memory-bound.  Counting each input byte once and the
// output once, the even-odd hop moves 96 B of source spinor, 2 x 288 B of
// links (output- and source-parity halves) and 96 B of output per output
// half-site: 768 B.  At 32^3 x 8 that is 131072 half-sites, 100.7 MB, or
// 30 us at the H100's 3.35 TB/s, against 1320 flop/site = 173 MFLOP, 2.6 us
// at 67 TFLOP/s f32.  The full hop moves 96 + 288 + 96 = 480 B/site,
// 125.8 MB at 32^3 x 8: 37.6 us.
//
// Design.  One thread per output site, t fastest (the arrays' innermost
// site axis), so the threads of a warp read neighbouring sites.  A spinor
// (96 B) loads as six float4, a link (72 B) as nine float2, straight from
// device memory through the read-only path; the 24 output reals stay in
// registers and are written once as six float4.  Each hop projects the
// source spinor to a two-spinor first, so it multiplies two colour
// vectors instead of four (the 1320 flop/site count).  The neighbours'
// spinors and links are re-read by up to 8 threads; the L2 cache (50 MB)
// absorbs much of that re-read, which is what keeps the simple design near
// the byte bound.  Shared-memory staging, TMA and gauge compression are
// not used.
//
// Fused Schur operator.  dslash_eo_kernel<RND, G5, EPI> also carries the
// even-odd Schur operator's other passes, so that A = 1 - k^2 D_eo D_oe is
// two launches and the inner CG's normal operator A^+A four:
//   hop 1 (EPI false) reads its source spinors through a load transform:
//     gamma5 (G5) or each real rounded through the inner type (RND: 0 none,
//     1 bf16, 2 f16, round to nearest even and back to f32); it stores
//     d = D_oe psi' unrounded;
//   hop 2 (EPI true) reads d plainly and, at its output site, psi with the
//     same transform, and stores R(G(psi' - k2 d)): G gamma5 when G5, R the
//     rounding through RND.
// So A R(psi), rounded, is <RND, 0, *> and A^+ psi = g5 A g5 psi, rounded,
// is <RND, 1, *> (with G5 the source is not rounded: the inner CG's A^+
// takes A's rounded output).  In this basis gamma5 swaps the spin pairs
// (0,1) and (2,3): a change of register index at the load or the store,
// no arithmetic.  The epilogue repeats PyTorch's arithmetic bit for bit:
// k2 is float(kappa * kappa) and each real is __fsub_rn(psi, __fmul_rn(k2,
// d)), never contracted to an FMA (which rounds once, not twice).
// Bytes: an epilogue hop reads psi too, 864 B an output half-site against
// a plain hop's 768; a load transform moves nothing more.  The fusion
// removes, per normal operator at 32^3 x 64, the three rounding passes
// (f32 -> bf16 -> f32, 906 MB), the two Schur axpys (scale and subtract,
// 1006 MB) and the two gamma5 rolls (403 MB): 12 of 16 launches, ~2.3 GB,
// for the 2 x 100.7 MB of psi the epilogues read, ~2.1 GB net.  <0, 0, 0>
// is the plain hop.
//
// Gamma basis: Dirac basis, order x, y, z, t = g1, g2, g3, g0
// (src/repro/lqcd/dirac.py:24-33).  For mu in {x, y, z} the projection
// (1 - s g_mu) v, with s = +1 forward and -1 backward, is
//   h_k = v_k + c_k v_{b_k}  (k = 0, 1);  r_k = h_k;  r_{b_k} = conj(c_k) h_k
// with c_k = s * i^C_k and the table below; for t, (1 - g_t) = diag(0,0,2,2)
// and (1 + g_t) = diag(2,2,0,0).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// a real rounded through the inner type RND (0: kept), back to f32
template <int RND>
__device__ __forceinline__ float round_inner(float x) {
  if constexpr (RND == 1) return __bfloat162float(__float2bfloat16_rn(x));
  else if constexpr (RND == 2) return __half2float(__float2half_rn(x));
  else return x;
}

// a spinor's 24 reals as six float4, each real rounded through RND, the
// spin pairs swapped (gamma5) when G5
template <int RND, bool G5>
__device__ __forceinline__ void load_spinor(float2 (&v)[4][3],
                                            const float4* __restrict__ sp) {
  constexpr int g = G5 ? 2 : 0;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float4 q = __ldg(sp + k);
    v[((2 * k) / 3) ^ g][(2 * k) % 3] =
        make_float2(round_inner<RND>(q.x), round_inner<RND>(q.y));
    v[((2 * k + 1) / 3) ^ g][(2 * k + 1) % 3] =
        make_float2(round_inner<RND>(q.z), round_inner<RND>(q.w));
  }
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {  // a * b
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {  // conj(a) * b
  return make_float2(a.x * b.x + a.y * b.y, a.x * b.y - a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

// i^P * v for P in 0..3
template <int P>
__device__ __forceinline__ float2 ipow(float2 v) {
  if constexpr (P == 0) return v;
  else if constexpr (P == 1) return make_float2(-v.y, v.x);
  else if constexpr (P == 2) return make_float2(-v.x, -v.y);
  else return make_float2(v.y, -v.x);
}

// spin partner b_k and forward i-power C_k of the x, y, z projectors
template <int MU> struct Proj;
template <> struct Proj<0> { static constexpr int b0 = 3, b1 = 2, c0 = 1, c1 = 1; };
template <> struct Proj<1> { static constexpr int b0 = 3, b1 = 2, c0 = 0, c1 = 2; };
template <> struct Proj<2> { static constexpr int b0 = 2, b1 = 3, c0 = 1, c1 = 3; };

// acc += (1 -+ g_MU) L psi' with L = U (FWD) or U^+ (backward), psi' the
// source spinor through the load transform <RND, G5>
template <int MU, bool FWD, int RND, bool G5>
__device__ __forceinline__ void hop(float2 (&acc)[4][3],
                                    const float2* __restrict__ link,
                                    const float4* __restrict__ sp) {
  float2 v[4][3];
  load_spinor<RND, G5>(v, sp);
  float2 u[3][3];
#pragma unroll
  for (int j = 0; j < 9; ++j) u[j / 3][j % 3] = __ldg(link + j);

  // project to a two-spinor
  float2 h[2][3];
  constexpr int off = FWD ? 2 : 0;   // t: the spin pair the projector keeps
  if constexpr (MU == 3) {
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        h[k][c] = make_float2(2.f * v[k + off][c].x, 2.f * v[k + off][c].y);
  } else {
    constexpr int c0 = (Proj<MU>::c0 + (FWD ? 0 : 2)) % 4;
    constexpr int c1 = (Proj<MU>::c1 + (FWD ? 0 : 2)) % 4;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      h[0][c] = cadd(v[0][c], ipow<c0>(v[Proj<MU>::b0][c]));
      h[1][c] = cadd(v[1][c], ipow<c1>(v[Proj<MU>::b1][c]));
    }
  }

  // colour: H_a = sum_b U_ab h_b, or conj(U_ba) h_b for the backward hop
  float2 H[2][3];
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float2 s = make_float2(0.f, 0.f);
#pragma unroll
      for (int b = 0; b < 3; ++b)
        s = cadd(s, FWD ? cmul(u[a][b], h[k][b]) : cmulc(u[b][a], h[k][b]));
      H[k][a] = s;
    }

  // reconstruct the four spin components and accumulate
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if constexpr (MU == 3) {
      acc[off][a] = cadd(acc[off][a], H[0][a]);
      acc[off + 1][a] = cadd(acc[off + 1][a], H[1][a]);
    } else {
      constexpr int c0 = (Proj<MU>::c0 + (FWD ? 0 : 2)) % 4;
      constexpr int c1 = (Proj<MU>::c1 + (FWD ? 0 : 2)) % 4;
      acc[0][a] = cadd(acc[0][a], H[0][a]);
      acc[1][a] = cadd(acc[1][a], H[1][a]);
      acc[Proj<MU>::b0][a] = cadd(acc[Proj<MU>::b0][a], ipow<(4 - c0) % 4>(H[0][a]));
      acc[Proj<MU>::b1][a] = cadd(acc[Proj<MU>::b1][a], ipow<(4 - c1) % 4>(H[1][a]));
    }
  }
}

__device__ __forceinline__ void store(float4* __restrict__ o,
                                      float2 (&acc)[4][3]) {
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float2 p = acc[(2 * k) / 3][(2 * k) % 3];
    const float2 q = acc[(2 * k + 1) / 3][(2 * k + 1) % 3];
    o[k] = make_float4(p.x, p.y, q.x, q.y);
  }
}

// site offsets of the +1 / -1 neighbours along an axis of extent n, stride st
__device__ __forceinline__ int64_t up(int c, int n, int64_t st) {
  return c == n - 1 ? -(int64_t)(n - 1) * st : st;
}
__device__ __forceinline__ int64_t down(int c, int n, int64_t st) {
  return c == 0 ? (int64_t)(n - 1) * st : -st;
}

// y, z, t hops: the forward link at the output site in U_fwd, the backward
// link at the neighbour in U_bwd (the same array on the full lattice; the
// output- and source-parity halves on the checkerboard)
template <int MU, int RND = 0, bool G5 = false>
__device__ __forceinline__ void hop_pair(float2 (&acc)[4][3],
                                         const float2* __restrict__ U_fwd,
                                         const float2* __restrict__ U_bwd,
                                         const float4* __restrict__ psi,
                                         int64_t V, int64_t site,
                                         int64_t dup, int64_t ddown) {
  hop<MU, true, RND, G5>(acc, U_fwd + (MU * V + site) * 9,
                         psi + (site + dup) * 6);
  hop<MU, false, RND, G5>(acc, U_bwd + (MU * V + site + ddown) * 9,
                          psi + (site + ddown) * 6);
}

__global__ void __launch_bounds__(kThreads)
dslash_full_kernel(const float2* __restrict__ U,
                   const float4* __restrict__ psi, float4* __restrict__ out,
                   int X, int Y, int Z, int T) {
  const int64_t V = (int64_t)X * Y * Z * T;
  const int64_t site = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (site >= V) return;
  const int t = (int)(site % T);
  int64_t r = site / T;
  const int z = (int)(r % Z);
  r /= Z;
  const int y = (int)(r % Y);
  const int x = (int)(r / Y);
  const int64_t sZ = T, sY = (int64_t)Z * T, sX = (int64_t)Y * Z * T;

  float2 acc[4][3] = {};
  hop_pair<0>(acc, U, U, psi, V, site, up(x, X, sX), down(x, X, sX));
  hop_pair<1>(acc, U, U, psi, V, site, up(y, Y, sY), down(y, Y, sY));
  hop_pair<2>(acc, U, U, psi, V, site, up(z, Z, sZ), down(z, Z, sZ));
  hop_pair<3>(acc, U, U, psi, V, site, up(t, T, 1), down(t, T, 1));
  store(out + site * 6, acc);
}

// <RND, G5, EPI> as the header says; psi_epi and k2 are read only by an
// epilogue hop (EPI): psi at the output parity, and float(kappa^2)
template <int RND, bool G5, bool EPI>
__global__ void __launch_bounds__(kThreads)
dslash_eo_kernel(const float2* __restrict__ U_out,
                 const float2* __restrict__ U_src,
                 const float4* __restrict__ psi, float4* __restrict__ out,
                 int Xh, int Y, int Z, int T, int out_parity,
                 const float4* __restrict__ psi_epi, float k2) {
  // an epilogue hop reads its source (hop 1's d) plainly
  constexpr int SR = EPI || G5 ? 0 : RND;
  constexpr bool SG = !EPI && G5;
  const int64_t V = (int64_t)Xh * Y * Z * T;   // sites of one parity
  const int64_t site = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (site >= V) return;
  const int t = (int)(site % T);
  int64_t r = site / T;
  const int z = (int)(r % Z);
  r /= Z;
  const int y = (int)(r % Y);
  const int i = (int)(r / Y);
  const int64_t sZ = T, sY = (int64_t)Z * T, sX = (int64_t)Y * Z * T;

  // output site x = 2i + s: its +x neighbour sits at compact i + s, its -x
  // neighbour (and that neighbour's link, from the source half) at
  // compact i + s - 1, both mod X/2
  const int s = (y + z + t + out_parity) & 1;
  const int ip = i + s == Xh ? 0 : i + s;
  const int im = i + s - 1 < 0 ? Xh - 1 : i + s - 1;

  float2 acc[4][3] = {};
  hop_pair<0, SR, SG>(acc, U_out, U_src, psi, V, site,
                      (int64_t)(ip - i) * sX, (int64_t)(im - i) * sX);
  hop_pair<1, SR, SG>(acc, U_out, U_src, psi, V, site, up(y, Y, sY),
                      down(y, Y, sY));
  hop_pair<2, SR, SG>(acc, U_out, U_src, psi, V, site, up(z, Z, sZ),
                      down(z, Z, sZ));
  hop_pair<3, SR, SG>(acc, U_out, U_src, psi, V, site, up(t, T, 1),
                      down(t, T, 1));
  if constexpr (EPI) {
    // psi' - k2 d, then gamma5 (G5) and the rounding, real by real
    float2 p[4][3], o[4][3];
    load_spinor<G5 ? 0 : RND, G5>(p, psi_epi + site * 6);
    constexpr int g = G5 ? 2 : 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        o[j ^ g][c] = make_float2(
            round_inner<RND>(__fsub_rn(p[j][c].x, __fmul_rn(k2, acc[j][c].x))),
            round_inner<RND>(__fsub_rn(p[j][c].y, __fmul_rn(k2, acc[j][c].y))));
    store(out + site * 6, o);
  } else {
    store(out + site * 6, acc);
  }
}

unsigned int blocks_for(int64_t sites) {
  return (unsigned int)((sites + kThreads - 1) / kThreads);
}

// Makes ``device`` the calling thread's current device for its scope and
// puts the caller's back at its end, so that a launch on a shard's card
// leaves the caller where it was.
struct OnDevice {
  int caller = -1;
  cudaError_t err;
  explicit OnDevice(int device) {
    err = cudaGetDevice(&caller);
    if (err != cudaSuccess) caller = -1;
    else err = cudaSetDevice(device);
  }
  ~OnDevice() {
    if (caller >= 0) cudaSetDevice(caller);
  }
};

}  // namespace

extern "C" {

// Each launcher enqueues one kernel on ``stream`` of ``device`` and returns
// the launch's cudaError_t (0 on success); it does not synchronise, and the
// calling thread's current device is the same after it as before.

int dslash_full_launch(const void* U, const void* psi, void* out, int X,
                       int Y, int Z, int T, int device, void* stream) {
  OnDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  const int64_t V = (int64_t)X * Y * Z * T;
  if (V == 0) return 0;
  dslash_full_kernel<<<blocks_for(V), kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)U, (const float4*)psi, (float4*)out, X, Y, Z, T);
  return (int)cudaGetLastError();
}

// One hop of B1: the plain hop with rnd = g5 = epi = 0 (psi_epi, k2
// unread), else a hop of the fused Schur operator (header).  rnd in 0..2;
// a load-transform hop with g5 does not round, whatever rnd says.
int dslash_eo_launch(const void* U_out, const void* U_src, const void* psi,
                     void* out, int Xh, int Y, int Z, int T, int out_parity,
                     const void* psi_epi, float k2, int rnd, int g5, int epi,
                     int device, void* stream) {
  if (rnd < 0 || rnd > 2) return (int)cudaErrorInvalidValue;
  OnDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  const int64_t V = (int64_t)Xh * Y * Z * T;
  if (V == 0) return 0;
  decltype(&dslash_eo_kernel<0, false, false>) kernel;
  if (!epi) {
    kernel = g5 ? dslash_eo_kernel<0, true, false>
             : rnd == 1 ? dslash_eo_kernel<1, false, false>
             : rnd == 2 ? dslash_eo_kernel<2, false, false>
                        : dslash_eo_kernel<0, false, false>;
  } else if (g5) {
    kernel = rnd == 1 ? dslash_eo_kernel<1, true, true>
             : rnd == 2 ? dslash_eo_kernel<2, true, true>
                        : dslash_eo_kernel<0, true, true>;
  } else {
    kernel = rnd == 1 ? dslash_eo_kernel<1, false, true>
             : rnd == 2 ? dslash_eo_kernel<2, false, true>
                        : dslash_eo_kernel<0, false, true>;
  }
  kernel<<<blocks_for(V), kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)U_out, (const float2*)U_src, (const float4*)psi,
      (float4*)out, Xh, Y, Z, T, out_parity, (const float4*)psi_epi, k2);
  return (int)cudaGetLastError();
}

const char* dslash_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
