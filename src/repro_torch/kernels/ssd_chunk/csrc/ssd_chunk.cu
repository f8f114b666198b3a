// One Mamba-2 SSD chunk for Hopper (sm_90a), bound to Python with ctypes
// (see repro_torch/kernels/ssd_chunk/kernel.py).
//
// Replaces the JAX package's Pallas kernel
//   ssd_chunk_kernel <- src/repro/kernels/ssd_chunk/kernel.py:43
//                       ssd_chunk_pallas (body _ssd_kernel :18)
// which is the arithmetic of ssd_chunked's chunk_step
// (src/repro/models/ssm.py:115) for one group.  Per (batch b, head h),
// with a = A[h], cs = cumsum(dt * a) over the chunk's Q positions:
//   y[i, p]  = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x[j, p]
//            + exp(cs_i) sum_n C[i, n] h[p, n]
//   h'[p, n] = h[p, n] exp(cs_last)
//            + sum_j x[j, p] B[j, n] exp(cs_last - cs_j) dt_j
// x, B and C are float32 or bfloat16 (bfloat16 on the serve path); dt, A
// and h are float32; y and h' are float32.
//
// Bound.  The function needs, per batch row, the lower triangle of C B^T
// once (one group: the same for every head), Q (Q + 1) N flops, exact on
// bf16 tensor cores when B and C are bf16; and per (b, h) the lower
// triangle of the scores times x, Q (Q + 1) P flops, plus the two state
// terms, 4 Q P N, with f32 operands.  At the serve path's Q = 256, P = 64,
// N = 128 and 4 x 32 (b, h) that is 0.034 GFLOP at 989 TFLOP/s bf16 plus
// 1.61 GFLOP at 67 TFLOP/s f32, 24.1 us, against 21.6 MB moved (6.5 us at
// 3.35 TB/s).  With bf16 x, B and C this kernel runs the f32 products as
// three exact bf16 products each on the tensor cores (below), for which
// the least time is 3 x 1.61 GFLOP at 989 TFLOP/s, 4.9 us, floored by the
// bytes: 6.5 us.  It is bound in practice by the elementwise work around
// the products (scores, splits, staging) and by its barriers.
//
// Design.  The grid is 1-D over two roles, each block taking a group of
// kHG = 2 heads:
//   - output blocks: (b, 64-row tile of the chunk, 64-column chunk of P,
//     head group), the last row tiles (the most work) first.  A block
//     stages C's 64 rows once as C^T (n-major).  It adds the inter-chunk
//     term C h^T over n, scales each row by exp(cs_i), then walks 32-row
//     tiles j <= the tile's last row (the upper triangle is never visited,
//     so no exp of a positive difference), two tiles of x in flight.  Per
//     j tile it computes that tile of C B^T ONCE for both heads, skipping
//     16 x 16 blocks above the diagonal; then each head forms its scores
//     W = (C B^T) exp(cs_i - cs_j) dt_j (0 for j > i) and adds W x.  C B^T
//     of a batch row is thus computed ceil(H / kHG) * ceil(P / 64) times,
//     16 at the serve path's shape (H = 32, P = 64), against 32 (once per
//     head, over the full lower triangle) before.
//   - state blocks: (b, head group, 64-row chunk of P, 64-column chunk of
//     N) of h', walking all Q positions in 32-row tiles of x, scaled by
//     exp(cs_last - cs_j) dt_j, and of B, two tiles in flight.
// At the serve path's shape that is 256 output and 128 state blocks.  Each
// block computes the prefix sum cs once per head (each thread sums a
// segment of positions, then a Hillis-Steele scan of the segment sums).
// Tiles of x and B go to shared memory by 16-byte cp.async where x, B and
// C and their strides are 16-byte aligned (the model's slices of the conv
// output are), else element by element; strides are arguments, so x, dt,
// B and C may be views.
//
// Two arithmetic paths, by x's dtype:
//   - bfloat16 (the serve path): 256 threads, 4 warps per head, each warp
//     16 rows x 64 columns of its head's outputs as four nvcuda::wmma
//     16 x 16 x 16 accumulators.  C B^T runs on the bf16 tensor cores
//     (bf16 in, f32 sums: exact), one 16 x 16 block per warp.  Each f32
//     product has one exact bf16 operand (C, x or B) and one f32 operand
//     (h, W, or x exp(cs_last - cs_j) dt_j), which split3 cuts into three
//     bf16 parts whose sum is that f32 value exactly; the three products
//     are exact and the tensor cores sum them in f32.  About 90 KB of
//     shared memory per block, two blocks per SM.
//   - float32 (tests only): 128 threads, 2 warps per head, each thread an
//     8 x 8 tile of outputs as register-tiled IEEE f32 FMAs on the CUDA
//     cores, both operands k-major in shared memory: per k step four
//     float4 reads for 64 FMAs, conflict-free.  C B^T also on the CUDA
//     cores.
// On the serve path's chunk the tensor-core path took 86.8 us against
// 113 us for the same design on the CUDA cores (NVIDIA H100 80GB HBM3,
// 700 W; PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kHeadThreads = 64;    // one head's 64 x 64 tile, 8 x 8 each
constexpr int kHG = 2;              // heads per block
constexpr int kThreads = kHG * kHeadThreads;
constexpr int kTcHeadThreads = 128;  // bf16: 4 warps per head, 16 rows each
constexpr int kTcThreads = kHG * kTcHeadThreads;
constexpr int kTI = 64;             // rows of y per output block
constexpr int kTJ = 32;             // positions j per staged tile
constexpr int kTP = 64;             // columns p of y, rows p of h' per block
constexpr int kTN = 64;             // columns n of h' per state block
constexpr int kTK = 32;             // n per staged tile of h^T
constexpr int kMaxP = 128;
constexpr int kMaxN = 256;
constexpr int kStaticSmem = 48 * 1024;
constexpr int64_t kMaxSmem = 232448;  // 227 KB: one Hopper block's limit
constexpr int kXLd = kTP + 4;       // float rows of h^T
constexpr int kWLd = kTI;           // float rows of W and (C B^T)^T
constexpr int kWsLd = kTI + 8;      // bf16 rows of W's splits
constexpr int kHsLd = kTK + 8;      // bf16 rows of h's splits
static_assert(kTK == kTJ, "h^T tiles reuse W's buffer");
static_assert(kTN == kTP, "the state role's tiles share raw_ld");

// threads of a block for x of esize bytes (2: the tensor-core roles)
__host__ __device__ constexpr int threads_for(int esize) {
  return esize == 2 ? kTcThreads : kThreads;
}

__host__ __device__ inline int64_t align32(int64_t v) {
  return (v + 31) & ~int64_t(31);
}
__host__ __device__ inline int n_pad(int N) { return (N + 15) / 16 * 16; }
// element strides of C^T and of the B tile (wmma wants multiples of 8
// bf16; the pads spread the transposing writes over the banks)
__host__ __device__ inline int ct_ld(int esize) {
  return esize == 2 ? kTI + 8 : kTI + 4;
}
__host__ __device__ inline int bt_ld(int N, int esize) {
  return n_pad(N) + (esize == 2 ? 8 : 4);
}
// element stride of the x tiles and the state role's B tiles, kept in x's
// dtype (16-byte rows for the copies)
__host__ __device__ inline int raw_ld(int esize) { return kTP + 16 / esize; }

// byte offsets of a block's shared memory; esize is sizeof(x's dtype):
// 2 lays out the tensor-core roles, 4 the CUDA-core ones
struct Layout {
  int64_t cs, dts, part, sc;        // both roles
  int64_t ct, bt, w, xr;            // output role
  int64_t wj, bs, xs, xw;           // state role
  int64_t total;
};

__host__ __device__ inline Layout layout(int Q, int N, int esize) {
  const bool tc = esize == 2;
  Layout L;
  int64_t o = 0;
  L.cs = o;   o = align32(o + 4LL * kHG * Q);
  L.dts = o;  o = align32(o + 4LL * kHG * Q);
  L.part = o; o = align32(o + 4LL * threads_for(esize));
  L.sc = o;   o = align32(o + (tc ? 4LL * (kTcThreads / 32) * 256 : 0));
  const int64_t common = o;
  // W as float, or W's splits, or (before W) h's splits
  const int64_t w_tc = 2LL * kHG * 3 * (kTP * kHsLd > kTJ * kWsLd
                                            ? kTP * kHsLd : kTJ * kWsLd);
  L.ct = o;   o = align32(o + (int64_t)esize * n_pad(N) * ct_ld(esize));
  L.bt = o;   o = align32(o + (int64_t)esize * kTJ * bt_ld(N, esize));
  L.w = o;    o = align32(o + (tc ? w_tc : 4LL * kHG * kTJ * kXLd));
  L.xr = o;   o = align32(o + 2LL * esize * kHG * kTJ * raw_ld(esize));
  const int64_t out_end = o;
  o = common;
  L.wj = o;   o = align32(o + 4LL * kHG * Q);
  L.bs = o;   o = align32(o + 2LL * esize * kTJ * raw_ld(esize));
  L.xs = o;   o = align32(o + 2LL * esize * kHG * kTJ * raw_ld(esize));
  L.xw = o;   o = align32(o + (tc ? 2LL * kHG * 3 * kTJ * kWsLd : 0));
  L.total = out_end > o ? out_end : o;
  return L;
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}
// four consecutive floats, 16-byte aligned
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

// 16 bytes read as one vector and used as elements
template <typename T>
union Vec16 {
  uint4 u;
  T e[16 / sizeof(T)];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// copies src_bytes (0..16) from src and zero-fills the rest of 16 bytes
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* h;
  float* y;
  float* h_out;
  int batch, H, Q, P, N;
  int tiles_i, chunks_p, groups, chunks_n, n_out;
  bool vec_h;                       // h 16-byte aligned, N % 4 == 0
  int64_t x_sb, x_sq, x_sh;         // element strides; x's p stride is 1
  int64_t dt_sb, dt_sq, dt_sh;
  int64_t b_sb, b_sq, c_sb, c_sq;   // B's and C's n stride is 1
};

// acc[r][c] += a[r] b[c] for one k step; a and b are the thread's 8 + 8
// operands at {4t..4t+3, 32+4t..} of two k-major rows
__device__ __forceinline__ void outer8(float (&acc)[8][8], const float* a,
                                       const float* b) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
}

__device__ __forceinline__ int tile_off(int r, int t) {
  return r < 4 ? 4 * t + r : 32 + 4 * t + r - 4;
}

// acc += A^T B over k < n: A and B k-major (row k at a + k * lda and
// b + k * ldb), this thread's 8 + 8 operands at {4t..4t+3, 32+4t..}.  With
// ascale, A's row k is scaled by ascale[k] first.  Unrolled by 8 so that
// the shared loads of later k steps overlap the FMAs of earlier ones.
__device__ __forceinline__ void fma_rows(float (&acc)[8][8], const float* a,
                                         int lda, const float* b, int ldb,
                                         int n, int ty, int tx,
                                         const float* ascale = nullptr) {
#pragma unroll 8
  for (int k = 0; k < n; ++k) {
    float av[8], bv[8];
    load4(a + k * lda + 4 * ty, av);
    load4(a + k * lda + 32 + 4 * ty, av + 4);
    load4(b + k * ldb + 4 * tx, bv);
    load4(b + k * ldb + 32 + 4 * tx, bv + 4);
    if (ascale) {
      const float w = ascale[k];
#pragma unroll
      for (int r = 0; r < 8; ++r) av[r] *= w;
    }
    outer8(acc, av, bv);
  }
}

// cs = cumsum(dt * A[h]) and dt for each head of the group, positions 0..Q
template <int kHT>
__device__ void prefix_sums(const Args& a, int b, int g0, float* cs_all,
                            float* dts_all, float* part) {
  const int Q = a.Q, tid = threadIdx.x;
  const int g = tid / kHT, lt = tid % kHT;
  const int hh = g0 + g;
  const bool ok = hh < a.H;
  const float av = ok ? a.A[hh] : 0.f;
  const float* dtg = a.dt + b * a.dt_sb + (int64_t)(ok ? hh : 0) * a.dt_sh;
  float* cs = cs_all + g * Q;
  float* dts = dts_all + g * Q;
  const int per = (Q + kHT - 1) / kHT;
  const int q0 = min(lt * per, Q), q1 = min(q0 + per, Q);
  float run = 0.f;
  for (int q = q0; q < q1; ++q) {
    const float d = ok ? dtg[q * a.dt_sq] : 0.f;
    dts[q] = d;
    run += __fmul_rn(d, av);               // la = dt * a, rounded, then summed
    cs[q] = run;
  }
  part[tid] = run;
  __syncthreads();
  for (int off = 1; off < kHT; off <<= 1) {
    const float v = lt >= off ? part[tid - off] : 0.f;
    __syncthreads();
    part[tid] += v;
    __syncthreads();
  }
  if (lt > 0) {
    const float base = part[tid - 1];
    for (int q = q0; q < q1; ++q) cs[q] += base;
  }
  __syncthreads();
}

// f32 v = hi + mid + lo exactly (three 8-bit significands; lo may lose
// bits only where it falls below bf16's range)
__device__ __forceinline__ void split3(float v, __nv_bfloat16* out,
                                       int stride) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(v);
  const float r1 = v - __bfloat162float(hi);
  const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
  out[0] = hi;
  out[stride] = mid;
  out[2 * stride] = __float2bfloat16_rn(r1 - __bfloat162float(mid));
}

// float32 scores of positions j0.. (nj) against rows i0.. (ni) of the
// chunk for both heads of the group: W_g[jj][i] = (C_i . B_j)
// exp(cs_i - cs_j) dt_j, 0 for j > i and past ni or nj.  Each element of
// C B^T is summed once for both heads, on the CUDA cores, and never above
// the diagonal (scores_tc is the bfloat16 version).
__device__ void scores_tile(const float* Ct, const float* Bt, int Np,
                            int btld, float* W, const float* cs_all,
                            const float* dts_all, int Q, int i0, int ni,
                            int j0, int nj) {
  for (int idx = threadIdx.x; idx < kTI * kTJ; idx += kThreads) {
    const int i = idx % kTI, jj = idx / kTI;
    const int row = i0 + i, j = j0 + jj;
    const bool live = i < ni && jj < nj && j <= row;
    float t = 0.f;
    if (live)
      for (int n = 0; n < Np; ++n)
        t = fmaf(Ct[n * ct_ld(4) + i], Bt[jj * btld + n], t);
    for (int g = 0; g < kHG; ++g) {
      const float* cs = cs_all + g * Q;
      W[g * kTJ * kXLd + jj * kWLd + i] =
          live ? t * expf(cs[row] - cs[j]) * dts_all[g * Q + j] : 0.f;
    }
  }
}

// Stages kTJ rows of a row-major tile of T (row stride ld_src) into dst
// (row stride dst_ld): cols columns, of which the first nc of the first nj
// rows are read and the rest zeroed.  By 16-byte cp.async (kVec: src and
// ld_src 16-byte aligned, cols a multiple of 16 bytes) or element by
// element; lane among lanes: this thread among those sharing the tile.
template <typename T, bool kVec>
__device__ __forceinline__ void stage_rows(T* dst, int dst_ld, const T* src,
                                           int64_t ld_src, int nj, int nc,
                                           int cols, int lane, int lanes) {
  if constexpr (kVec) {
    constexpr int E = 16 / (int)sizeof(T);
    const int kQ = cols / E;
    for (int idx = lane; idx < kTJ * kQ; idx += lanes) {
      const int jj = idx / kQ, c = idx % kQ * E;
      const int left = nc - c;
      const int bytes = jj < nj && left > 0
                            ? (int)sizeof(T) * (left < E ? left : E) : 0;
      cp_async_16(smem_addr(dst + jj * dst_ld + c),
                  bytes ? src + jj * ld_src + c : src, bytes);
    }
  } else {
#pragma unroll 4
    for (int idx = lane; idx < kTJ * cols; idx += lanes) {
      const int jj = idx / cols, c = idx % cols;
      dst[jj * dst_ld + c] =
          jj < nj && c < nc ? src[jj * ld_src + c] : zero<T>();
    }
  }
}

// Output block: rows i0..i0+63 of y, columns p0..p0+63, heads g0, g0 + 1
// (float32 x, B and C, on the CUDA cores).
template <bool kVec>
__device__ void output_rows(const Args& a, const Layout& L, char* smem,
                            int b, int it, int pc, int g0) {
  using T = float;
  const int Q = a.Q, N = a.N, P = a.P, H = a.H;
  const int tid = threadIdx.x;
  const int g = tid / kHeadThreads, lt = tid % kHeadThreads;
  const int ty = lt / 8, tx = lt % 8;
  const int i0 = it * kTI, ni = min(kTI, Q - i0);
  const int p0 = pc * kTP, np = min(kTP, P - p0);
  const int hh = g0 + g;
  const bool head_ok = hh < H;
  const int Np = n_pad(N);
  constexpr int esize = (int)sizeof(T);
  const int ctld = ct_ld(esize), btld = bt_ld(N, esize);
  const int xld = raw_ld(esize);
  const float* cs = reinterpret_cast<float*>(smem + L.cs) + g * Q;
  const float* dts = reinterpret_cast<float*>(smem + L.dts) + g * Q;
  T* Ct = reinterpret_cast<T*>(smem + L.ct);
  T* Bt = reinterpret_cast<T*>(smem + L.bt);
  float* W_all = reinterpret_cast<float*>(smem + L.w);
  float* W = W_all + g * kTJ * kXLd;
  float* Ht = W;                           // h^T tiles, before W is used
  // x tiles: two buffers, each holding both heads
  T* Xr = reinterpret_cast<T*>(smem + L.xr) + g * kTJ * xld;
  const int xbuf = kHG * kTJ * xld;
  const T* cg = static_cast<const T*>(a.C) + b * a.c_sb + i0 * a.c_sq;
  const T* bg = static_cast<const T*>(a.B) + b * a.b_sb;
  const int hs = head_ok ? hh : 0;
  const T* xg = static_cast<const T*>(a.x) + b * a.x_sb + hs * a.x_sh + p0;
  const float* hg = a.h + (((int64_t)b * H + hs) * P + p0) * N;

  // C^T[n][i] = C[i0 + i][n], 0 past Q and N; consecutive lanes take
  // consecutive rows i, so the transposing writes hit consecutive words
  for (int idx = tid; idx < kTI * Np; idx += kThreads) {
    const int i = idx % kTI, n = idx / kTI;
    Ct[n * ctld + i] = i < ni && n < N ? cg[i * a.c_sq + n] : 0.f;
  }

  // the first tile of B and x for the intra-chunk term, in flight during
  // the inter-chunk term
  const int j_end = i0 + ni;
  auto stage_b = [&](int j0) {
    stage_rows<T, kVec>(Bt, btld, bg + j0 * a.b_sq, a.b_sq,
                        min(kTJ, j_end - j0), N, Np, tid, kThreads);
  };
  auto stage_x = [&](int j0, int buf) {
    stage_rows<T, kVec>(Xr + buf * xbuf, xld, xg + j0 * a.x_sq, a.x_sq,
                        head_ok ? min(kTJ, j_end - j0) : 0, np, kTP, lt,
                        kHeadThreads);
  };
  stage_b(0);
  stage_x(0, 0);
  if constexpr (kVec) cp_async_commit();

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  // inter-chunk: sum_n C[i, n] h[p, n], h^T staged 32 n at a time
  for (int k0 = 0; k0 < N; k0 += kTK) {
    __syncthreads();                       // Ht is free (and C^T written)
#pragma unroll 4
    for (int idx = lt; idx < kTK * kTP; idx += kHeadThreads) {
      const int p = idx % kTP, nn = idx / kTP;
      Ht[nn * kXLd + p] = head_ok && p < np && k0 + nn < N
                              ? hg[(int64_t)p * N + k0 + nn] : 0.f;
    }
    __syncthreads();
    fma_rows(acc, Ct + k0 * ctld, ctld, Ht, kXLd, min(kTK, N - k0), ty, tx);
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = tile_off(r, ty);
    const float e = i < ni ? expf(cs[i0 + i]) : 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] *= e;
  }

  // intra-chunk: tiles of positions j <= the tile's last row, two x
  // buffers: the next tile's copies fly during this tile's FMAs
  const int tiles = (j_end + kTJ - 1) / kTJ;
  for (int t = 0; t < tiles; ++t) {
    const int j0 = t * kTJ, nj = min(kTJ, j_end - j0);
    if constexpr (kVec) cp_async_wait<0>();
    // tile t has landed; every thread is done with tile t - 1's FMAs, so W
    // and the other x buffer are free
    __syncthreads();
    if (t + 1 < tiles) {
      stage_x(j0 + kTJ, (t + 1) % 2);
      if constexpr (kVec) cp_async_commit();
    }
    scores_tile(Ct, Bt, Np, btld, W_all, cs - g * Q, dts - g * Q, Q, i0,
                ni, j0, nj);
    __syncthreads();                       // W is written; B^T is free
    if (t + 1 < tiles) {
      stage_b(j0 + kTJ);
      if constexpr (kVec) cp_async_commit();
    }
    fma_rows(acc, W, kWLd, Xr + (t % 2) * xbuf, xld, nj, ty, tx);
  }

  if (!head_ok) return;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = tile_off(r, ty);
    if (i >= ni) continue;
    float* yr = a.y + (((int64_t)b * Q + i0 + i) * H + hh) * P + p0;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int p = tile_off(c, tx);
      if (p < np) yr[p] = acc[r][c];
    }
  }
}

// State block: rows p0..p0+63, columns n0..n0+63 of h' for heads g0, g0 + 1
// (float32 x, B and C, on the CUDA cores).
template <bool kVec>
__device__ void state_rows(const Args& a, const Layout& L, char* smem,
                           int b, int g0, int pc, int nc) {
  using T = float;
  const int Q = a.Q, N = a.N, P = a.P, H = a.H;
  const int tid = threadIdx.x;
  const int g = tid / kHeadThreads, lt = tid % kHeadThreads;
  const int ty = lt / 8, tx = lt % 8;
  const int p0 = pc * kTP, np = min(kTP, P - p0);
  const int n0 = nc * kTN, nn_ = min(kTN, N - n0);
  const int hh = g0 + g;
  const bool head_ok = hh < H;
  const int hs = head_ok ? hh : 0;
  const int xld = raw_ld((int)sizeof(T));
  const float* cs = reinterpret_cast<float*>(smem + L.cs) + g * Q;
  const float* dts = reinterpret_cast<float*>(smem + L.dts) + g * Q;
  float* wj = reinterpret_cast<float*>(smem + L.wj) + g * Q;
  // B and x tiles: two buffers each, the next tile in flight during this
  // tile's FMAs
  T* Bs = reinterpret_cast<T*>(smem + L.bs);
  T* Xs = reinterpret_cast<T*>(smem + L.xs) + g * kTJ * xld;
  const int bbuf = kTJ * xld, xbuf = kHG * kTJ * xld;
  const T* xg = static_cast<const T*>(a.x) + b * a.x_sb + hs * a.x_sh + p0;
  const T* bg = static_cast<const T*>(a.B) + b * a.b_sb + n0;
  const float cs_last = cs[Q - 1];
  // exp(cs_last - cs_j) dt_j
  for (int q = lt; q < Q; q += kHeadThreads)
    wj[q] = expf(cs_last - cs[q]) * dts[q];
  auto stage = [&](int j0, int buf) {
    const int nj = min(kTJ, Q - j0);
    stage_rows<T, kVec>(Bs + buf * bbuf, xld, bg + j0 * a.b_sq, a.b_sq, nj,
                        nn_, kTN, tid, kThreads);
    stage_rows<T, kVec>(Xs + buf * xbuf, xld, xg + j0 * a.x_sq, a.x_sq,
                        head_ok ? nj : 0, np, kTP, lt, kHeadThreads);
    if constexpr (kVec) cp_async_commit();
  };
  stage(0, 0);

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  const int tiles = (Q + kTJ - 1) / kTJ;
  for (int t = 0; t < tiles; ++t) {
    const int j0 = t * kTJ, nj = min(kTJ, Q - j0);
    if constexpr (kVec) cp_async_wait<0>();
    // tile t has landed (and wj is written); every thread is done with
    // tile t - 1, whose buffers the next copies refill
    __syncthreads();
    if (t + 1 < tiles) stage(j0 + kTJ, (t + 1) % 2);
    // x[j, p] exp(cs_last - cs_j) dt_j times B[j, n]
    fma_rows(acc, Xs + (t % 2) * xbuf, xld, Bs + (t % 2) * bbuf, xld, nj,
             ty, tx, wj + j0);
  }

  if (!head_ok) return;
  const float e = expf(cs_last);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int p = tile_off(r, ty);
    if (p >= np) continue;
    const int64_t off = (((int64_t)b * H + hh) * P + p0 + p) * N + n0;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int n = tile_off(c, tx);
      if (n < nn_) a.h_out[off + n] = a.h[off + n] * e + acc[r][c];
    }
  }
}

// ---- bfloat16 x, B and C: the three f32 products on the tensor cores ----
// Each product has one bf16 operand (C, x or B: exact) and one f32 operand
// (h, the scores W, or x exp(cs_last - cs_j) dt_j), which is split into
// three bf16 parts (split3) whose products with the bf16 operand are exact;
// the tensor cores sum the three in f32.  A block has kTcThreads = 256
// threads, 4 warps per head; warp w holds rows 16 (w % 4).. of head w / 4's
// 64 x 64 outputs as four 16 x 16 wmma accumulators.

using namespace nvcuda;
using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using FragAcol = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                                wmma::col_major>;
using FragBcol = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                                wmma::col_major>;
using FragBrow = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                                wmma::row_major>;

// acc[cb] += sum over the 3 splits of A_s(16 rows, k) B(k, cols 16 cb) for
// one 16-deep k step; A_s column-major at a + s * a_split, B shared
template <typename FragB>
__device__ __forceinline__ void mma_split(FragAcc (&acc)[4],
                                          const __nv_bfloat16* a, int lda,
                                          int a_split, const FragB (&fb)[4]) {
#pragma unroll
  for (int sp = 0; sp < 3; ++sp) {
    FragAcol fa;
    wmma::load_matrix_sync(fa, a + sp * a_split, lda);
#pragma unroll
    for (int cb = 0; cb < 4; ++cb)
      wmma::mma_sync(acc[cb], fa, fb[cb], acc[cb]);
  }
}

// Both heads' split scores for positions j0.. (nj) against rows i0.. (ni),
// as in scores_tile: warp w computes the 16 x 16 block (rows 16 (w / 2),
// columns 16 (w % 2)) of C B^T once, on the tensor cores, then each head's
// W there, written as Ws[g][s][jj][i].  A block wholly below the diagonal
// (every j < every i) takes exp(cs_i - cs_l) exp(cs_l - cs_j) with l its
// last position: 32 exps per head instead of 256; both differences are of
// a later position minus an earlier one, as in the reference.  Blocks
// wholly above the diagonal are zeros and never computed.
__device__ void scores_tc(const __nv_bfloat16* Ct, const __nv_bfloat16* Bt,
                          int Np, int btld, float* scratch,
                          __nv_bfloat16* Ws, const float* cs_all,
                          const float* dts_all, int Q, int i0, int ni,
                          int j0, int nj) {
  static_assert(kTI == 64 && kTJ == 32 && kTcThreads == 256,
                "one 16 x 16 block of the 64 x 32 tile per warp");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sc = scratch + warp * 256;          // (C B^T)[r][c] at sc[c*16+r]
  const int r = lane % 16;
  const int ri = 16 * (warp / 2), cj = 16 * (warp % 2);
  const bool above = j0 + cj > i0 + ri + 15;
  const bool below = j0 + cj + 15 < i0 + ri && ri + 16 <= ni && cj + 16 <= nj;
  if (!above) {
    FragAcc fc;
    FragAcol fa;
    FragBcol fb;
    wmma::fill_fragment(fc, 0.f);
    for (int n0 = 0; n0 < Np; n0 += 16) {
      // A(i, n) = Ct[n][i]; B(n, j) = Bt[j][n]: both column-major
      wmma::load_matrix_sync(fa, Ct + n0 * ct_ld(2) + ri, ct_ld(2));
      wmma::load_matrix_sync(fb, Bt + cj * btld + n0, btld);
      wmma::mma_sync(fc, fa, fb, fc);
    }
    wmma::store_matrix_sync(sc, fc, 16, wmma::mem_col_major);
    __syncwarp();
  }
#pragma unroll
  for (int g = 0; g < kHG; ++g) {
    const float* cs = cs_all + g * Q;
    const float* dts = dts_all + g * Q;
    __nv_bfloat16* out = Ws + g * 3 * kTJ * kWsLd + cj * kWsLd + ri + r;
    float w[8];
    if (below) {
      const int l = j0 + cj + 15;
      const float ev = lane < 16
          ? expf(cs[i0 + ri + lane] - cs[l])
          : expf(cs[l] - cs[j0 + cj + lane - 16]) * dts[j0 + cj + lane - 16];
      const float ei = __shfl_sync(0xffffffffu, ev, r);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int c = lane / 16 + 2 * k;
        w[k] = sc[c * 16 + r] * ei * __shfl_sync(0xffffffffu, ev, 16 + c);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int c = lane / 16 + 2 * k;
        const int row = i0 + ri + r, j = j0 + cj + c;
        w[k] = !above && ri + r < ni && cj + c < nj && j <= row
                   ? sc[c * 16 + r] * expf(cs[row] - cs[j]) * dts[j] : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k)
      split3(w[k], out + (lane / 16 + 2 * k) * kWsLd, kTJ * kWsLd);
  }
}

// Output block on the tensor cores (see output_rows for the roles).
template <bool kVec>
__device__ void output_rows_tc(const Args& a, const Layout& L, char* smem,
                               int b, int it, int pc, int g0) {
  using T = __nv_bfloat16;
  const int Q = a.Q, N = a.N, P = a.P, H = a.H;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = tid / kTcHeadThreads, lt = tid % kTcHeadThreads;
  const int r0 = 16 * (warp % 4);          // this warp's rows
  const int i0 = it * kTI, ni = min(kTI, Q - i0);
  const int p0 = pc * kTP, np = min(kTP, P - p0);
  const int hh = g0 + g;
  const bool head_ok = hh < H;
  const int Np = n_pad(N);
  const int ctld = ct_ld(2), btld = bt_ld(N, 2), xld = raw_ld(2);
  const float* cs = reinterpret_cast<float*>(smem + L.cs) + g * Q;
  T* Ct = reinterpret_cast<T*>(smem + L.ct);
  T* Bt = reinterpret_cast<T*>(smem + L.bt);
  float* scratch = reinterpret_cast<float*>(smem + L.sc);
  float* sc = scratch + warp * 256;
  T* Hs = reinterpret_cast<T*>(smem + L.w) + g * 3 * kTP * kHsLd;
  T* Ws_all = reinterpret_cast<T*>(smem + L.w);
  T* Ws = Ws_all + g * 3 * kTJ * kWsLd;
  T* Xr = reinterpret_cast<T*>(smem + L.xr) + g * kTJ * xld;
  const int xbuf = kHG * kTJ * xld;
  const T* cg = static_cast<const T*>(a.C) + b * a.c_sb + i0 * a.c_sq;
  const T* bg = static_cast<const T*>(a.B) + b * a.b_sb;
  const int hs = head_ok ? hh : 0;
  const T* xg = static_cast<const T*>(a.x) + b * a.x_sb + hs * a.x_sh + p0;
  const float* hg = a.h + (((int64_t)b * H + hs) * P + p0) * N;

  // C^T[n][i] = C[i0 + i][n] (16-byte reads, lanes on consecutive rows)
  constexpr int E = 8;
  const int nq = Np / E;
  for (int idx = tid; idx < kTI * nq; idx += kTcThreads) {
    const int i = idx % kTI, n = idx / kTI * E;
    Vec16<T> v;
    if (kVec && i < ni && n + E <= N) {
      v.u = *reinterpret_cast<const uint4*>(cg + i * a.c_sq + n);
    } else {
#pragma unroll
      for (int k = 0; k < E; ++k)
        v.e[k] = i < ni && n + k < N ? cg[i * a.c_sq + n + k] : zero<T>();
    }
#pragma unroll
    for (int k = 0; k < E; ++k) Ct[(n + k) * ctld + i] = v.e[k];
  }
  const int j_end = i0 + ni;
  auto stage_b = [&](int j0) {
    stage_rows<T, kVec>(Bt, btld, bg + j0 * a.b_sq, a.b_sq,
                        min(kTJ, j_end - j0), N, Np, tid, kTcThreads);
  };
  auto stage_x = [&](int j0, int buf) {
    stage_rows<T, kVec>(Xr + buf * xbuf, xld, xg + j0 * a.x_sq, a.x_sq,
                        head_ok ? min(kTJ, j_end - j0) : 0, np, kTP, lt,
                        kTcHeadThreads);
  };
  stage_b(0);
  stage_x(0, 0);
  cp_async_commit();

  FragAcc acc[4];
#pragma unroll
  for (int cb = 0; cb < 4; ++cb) wmma::fill_fragment(acc[cb], 0.f);

  // inter-chunk: sum_n C[i, n] h[p, n]; h's rows split into Hs[s][p][n],
  // each thread 16 n of one row p
  const int hp = lt % kTP, hn = 16 * (lt / kTP);
  for (int k0 = 0; k0 < Np; k0 += kTK) {
    float v[16];
    const bool ok = head_ok && hp < np;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = k0 + hn + 4 * q;
      if (ok && a.vec_h && n + 3 < N) {
        const float4 t = *reinterpret_cast<const float4*>(
            hg + (int64_t)hp * N + n);
        v[4 * q] = t.x; v[4 * q + 1] = t.y; v[4 * q + 2] = t.z;
        v[4 * q + 3] = t.w;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[4 * q + k] = ok && n + k < N ? hg[(int64_t)hp * N + n + k] : 0.f;
      }
    }
    __syncthreads();                       // Hs is free (and C^T written)
#pragma unroll
    for (int k = 0; k < 16; ++k)
      split3(v[k], Hs + hp * kHsLd + hn + k, kTP * kHsLd);
    __syncthreads();
    for (int kk = 0; kk < kTK && k0 + kk < Np; kk += 16) {
      // A(i, n) = Ct[n][i]; B(n, p) = Hs[s][p][n]: both column-major
      FragAcol fa;
      wmma::load_matrix_sync(fa, Ct + (k0 + kk) * ctld + r0, ctld);
#pragma unroll
      for (int sp = 0; sp < 3; ++sp)
#pragma unroll
        for (int cb = 0; cb < 4; ++cb) {
          FragBcol fb;
          wmma::load_matrix_sync(fb, Hs + sp * kTP * kHsLd +
                                         16 * cb * kHsLd + kk, kHsLd);
          wmma::mma_sync(acc[cb], fa, fb, acc[cb]);
        }
    }
  }
  // scale row i by exp(cs_i), through the warp's scratch
  {
    const float ev = lane < 16 && r0 + lane < ni
                         ? expf(cs[i0 + r0 + lane]) : 0.f;
#pragma unroll
    for (int cb = 0; cb < 4; ++cb) {
      wmma::store_matrix_sync(sc, acc[cb], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int e = lane + 32 * k;
        sc[e] *= __shfl_sync(0xffffffffu, ev, e / 16);
      }
      __syncwarp();
      wmma::load_matrix_sync(acc[cb], sc, 16, wmma::mem_row_major);
      __syncwarp();
    }
  }

  // intra-chunk, as in output_rows, with W split for the tensor cores
  const int tiles = (j_end + kTJ - 1) / kTJ;
  for (int t = 0; t < tiles; ++t) {
    const int j0 = t * kTJ, nj = min(kTJ, j_end - j0);
    cp_async_wait<0>();
    __syncthreads();                       // tile t landed; Ws, x free
    if (t + 1 < tiles) {
      stage_x(j0 + kTJ, (t + 1) % 2);
      cp_async_commit();
    }
    scores_tc(Ct, Bt, Np, btld, scratch, Ws_all, cs - g * Q,
              reinterpret_cast<float*>(smem + L.dts), Q, i0, ni, j0, nj);
    __syncthreads();                       // Ws written; B^T is free
    if (t + 1 < tiles) {
      stage_b(j0 + kTJ);
      cp_async_commit();
    }
    const T* X = Xr + (t % 2) * xbuf;
#pragma unroll
    for (int kk = 0; kk < kTJ; kk += 16) {
      // A(i, j) = Ws[s][j][i]: column-major; B(j, p) = X[j][p]: row-major
      FragBrow fb[4];
#pragma unroll
      for (int cb = 0; cb < 4; ++cb)
        wmma::load_matrix_sync(fb[cb], X + kk * xld + 16 * cb, xld);
      mma_split(acc, Ws + kk * kWsLd + r0, kWsLd, kTJ * kWsLd, fb);
    }
  }

  // y, through the warp's scratch
  if (!head_ok) return;
#pragma unroll
  for (int cb = 0; cb < 4; ++cb) {
    wmma::store_matrix_sync(sc, acc[cb], 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int e = lane + 32 * k;
      const int i = r0 + e / 16, p = 16 * cb + e % 16;
      if (i < ni && p < np)
        a.y[(((int64_t)b * Q + i0 + i) * H + hh) * P + p0 + p] = sc[e];
    }
    __syncwarp();
  }
}

// State block on the tensor cores (see state_rows for the roles).
template <bool kVec>
__device__ void state_rows_tc(const Args& a, const Layout& L, char* smem,
                              int b, int g0, int pc, int nc) {
  using T = __nv_bfloat16;
  const int Q = a.Q, N = a.N, P = a.P, H = a.H;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = tid / kTcHeadThreads, lt = tid % kTcHeadThreads;
  const int r0 = 16 * (warp % 4);          // this warp's rows p
  const int p0 = pc * kTP, np = min(kTP, P - p0);
  const int n0 = nc * kTN, nn_ = min(kTN, N - n0);
  const int hh = g0 + g;
  const bool head_ok = hh < H;
  const int hs = head_ok ? hh : 0;
  const int xld = raw_ld(2);
  const float* cs = reinterpret_cast<float*>(smem + L.cs) + g * Q;
  const float* dts = reinterpret_cast<float*>(smem + L.dts) + g * Q;
  float* wj = reinterpret_cast<float*>(smem + L.wj) + g * Q;
  float* sc = reinterpret_cast<float*>(smem + L.sc) + warp * 256;
  T* Bs = reinterpret_cast<T*>(smem + L.bs);
  T* Xs = reinterpret_cast<T*>(smem + L.xs) + g * kTJ * xld;
  T* Xw = reinterpret_cast<T*>(smem + L.xw) + g * 3 * kTJ * kWsLd;
  const int bbuf = kTJ * xld, xbuf = kHG * kTJ * xld;
  const T* xg = static_cast<const T*>(a.x) + b * a.x_sb + hs * a.x_sh + p0;
  const T* bg = static_cast<const T*>(a.B) + b * a.b_sb + n0;
  const float cs_last = cs[Q - 1];
  for (int q = lt; q < Q; q += kTcHeadThreads)
    wj[q] = expf(cs_last - cs[q]) * dts[q];
  auto stage = [&](int j0, int buf) {
    const int nj = min(kTJ, Q - j0);
    stage_rows<T, kVec>(Bs + buf * bbuf, xld, bg + j0 * a.b_sq, a.b_sq, nj,
                        nn_, kTN, tid, kTcThreads);
    stage_rows<T, kVec>(Xs + buf * xbuf, xld, xg + j0 * a.x_sq, a.x_sq,
                        head_ok ? nj : 0, np, kTP, lt, kTcHeadThreads);
    cp_async_commit();
  };
  stage(0, 0);

  FragAcc acc[4];
#pragma unroll
  for (int cb = 0; cb < 4; ++cb) wmma::fill_fragment(acc[cb], 0.f);

  // each thread splits 16 consecutive p of one position j
  const int sj = lt / (kTP / 16), sp0 = 16 * (lt % (kTP / 16));
  const int tiles = (Q + kTJ - 1) / kTJ;
  for (int t = 0; t < tiles; ++t) {
    const int j0 = t * kTJ;
    cp_async_wait<0>();
    __syncthreads();                       // tile t landed; Xw is free
    if (t + 1 < tiles) stage(j0 + kTJ, (t + 1) % 2);
    // Xw[s][j][p]: the splits of x[j, p] exp(cs_last - cs_j) dt_j
    {
      const T* X = Xs + (t % 2) * xbuf + sj * xld + sp0;
      Vec16<T> v[2];
      v[0].u = *reinterpret_cast<const uint4*>(X);
      v[1].u = *reinterpret_cast<const uint4*>(X + 8);
      const float w = j0 + sj < Q ? wj[j0 + sj] : 0.f;
#pragma unroll
      for (int k = 0; k < 16; ++k)
        split3(__bfloat162float(v[k / 8].e[k % 8]) * w,
               Xw + sj * kWsLd + sp0 + k, kTJ * kWsLd);
    }
    __syncthreads();
    const T* Bv = Bs + (t % 2) * bbuf;
#pragma unroll
    for (int kk = 0; kk < kTJ; kk += 16) {
      // A(p, j) = Xw[s][j][p]: column-major; B(j, n) = Bv[j][n]: row-major
      FragBrow fb[4];
#pragma unroll
      for (int cb = 0; cb < 4; ++cb)
        wmma::load_matrix_sync(fb[cb], Bv + kk * xld + 16 * cb, xld);
      mma_split(acc, Xw + kk * kWsLd + r0, kWsLd, kTJ * kWsLd, fb);
    }
  }

  if (!head_ok) return;
  const float e = expf(cs_last);
#pragma unroll
  for (int cb = 0; cb < 4; ++cb) {
    wmma::store_matrix_sync(sc, acc[cb], 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int q = lane + 32 * k;
      const int p = r0 + q / 16, n = 16 * cb + q % 16;
      if (p < np && n < nn_) {
        const int64_t off =
            (((int64_t)b * H + hh) * P + p0 + p) * N + n0 + n;
        a.h_out[off] = a.h[off] * e + sc[q];
      }
    }
    __syncwarp();
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(threads_for(sizeof(T)),
                                  sizeof(T) == 2 ? 2 : 3)
ssd_chunk_kernel(Args a) {
  extern __shared__ __align__(128) char smem[];
  const Layout L = layout(a.Q, a.N, (int)sizeof(T));
  int bid = blockIdx.x;
  int b, g0, pc, it = 0, nc = 0;
  const bool out = bid < a.n_out;
  if (out) {
    const int per_tile = a.batch * a.chunks_p * a.groups;
    it = a.tiles_i - 1 - bid / per_tile;   // the most work first
    bid %= per_tile;
    b = bid / (a.chunks_p * a.groups);
    bid %= a.chunks_p * a.groups;
    pc = bid / a.groups;
    g0 = bid % a.groups * kHG;
  } else {
    bid -= a.n_out;
    b = bid / (a.groups * a.chunks_p * a.chunks_n);
    bid %= a.groups * a.chunks_p * a.chunks_n;
    g0 = bid / (a.chunks_p * a.chunks_n) * kHG;
    bid %= a.chunks_p * a.chunks_n;
    pc = bid / a.chunks_n;
    nc = bid % a.chunks_n;
  }
  prefix_sums<threads_for(sizeof(T)) / kHG>(
      a, b, g0, reinterpret_cast<float*>(smem + L.cs),
              reinterpret_cast<float*>(smem + L.dts),
              reinterpret_cast<float*>(smem + L.part));
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (out)
      output_rows_tc<kVec>(a, L, smem, b, it, pc, g0);
    else
      state_rows_tc<kVec>(a, L, smem, b, g0, pc, nc);
  } else {
    if (out)
      output_rows<kVec>(a, L, smem, b, it, pc, g0);
    else
      state_rows<kVec>(a, L, smem, b, g0, pc, nc);
  }
}

template <typename T, bool kVec>
cudaError_t launch_kernel(const Args& a, cudaStream_t stream) {
  const int64_t bytes = layout(a.Q, a.N, (int)sizeof(T)).total;
  if (bytes > kStaticSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel<T, kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const int64_t blocks =
      a.n_out + (int64_t)a.batch * a.groups * a.chunks_p * a.chunks_n;
  ssd_chunk_kernel<T, kVec><<<(unsigned)blocks, threads_for(sizeof(T)),
                              (size_t)bytes,
                              stream>>>(a);
  return cudaGetLastError();
}

// the 16-byte copies need x, B and C and all their strides 16-byte aligned
template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int64_t E = 16 / sizeof(T);
  const bool vec =
      reinterpret_cast<uintptr_t>(a.x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(a.B) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(a.C) % 16 == 0 && a.x_sb % E == 0 &&
      a.x_sq % E == 0 && a.x_sh % E == 0 && a.b_sb % E == 0 &&
      a.b_sq % E == 0 && a.c_sb % E == 0 && a.c_sq % E == 0;
  return vec ? launch_kernel<T, true>(a, stream)
             : launch_kernel<T, false>(a, stream);
}

}  // namespace


extern "C" {

// Bytes of dynamic shared memory one block takes at (Q, P, N) with x, B
// and C of ``dtype`` (0 float32, 1 bfloat16), or -1 where
// ssd_chunk_launch refuses the shape (P > 128, N > 256, or over 227 KB).
int64_t ssd_chunk_smem_bytes(int Q, int P, int N, int dtype) {
  if (Q <= 0 || P <= 0 || N <= 0 || P > kMaxP || N > kMaxN || dtype < 0 ||
      dtype > 1)
    return -1;
  const int64_t bytes = layout(Q, N, dtype == 0 ? 4 : 2).total;
  return bytes > kMaxSmem ? -1 : bytes;
}

// Enqueues one kernel on ``stream`` of ``device`` and returns the launch's
// cudaError_t (0 on success); it does not synchronise.  x is (B, Q, H, P)
// with element strides (x_sb, x_sq, x_sh) and unit p stride; dt (B, Q, H)
// with strides (dt_sb, dt_sq, dt_sh); B and C (B, Q, N) with strides
// (b_sb, b_sq) and (c_sb, c_sq) and unit n stride; A (H,), h (B, H, P, N),
// y (B, Q, H, P) and h_out (B, H, P, N) contiguous.  dtype 0 is float32
// x, B and C, 1 bfloat16.  P <= 128 and N <= 256.
int ssd_chunk_launch(const void* x, const float* dt, const float* A,
                     const void* B, const void* C, const float* h, float* y,
                     float* h_out, int batch, int Q, int H, int P, int N,
                     int64_t x_sb, int64_t x_sq, int64_t x_sh, int64_t dt_sb,
                     int64_t dt_sq, int64_t dt_sh, int64_t b_sb,
                     int64_t b_sq, int64_t c_sb, int64_t c_sq, int dtype,
                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch <= 0 || H <= 0 || ssd_chunk_smem_bytes(Q, P, N, dtype) < 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x; a.dt = dt; a.A = A; a.B = B; a.C = C; a.h = h;
  a.y = y; a.h_out = h_out;
  a.batch = batch; a.H = H; a.Q = Q; a.P = P; a.N = N;
  a.tiles_i = (Q + kTI - 1) / kTI;
  a.chunks_p = (P + kTP - 1) / kTP;
  a.groups = (H + kHG - 1) / kHG;
  a.chunks_n = (N + kTN - 1) / kTN;
  const int64_t n_out =
      (int64_t)batch * a.tiles_i * a.chunks_p * a.groups;
  const int64_t n_state = (int64_t)batch * a.groups * a.chunks_p * a.chunks_n;
  if (n_out + n_state > 0x7fffffff) return (int)cudaErrorInvalidValue;
  a.n_out = (int)n_out;
  a.vec_h = reinterpret_cast<uintptr_t>(h) % 16 == 0 && N % 4 == 0;
  a.x_sb = x_sb; a.x_sq = x_sq; a.x_sh = x_sh;
  a.dt_sb = dt_sb; a.dt_sq = dt_sq; a.dt_sh = dt_sh;
  a.b_sb = b_sb; a.b_sq = b_sq; a.c_sb = c_sb; a.c_sq = c_sq;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch<float>(a, s);
  return (int)launch<__nv_bfloat16>(a, s);
}

const char* ssd_chunk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
