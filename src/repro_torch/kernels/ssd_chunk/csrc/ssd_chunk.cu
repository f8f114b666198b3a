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
// and h are float32; y and h' are float32.  All math is float32.
//
// Bound.  The function needs, per batch row, the lower triangle of C B^T
// once (one group: the same for every head), Q (Q + 1) N flops, exact on
// bf16 tensor cores when B and C are bf16; and per (b, h) the lower
// triangle of the scores times x, Q (Q + 1) P flops, plus the two state
// terms, 4 Q P N, in f32.  At the serve path's Q = 256, P = 64, N = 128
// and 4 x 32 (b, h) that is 0.034 GFLOP at 989 TFLOP/s bf16 plus
// 1.61 GFLOP at 67 TFLOP/s f32, 24.1 us, against 21.6 MB moved (6.5 us at
// 3.35 TB/s): bound by operations.  This kernel does more than that: it
// recomputes C B^T per head, and on the CUDA cores in f32.
//
// Design.  The TPU kernel holds one (b, h)'s whole working set (x, B, C
// and the (Q, Q) scores: over 500 KB in f32 at the path's shape) in VMEM;
// a Hopper block has 227 KB of shared memory, so the work is split.  The
// grid is (B * H, Q / 32 + P / 16) and has two roles:
//   - an output block owns 32 rows i of y for all P columns.  It stages
//     C's 32 rows once, then walks 32-row tiles j of B, x (only j <= the
//     tile's last row: the upper triangle is never visited, so no
//     exp(-1e30) and no overflow).  Per tile it forms the 32 x 32 scores
//     (C B^T) exp(cs_i - cs_j) dt_j with j > i set to 0, then adds
//     scores @ x into 8 registers per thread (8 x 8 threads' columns).
//     Last it adds exp(cs_i) C h^T, staging h in 32-row tiles.
//   - a state block owns 16 rows p of h' for all N columns and walks all
//     Q positions in 32-row tiles, staging B scaled by
//     exp(cs_last - cs_j) dt_j and x's 16 columns.
// Each block first recomputes the Q-long prefix sum cs in shared memory
// (each thread sums a segment, then a Hillis-Steele scan of the 256
// segment sums): cheap next to the products.  Shared rows of C, B and h are
// padded by one float against bank conflicts.  The sums run on the CUDA
// cores in IEEE float32; C B^T is recomputed for every head although, with
// one group, it is the same for all heads of a batch row.  Strides are
// arguments, so x, dt, B and C may be views (the model passes slices of
// the conv output without a copy).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTI = 32;             // rows of y per output block
constexpr int kTJ = 32;             // positions j per staged tile
constexpr int kTP = 16;             // rows of h' per state block
constexpr int kMaxP = 128;          // 8 columns per thread in the y role
constexpr int kMaxN = 256;          // 16 columns per thread in the h' role
constexpr int kStaticSmem = 48 * 1024;
constexpr int64_t kMaxSmem = 232448;  // 227 KB: one Hopper block's limit

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
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
  int H, Q, P, N, row_tiles;
  int64_t x_sb, x_sq, x_sh;         // element strides; x's p stride is 1
  int64_t dt_sb, dt_sq, dt_sh;
  int64_t b_sb, b_sq, c_sb, c_sq;   // B's and C's n stride is 1
};

// floats of dynamic shared memory a block needs (the larger role)
inline int64_t smem_floats(int Q, int P, int N) {
  const int64_t out_role = (int64_t)kTI * (N + 1) + (int64_t)kTJ * (N + 1) +
                           (int64_t)kTJ * P + kTI * (kTJ + 1);
  const int64_t state_role = (int64_t)kTJ * N + kTJ * kTP;
  return 2 * (int64_t)Q + kThreads +
         (out_role > state_role ? out_role : state_role);
}

// Output block: 32 rows of y (intra-chunk plus inter-chunk terms).
template <typename T>
__device__ void output_rows(const Args& a, int b, int hh, const float* cs,
                            const float* dts, float* rest) {
  const int N = a.N, P = a.P, Q = a.Q;
  const int tid = threadIdx.x;
  const int i0 = blockIdx.y * kTI;
  const int ni = Q - i0 < kTI ? Q - i0 : kTI;
  float* Cs = rest;                        // kTI x (N + 1)
  float* Bs = Cs + kTI * (N + 1);          // kTJ x (N + 1); later h rows
  float* Xs = Bs + kTJ * (N + 1);          // kTJ x P
  float* Ws = Xs + kTJ * P;                // kTI x (kTJ + 1)
  const T* xg = static_cast<const T*>(a.x) + b * a.x_sb + hh * a.x_sh;
  const T* bgl = static_cast<const T*>(a.B) + b * a.b_sb;
  const T* cgl = static_cast<const T*>(a.C) + b * a.c_sb;

  for (int idx = tid; idx < kTI * N; idx += kThreads) {
    const int r = idx / N, n = idx - r * N;
    Cs[r * (N + 1) + n] = r < ni ? to_f32(cgl[(i0 + r) * a.c_sq + n]) : 0.f;
  }
  const int r = tid >> 3;                  // this thread's row of the tile
  const int cg = tid & 7;                  // its column group
  const int i = i0 + r;
  float acc[kMaxP / 8];
#pragma unroll
  for (int k = 0; k < kMaxP / 8; ++k) acc[k] = 0.f;

  for (int j0 = 0; j0 < i0 + ni; j0 += kTJ) {
    const int nj = Q - j0 < kTJ ? Q - j0 : kTJ;
    __syncthreads();                       // the last tile's reads are done
    for (int idx = tid; idx < kTJ * N; idx += kThreads) {
      const int jj = idx / N, n = idx - jj * N;
      Bs[jj * (N + 1) + n] =
          jj < nj ? to_f32(bgl[(j0 + jj) * a.b_sq + n]) : 0.f;
    }
    for (int idx = tid; idx < kTJ * P; idx += kThreads) {
      const int jj = idx / P, p = idx - jj * P;
      Xs[idx] = jj < nj ? to_f32(xg[(j0 + jj) * a.x_sq + p]) : 0.f;
    }
    __syncthreads();
    // scores for (r, jj = cg + 8k), k < 4: (C_i . B_j) exp(cs_i - cs_j) dt_j
    float s[kTJ / 8];
#pragma unroll
    for (int k = 0; k < kTJ / 8; ++k) s[k] = 0.f;
    for (int n = 0; n < N; ++n) {
      const float c = Cs[r * (N + 1) + n];
#pragma unroll
      for (int k = 0; k < kTJ / 8; ++k)
        s[k] += c * Bs[(cg + 8 * k) * (N + 1) + n];
    }
#pragma unroll
    for (int k = 0; k < kTJ / 8; ++k) {
      const int jj = cg + 8 * k, j = j0 + jj;
      float wv = 0.f;
      if (r < ni && jj < nj && j <= i)
        wv = s[k] * expf(cs[i] - cs[j]) * dts[j];
      Ws[r * (kTJ + 1) + jj] = wv;
    }
    __syncthreads();
    for (int jj = 0; jj < nj; ++jj) {
      const float wv = Ws[r * (kTJ + 1) + jj];
#pragma unroll
      for (int k = 0; k < kMaxP / 8; ++k) {
        const int p = cg + 8 * k;
        if (p < P) acc[k] += wv * Xs[jj * P + p];
      }
    }
  }

  // inter-chunk: exp(cs_i) sum_n C[i, n] h[p, n], h staged 32 rows at a time
  const float* hg = a.h + ((int64_t)b * a.H + hh) * P * N;
  float inter[kMaxP / 8];
#pragma unroll
  for (int k = 0; k < kMaxP / 8; ++k) inter[k] = 0.f;
  for (int p0 = 0; p0 < P; p0 += kTJ) {
    __syncthreads();
    for (int idx = tid; idx < kTJ * N; idx += kThreads) {
      const int pp = idx / N, n = idx - pp * N;
      Bs[pp * (N + 1) + n] = p0 + pp < P ? hg[(p0 + pp) * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMaxP / 8; ++k) {
      const int p = cg + 8 * k;
      if (p >= p0 && p < p0 + kTJ && p < P) {
        float t = 0.f;
        for (int n = 0; n < N; ++n)
          t += Cs[r * (N + 1) + n] * Bs[(p - p0) * (N + 1) + n];
        inter[k] = t;
      }
    }
  }
  if (r < ni) {
    const float e = expf(cs[i]);
    float* yg = a.y + (((int64_t)b * Q + i) * a.H + hh) * P;
#pragma unroll
    for (int k = 0; k < kMaxP / 8; ++k) {
      const int p = cg + 8 * k;
      if (p < P) yg[p] = acc[k] + e * inter[k];
    }
  }
}

// State block: 16 rows p of h'.
template <typename T>
__device__ void state_rows(const Args& a, int b, int hh, const float* cs,
                           const float* dts, float* rest) {
  const int N = a.N, P = a.P, Q = a.Q;
  const int tid = threadIdx.x;
  const int p0 = (blockIdx.y - a.row_tiles) * kTP;
  float* Bs = rest;                        // kTJ x N, scaled
  float* Xs = Bs + kTJ * N;                // kTJ x kTP
  const T* xg = static_cast<const T*>(a.x) + b * a.x_sb + hh * a.x_sh;
  const T* bgl = static_cast<const T*>(a.B) + b * a.b_sb;
  const float cs_last = cs[Q - 1];
  const int pp = tid >> 4;                 // this thread's row p0 + pp
  const int ng = tid & 15;                 // its columns ng + 16k
  float acc[kMaxN / 16];
#pragma unroll
  for (int k = 0; k < kMaxN / 16; ++k) acc[k] = 0.f;

  for (int j0 = 0; j0 < Q; j0 += kTJ) {
    const int nj = Q - j0 < kTJ ? Q - j0 : kTJ;
    __syncthreads();
    for (int idx = tid; idx < kTJ * N; idx += kThreads) {
      const int jj = idx / N, n = idx - jj * N;
      float v = 0.f;
      if (jj < nj) {
        const int j = j0 + jj;
        v = to_f32(bgl[j * a.b_sq + n]) * (expf(cs_last - cs[j]) * dts[j]);
      }
      Bs[idx] = v;
    }
    for (int idx = tid; idx < kTJ * kTP; idx += kThreads) {
      const int jj = idx / kTP, q = idx - jj * kTP;
      Xs[idx] = jj < nj && p0 + q < P
                    ? to_f32(xg[(j0 + jj) * a.x_sq + p0 + q])
                    : 0.f;
    }
    __syncthreads();
    for (int jj = 0; jj < nj; ++jj) {
      const float xv = Xs[jj * kTP + pp];
#pragma unroll
      for (int k = 0; k < kMaxN / 16; ++k) {
        const int n = ng + 16 * k;
        if (n < N) acc[k] += xv * Bs[jj * N + n];
      }
    }
  }
  const int p = p0 + pp;
  if (p < P) {
    const float e = expf(cs_last);
    const int64_t off = (((int64_t)b * a.H + hh) * P + p) * N;
#pragma unroll
    for (int k = 0; k < kMaxN / 16; ++k) {
      const int n = ng + 16 * k;
      if (n < N) a.h_out[off + n] = a.h[off + n] * e + acc[k];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_chunk_kernel(Args a) {
  extern __shared__ float smem[];
  const int Q = a.Q;
  const int tid = threadIdx.x;
  const int b = blockIdx.x / a.H, hh = blockIdx.x - b * a.H;
  float* cs = smem;                        // Q: cumsum(dt * a)
  float* dts = cs + Q;                     // Q: dt
  float* part = dts + Q;                   // kThreads: segment sums
  float* rest = part + kThreads;

  // cs: each thread sums its segment of positions, then the segment sums
  // are scanned (Hillis-Steele) and added back as offsets
  const float av = a.A[hh];
  const float* dtg = a.dt + b * a.dt_sb + hh * a.dt_sh;
  const int per = (Q + kThreads - 1) / kThreads;
  const int q0 = tid * per;
  const int q1 = q0 + per < Q ? q0 + per : Q;
  float run = 0.f;
  for (int q = q0; q < q1; ++q) {
    const float d = dtg[q * a.dt_sq];
    dts[q] = d;
    run += __fmul_rn(d, av);               // la = dt * a, rounded, then summed
    cs[q] = run;
  }
  part[tid] = run;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {
    const float v = tid >= off ? part[tid - off] : 0.f;
    __syncthreads();
    part[tid] += v;
    __syncthreads();
  }
  if (tid > 0) {
    const float base = part[tid - 1];
    for (int q = q0; q < q1; ++q) cs[q] += base;
  }
  __syncthreads();

  if ((int)blockIdx.y < a.row_tiles)
    output_rows<T>(a, b, hh, cs, dts, rest);
  else
    state_rows<T>(a, b, hh, cs, dts, rest);
}

template <typename T>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  const int64_t bytes = smem_floats(a.Q, a.P, a.N) * (int64_t)sizeof(float);
  if (bytes > kStaticSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)(batch * a.H),
                  (unsigned)(a.row_tiles + (a.P + kTP - 1) / kTP));
  ssd_chunk_kernel<T><<<grid, kThreads, (size_t)bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block takes at (Q, P, N), or -1 where
// ssd_chunk_launch refuses the shape (P > 128, N > 256, or over 227 KB).
int64_t ssd_chunk_smem_bytes(int Q, int P, int N) {
  if (Q <= 0 || P <= 0 || N <= 0 || P > kMaxP || N > kMaxN) return -1;
  const int64_t bytes = smem_floats(Q, P, N) * (int64_t)sizeof(float);
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
  if (batch <= 0 || H <= 0 || ssd_chunk_smem_bytes(Q, P, N) < 0 ||
      (int64_t)batch * H > 0x7fffffff || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x; a.dt = dt; a.A = A; a.B = B; a.C = C; a.h = h;
  a.y = y; a.h_out = h_out;
  a.H = H; a.Q = Q; a.P = P; a.N = N;
  a.row_tiles = (Q + kTI - 1) / kTI;
  a.x_sb = x_sb; a.x_sq = x_sq; a.x_sh = x_sh;
  a.dt_sb = dt_sb; a.dt_sq = dt_sq; a.dt_sh = dt_sh;
  a.b_sb = b_sb; a.b_sq = b_sq; a.c_sb = c_sb; a.c_sq = c_sq;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch<float>(a, batch, s);
  return (int)launch<__nv_bfloat16>(a, batch, s);
}

const char* ssd_chunk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
