// Register-blocked GEMM for Hopper (sm_90a), bound to Python with ctypes
// (see repro_torch/kernels/dgemm/kernel.py).
//
// Replaces the JAX package's Pallas kernel
//   gemm_kernel <- src/repro/kernels/dgemm/kernel.py:30 matmul_pallas
//                  (body _matmul_kernel :20)
// which computes (M, K) @ (K, N) with a float32 accumulator and writes the
// result in the output dtype.  Two epilogues share one main loop:
//   product:  c  = round(x @ y)                (a fresh output)
//   update:   c  = round(c - x @ y)            (HPL's trailing update)
// The product x @ y is summed in float32 in full before the subtraction,
// as the JAX LU does (`a - l21 @ u12`, src/repro/hpl/lu.py:95-98); the
// update epilogue keeps the (M, N) product out of device memory.
//
// Operands are row-major with a leading dimension (row stride) each, so
// views of one n x n matrix go in without a copy; every offset is 64-bit
// (n = 32768 gives 2^30 elements, 4 GiB of float32).  Inputs are float32
// or bfloat16, the output float32 or bfloat16; the sums are IEEE float32
// FMAs on the CUDA cores, never TF32.
//
// Bound.  At HPL's step-0 update for n = 32768, nb = 256, (32512, 256) @
// (256, 32256) is 5.37e11 flop: 8.0 ms at 67 TFLOP/s f32, against 8.5 GB
// (c read and written once, x and y read once), 2.5 ms at 3.35 TB/s.  So
// it is bound by operations, and the design aims at FMA throughput.
//
// Design.  A 128 x 128 block tile, 256 threads, 8 x 8 outputs per thread
// held in registers (64 FMAs per shared-memory read of 8 + 8 values), and
// a k step of 8.  Each k step's tiles go through registers into one of two
// shared-memory buffers while the other is multiplied, so one barrier per
// k step suffices.  Global loads are scalar and coalesced (consecutive
// threads read consecutive elements), which needs no alignment and takes
// any leading dimension; rows, columns and k beyond the edge read as 0 and
// are not written, so no dimension need divide a tile.  The A tile is
// stored transposed (k-major, padded by 4 floats against bank conflicts)
// so each thread reads its 8 rows as two float4.  A thread owns rows
// {4ty..4ty+3, 64+4ty..64+4ty+3} and the same pattern of columns in tx, so
// its shared reads are float4 and a warp's are broadcasts.  The epilogue
// uses float4 when c is float32, 16-byte aligned and its leading dimension
// a multiple of 4 (HPL's views are), else scalars.  wgmma, TMA and a
// tensor-core bf16 path are not used.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 8;
constexpr int kThreads = 256;           // (kBM / 8) * (kBN / 8)
constexpr int kPad = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename TIn, typename TOut, bool kUpdate>
__global__ void __launch_bounds__(kThreads, 2)
gemm_kernel(const TIn* __restrict__ x, const TIn* __restrict__ y,
            TOut* __restrict__ c, int64_t m, int64_t n, int64_t k,
            int64_t ldx, int64_t ldy, int64_t ldc, bool vec_c) {
  __shared__ __align__(16) float As[2][kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[2][kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t m0 = (int64_t)blockIdx.y * kBM;
  const int64_t n0 = (int64_t)blockIdx.x * kBN;

  // loads: the A tile (kBM x kBK) as rows a_r + 32j, column a_k; the B tile
  // (kBK x kBN) as rows b_k + 2j, column b_c; j = 0..3.  xp and yp point at
  // this thread's j = 0 element of the next tiles to load; the row and
  // column tests are made once, the k test at each step.
  const int a_r = tid / kBK, a_k = tid % kBK;
  const int b_k = tid / kBN, b_c = tid % kBN;
  const TIn* xp = x + (m0 + a_r) * ldx + a_k;
  const TIn* yp = y + b_k * ldy + n0 + b_c;
  const int64_t x_j = 32 * ldx, y_j = 2 * ldy, y_step = kBK * ldy;
  unsigned rows_ok = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (m0 + a_r + 32 * j < m) rows_ok |= 1u << j;
  const bool col_ok = n0 + b_c < n;
  float ra[4], rb[4];

  auto load = [&](int64_t k0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ra[j] = ((rows_ok >> j) & 1u) && k0 + a_k < k ? to_f32(xp[j * x_j])
                                                     : 0.f;
      rb[j] = col_ok && k0 + b_k + 2 * j < k ? to_f32(yp[j * y_j]) : 0.f;
    }
    xp += kBK;
    yp += y_step;
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      As[buf][a_k][a_r + 32 * j] = ra[j];
      Bs[buf][b_k + 2 * j][b_c] = rb[j];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  int buf = 0;
  for (int64_t k0 = 0; k0 < k; k0 += kBK) {
    const bool more = k0 + kBK < k;
    if (more) load(k0 + kBK);           // in flight during the FMAs below
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][4 * ty]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][kk][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][4 * tx]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + 4 * tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other buffer was last read before the previous barrier
    if (more) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t row = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (row >= m) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t col = n0 + 64 * h + 4 * tx;
      TOut* p = c + row * ldc + col;
      const float* v = &acc[i][4 * h];
      if constexpr (std::is_same<TOut, float>::value) {
        if (vec_c && col + 3 < n) {
          float4 o = make_float4(v[0], v[1], v[2], v[3]);
          if (kUpdate) {
            const float4 old = *reinterpret_cast<const float4*>(p);
            o = make_float4(old.x - o.x, old.y - o.y, old.z - o.z,
                            old.w - o.w);
          }
          *reinterpret_cast<float4*>(p) = o;
          continue;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (col + j < n)
          p[j] = from_f32<TOut>(kUpdate ? to_f32(p[j]) - v[j] : v[j]);
      }
    }
  }
}

template <typename TIn, typename TOut, bool kUpdate>
cudaError_t launch(const void* x, const void* y, void* c, int64_t m,
                   int64_t n, int64_t k, int64_t ldx, int64_t ldy,
                   int64_t ldc, cudaStream_t stream) {
  const dim3 grid((unsigned)((n + kBN - 1) / kBN),
                  (unsigned)((m + kBM - 1) / kBM));
  if (grid.y > 65535u) return cudaErrorInvalidConfiguration;
  const bool vec_c = sizeof(TOut) == 4 && ldc % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(c) % 16 == 0;
  gemm_kernel<TIn, TOut, kUpdate><<<grid, kThreads, 0, stream>>>(
      static_cast<const TIn*>(x), static_cast<const TIn*>(y),
      static_cast<TOut*>(c), m, n, k, ldx, ldy, ldc, vec_c);
  return cudaGetLastError();
}

template <typename TIn, bool kUpdate>
cudaError_t launch_out(int out_dtype, const void* x, const void* y, void* c,
                       int64_t m, int64_t n, int64_t k, int64_t ldx,
                       int64_t ldy, int64_t ldc, cudaStream_t stream) {
  if (out_dtype == 0)
    return launch<TIn, float, kUpdate>(x, y, c, m, n, k, ldx, ldy, ldc,
                                       stream);
  return launch<TIn, __nv_bfloat16, kUpdate>(x, y, c, m, n, k, ldx, ldy, ldc,
                                             stream);
}

}  // namespace

extern "C" {

// Enqueues one kernel on ``stream`` of ``device`` and returns the launch's
// cudaError_t (0 on success); it does not synchronise.  Dtype codes: 0 is
// float32, 1 is bfloat16.  ``update`` != 0 selects c -= x @ y, else
// c = x @ y.  m and n must be positive.
int gemm_launch(const void* x, const void* y, void* c, int64_t m, int64_t n,
                int64_t k, int64_t ldx, int64_t ldy, int64_t ldc,
                int in_dtype, int out_dtype, int update, int device,
                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (m <= 0 || n <= 0 || k < 0 || in_dtype < 0 || in_dtype > 1 ||
      out_dtype < 0 || out_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (in_dtype == 0)
    err = update ? launch_out<float, true>(out_dtype, x, y, c, m, n, k, ldx,
                                           ldy, ldc, s)
                 : launch_out<float, false>(out_dtype, x, y, c, m, n, k, ldx,
                                            ldy, ldc, s);
  else
    err = update ? launch_out<__nv_bfloat16, true>(out_dtype, x, y, c, m, n,
                                                   k, ldx, ldy, ldc, s)
                 : launch_out<__nv_bfloat16, false>(out_dtype, x, y, c, m, n,
                                                    k, ldx, ldy, ldc, s);
  return (int)err;
}

const char* gemm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
