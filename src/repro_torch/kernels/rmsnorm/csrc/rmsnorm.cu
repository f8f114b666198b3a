// Row-wise RMSNorm for Hopper (sm_90a), bound to Python with ctypes (see
// repro_torch/kernels/rmsnorm/kernel.py).
//
// Replaces the JAX package's Pallas kernel
//   rmsnorm_kernel <- src/repro/kernels/rmsnorm/kernel.py:23 rmsnorm_pallas
//                     (body _rmsnorm_kernel :16)
// which computes, per row, out = x * rsqrt(mean(x^2) + eps) * w with
// float32 math and writes out in x's dtype.  x and w are float32 or
// bfloat16, independently: the serve path runs d = 1024 in bfloat16 (the
// layer norms) and d = 2048 in float32 with a bfloat16 scale (the gated
// norm).
//
// Bound.  Four flops per element against 2 x sizeof(x) bytes moved (x read,
// out written): far below the card's 20 flop/byte f32 balance, so it is
// bound by bytes, and the design aims at one pass of coalesced loads.
//
// Design.  One block of 256 threads per row (a grid-stride loop over rows
// when there are more than the grid holds).  The threads sum x^2 over the
// row in float32, reduce through shared memory, and make a second pass
// that writes x * r * w; the second pass re-reads the row from L1/L2, not
// from device memory.  Rows are 16-byte vector loads and stores when the
// row start, its stride and d allow it, else scalar; any row count and any
// d work, with no divisibility condition.  The sum is taken in another
// order than the plain version's, so results agree to float32 rounding.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxGrid = 1 << 20;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                   TX* __restrict__ out, int64_t rows, int d, int64_t ldx,
                   float eps, bool vec) {
  constexpr int kVec = 16 / sizeof(TX);  // elements per 16-byte access
  __shared__ float red[kThreads];
  const int tid = threadIdx.x;
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const TX* xr = x + row * ldx;
    TX* orow = out + row * d;
    float ss = 0.f;
    if (vec) {
      for (int c = tid * kVec; c < d; c += kThreads * kVec) {
        const uint4 u = *reinterpret_cast<const uint4*>(xr + c);
        const TX* e = reinterpret_cast<const TX*>(&u);
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          const float f = to_f32(e[k]);
          ss += f * f;
        }
      }
    } else {
      for (int c = tid; c < d; c += kThreads) {
        const float f = to_f32(xr[c]);
        ss += f * f;
      }
    }
    red[tid] = ss;
    __syncthreads();
    for (int s = kThreads / 2; s > 0; s >>= 1) {
      if (tid < s) red[tid] += red[tid + s];
      __syncthreads();
    }
    const float r = rsqrtf(red[0] / (float)d + eps);
    __syncthreads();  // red[0] is read before the next row overwrites it
    if (vec) {
      for (int c = tid * kVec; c < d; c += kThreads * kVec) {
        const uint4 u = *reinterpret_cast<const uint4*>(xr + c);
        const TX* e = reinterpret_cast<const TX*>(&u);
        uint4 o;
        TX* oe = reinterpret_cast<TX*>(&o);
#pragma unroll
        for (int k = 0; k < kVec; ++k)
          oe[k] = from_f32<TX>(to_f32(e[k]) * r * to_f32(w[c + k]));
        *reinterpret_cast<uint4*>(orow + c) = o;
      }
    } else {
      for (int c = tid; c < d; c += kThreads)
        orow[c] = from_f32<TX>(to_f32(xr[c]) * r * to_f32(w[c]));
    }
  }
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, void* out, int64_t rows,
                   int d, int64_t ldx, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(TX);
  const bool vec = d % kVec == 0 && ldx % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const unsigned grid = (unsigned)(rows < kMaxGrid ? rows : kMaxGrid);
  rmsnorm_kernel<TX, TW><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<TX*>(out), rows, d, ldx, eps, vec);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t launch_w(int w_dtype, const void* x, const void* w, void* out,
                     int64_t rows, int d, int64_t ldx, float eps,
                     cudaStream_t stream) {
  if (w_dtype == 0)
    return launch<TX, float>(x, w, out, rows, d, ldx, eps, stream);
  return launch<TX, __nv_bfloat16>(x, w, out, rows, d, ldx, eps, stream);
}

}  // namespace

extern "C" {

// Enqueues one kernel on ``stream`` of ``device`` and returns the launch's
// cudaError_t (0 on success); it does not synchronise.  x is (rows, d) with
// row stride ldx and unit column stride, out (rows, d) contiguous in x's
// dtype, w (d,).  Dtype codes: 0 is float32, 1 is bfloat16.  rows and d
// must be positive.
int rmsnorm_launch(const void* x, const void* w, void* out, int64_t rows,
                   int64_t d, int64_t ldx, int x_dtype, int w_dtype,
                   float eps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows <= 0 || d <= 0 || d > (1 << 30) || ldx < d || x_dtype < 0 ||
      x_dtype > 1 || w_dtype < 0 || w_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 0)
    return (int)launch_w<float>(w_dtype, x, w, out, rows, (int)d, ldx, eps,
                                s);
  return (int)launch_w<__nv_bfloat16>(w_dtype, x, w, out, rows, (int)d, ldx,
                                      eps, s);
}

const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
