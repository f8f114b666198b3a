// Row-wise RMSNorm for Hopper (sm_90a), bound to Python with ctypes (see
// repro_torch/kernels/rmsnorm/kernel.py).
//
// Replaces the JAX package's Pallas kernel
//   rmsnorm_kernel_rows, rmsnorm_kernel
//     <- src/repro/kernels/rmsnorm/kernel.py:23 rmsnorm_pallas
//        (body _rmsnorm_kernel :16)
// which computes, per row, out = x * rsqrt(mean(x^2) + eps) * w with
// float32 math and writes out in x's dtype.  x and w are float32 or
// bfloat16, independently: the serve path runs d = 1024 in bfloat16 (the
// layer norms) and d = 2048 in float32 with a bfloat16 scale (the gated
// norm), at 8192 rows in prefill and 4 rows per decode step.
//
// Bound.  Four flops per element against 2 x sizeof(x) bytes moved (x read,
// out written): far below the card's 20 flop/byte f32 balance, so it is
// bound by bytes at prefill (norm1 (8192, 1024) bf16: 33.6 MB, 10.0 us at
// 3.35 TB/s; gated (8192, 2048) f32: 134 MB, 40.1 us) and by one launch's
// latency at decode (16 KB and 64 KB).  What reaches the byte bound is
// enough loads in flight on every SM, x read from device memory once, and
// nothing that holds a warp's next loads back.
//
// Design.  Two kernels, one launch per call; the launcher picks one from
// the shape and the alignment alone (rmsnorm_variant below says which).
//
// rmsnorm_kernel_rows<G>, the register-resident case.  G warps own one
// row; G (1, 2, 4 or 8) is the least that leaves each lane at most
// kLaneVecs = 4 sixteen-byte vectors of x (64 bytes): G = 1 for norm1,
// G = 4 for the gated norm.  A lane issues all its vector loads of the row
// before any arithmetic, then loads its slice of w, sums x^2 in float32,
// and the group reduces by __shfl_xor_sync and, for G > 1, through G floats
// of shared memory (double buffered: one barrier per row).  The lane then
// scales and stores from its registers: x is read once, with no second
// pass.  A block of 128 threads holds 4 / G rows (one row of 256 threads
// at G = 8) and walks the rows in a grid-stride loop.  The grid is SMs x
// resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
// queried once per instantiation and cached) for G = 1, where no barrier
// couples a block's warps and a warp goes on to its next row at once; for
// G > 1 it is 4 times that, because the per-row barrier holds a persistent
// block's next loads until its slowest row has arrived, and fresh blocks
// keep the loads flowing instead.  At decode the 4 rows are 4 G warps in
// one to four blocks.  It needs x, out and w 16-byte aligned, d and the
// row stride a whole number of vectors, and d at most 8 x 32 x 4 vectors
// (16 KB of x per row).
//
// Tried on the card and dropped for being slower at the path's shapes:
// loading w once per warp before the row loop (16 more registers, for rows
// a warp sees once or twice, against w's slice read per row from L1); two
// rows in flight per warp; a 6-block occupancy bound (it spilled); and a
// persistent grid at G = 4.  At both prefill shapes the kernel, timed cold
// by kernels/rmsnorm/bench.py, runs at the speed of a plain copy of the
// same bytes (x.clone()).
//
// rmsnorm_kernel, the generic case (this file's first design, unchanged).
// One block of 256 threads per row in a grid-stride loop: the threads sum x^2
// through a shared-memory tree and make a second pass that writes
// x * r * w, by 16-byte vectors where the row start, its stride and d
// allow, else element by element.  It takes any row count, any d and any
// row stride >= d, and runs whatever the register case refuses.
//
// Both sum in another order than the plain version's, so results agree to
// float32 rounding (bf16 outputs may move by one ulp).  The order is fixed
// by the shape, so two calls on the same inputs give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;        // generic kernel: one block per row
constexpr int64_t kMaxGrid = 1 << 20;
constexpr int kRowThreads = 128;     // register kernel: 4 / G rows a block
constexpr int kLaneVecs = 4;         // 16-byte vectors of x per lane, at most
constexpr int kMaxGroup = 8;         // warps per row, at most
constexpr int kOversub = 4;          // G > 1: blocks per resident slot
constexpr int kMaxDevices = 64;

// The register kernel's block: 4 / G rows, or one row of 8 warps.
__host__ __device__ constexpr int row_block(int g) {
  return kRowThreads > 32 * g ? kRowThreads : 32 * g;
}

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

// Element k of a vector held as packed 32-bit words.
template <typename T>
__device__ __forceinline__ float word_elem(const uint32_t* w, int k);
template <>
__device__ __forceinline__ float word_elem<float>(const uint32_t* w, int k) {
  return __uint_as_float(w[k]);
}
template <>
__device__ __forceinline__ float word_elem<__nv_bfloat16>(const uint32_t* w,
                                                          int k) {
  const uint32_t v = w[k >> 1];  // bf16 -> f32 is exact: the high 16 bits
  return __uint_as_float((k & 1) ? (v & 0xffff0000u) : (v << 16));
}

// Element pair (k, k + 1) of a vector in T, packed into 32-bit words.
template <typename T>
__device__ __forceinline__ void put_pair(uint32_t* w, int k, float a,
                                         float b);
template <>
__device__ __forceinline__ void put_pair<float>(uint32_t* w, int k, float a,
                                                float b) {
  w[k] = __float_as_uint(a);
  w[k + 1] = __float_as_uint(b);
}
template <>
__device__ __forceinline__ void put_pair<__nv_bfloat16>(uint32_t* w, int k,
                                                        float a, float b) {
  w[k >> 1] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16(a)) |
              ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(b)) << 16);
}

template <typename TX, typename TW, int G>
__global__ void __launch_bounds__(row_block(G))
    rmsnorm_kernel_rows(const TX* __restrict__ x, const TW* __restrict__ w,
                        TX* __restrict__ out, int64_t rows, int d,
                        int64_t ldx, float eps) {
  constexpr int kVec = 16 / sizeof(TX);            // elements per vector
  constexpr int kWWords = kVec * sizeof(TW) / 4;   // w's words per vector
  constexpr int kGroupLanes = 32 * G;
  __shared__ float part[2][row_block(G) / 32];     // one sum per warp
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slot = warp / G;                       // the block's row slot
  const int gl = (warp % G) * 32 + lane;           // lane within the group
  const int nvec = d / kVec;
  const int rpb = blockDim.x / kGroupLanes;

  int buf = 0;
  for (int64_t base = (int64_t)blockIdx.x * rpb; base < rows;
       base += (int64_t)gridDim.x * rpb, buf ^= 1) {
    const int64_t row = base + slot;
    const bool live = row < rows;                  // uniform in the warp
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * ldx);
    uint4 u[kLaneVecs];
#pragma unroll
    for (int j = 0; j < kLaneVecs; ++j) {          // every load of x first
      const int v = gl + j * kGroupLanes;
      u[j] = (live && v < nvec) ? __ldg(xr + v) : make_uint4(0, 0, 0, 0);
    }
    uint32_t wv[kLaneVecs][kWWords];               // then w's slice, packed
#pragma unroll
    for (int j = 0; j < kLaneVecs; ++j) {
      const int v = gl + j * kGroupLanes;
      if (!(live && v < nvec)) continue;
      if constexpr (kWWords == 2) {
        const uint2 q = __ldg(reinterpret_cast<const uint2*>(w) + v);
        wv[j][0] = q.x;
        wv[j][1] = q.y;
      } else {
#pragma unroll
        for (int h = 0; h < kWWords / 4; ++h) {
          const uint4 q = __ldg(reinterpret_cast<const uint4*>(w) +
                                v * (kWWords / 4) + h);
          wv[j][4 * h] = q.x;
          wv[j][4 * h + 1] = q.y;
          wv[j][4 * h + 2] = q.z;
          wv[j][4 * h + 3] = q.w;
        }
      }
    }
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < kLaneVecs; ++j) {
      const uint32_t* e = reinterpret_cast<const uint32_t*>(&u[j]);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float f = word_elem<TX>(e, k);
        ss += f * f;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if constexpr (G > 1) {
      // the other buffer is free: every thread passed this barrier of the
      // previous row only after it had read that buffer two rows ago
      if (lane == 0) part[buf][warp] = ss;
      __syncthreads();
      ss = 0.f;
#pragma unroll
      for (int k = 0; k < G; ++k) ss += part[buf][slot * G + k];
    }
    if (!live) continue;
    const float r = rsqrtf(ss / (float)d + eps);
    uint4* orow = reinterpret_cast<uint4*>(out + row * d);
#pragma unroll
    for (int j = 0; j < kLaneVecs; ++j) {
      const int v = gl + j * kGroupLanes;
      if (v < nvec) {
        const uint32_t* e = reinterpret_cast<const uint32_t*>(&u[j]);
        uint4 o;
        uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
        for (int k = 0; k < kVec; k += 2)
          put_pair<TX>(ow, k, word_elem<TX>(e, k) * r * word_elem<TW>(wv[j], k),
                       word_elem<TX>(e, k + 1) * r *
                           word_elem<TW>(wv[j], k + 1));
        orow[v] = o;
      }
    }
  }
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

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Which kernel the launcher runs: 0 for the generic kernel, else G (warps
// per row) of the register kernel.  x_size is sizeof(x's element).
int choose_group(int64_t d, int64_t ldx, int x_size, const void* x,
                 const void* w, const void* out) {
  const int64_t vec = 16 / x_size;
  if (d % vec || ldx % vec || !aligned16(x) || !aligned16(w) ||
      !aligned16(out))
    return 0;
  const int64_t nvec = d / vec;
  for (int g = 1; g <= kMaxGroup; g *= 2)
    if (nvec <= (int64_t)32 * g * kLaneVecs) return g;
  return 0;
}

// launches by variant in this process: the generic kernel, then G = 1..8
std::atomic<int64_t> g_launches[5];

int variant_index(int g) { return g == 0 ? 0 : 1 + __builtin_ctz(g); }

int sm_count(int device) {
  static std::atomic<int> cache[kMaxDevices];
  int n = device < kMaxDevices ? cache[device].load() : 0;
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (n <= 0) n = 1;
    if (device < kMaxDevices) cache[device].store(n);
  }
  return n;
}

template <typename TX, typename TW, int G>
cudaError_t launch_rows(const void* x, const void* w, void* out, int64_t rows,
                        int d, int64_t ldx, float eps, int device,
                        cudaStream_t stream) {
  static std::atomic<int> resident{0};  // blocks per SM, queried once
  int per_sm = resident.load();
  if (per_sm == 0) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rmsnorm_kernel_rows<TX, TW, G>, row_block(G), 0);
    if (err != cudaSuccess) return err;
    if (per_sm <= 0) per_sm = 1;
    resident.store(per_sm);
  }
  constexpr int rpb = row_block(G) / (32 * G);
  const int64_t slots = rows < rpb ? rows : rpb;   // rows in the block
  const int64_t groups = (rows + rpb - 1) / rpb;
  // one persistent wave for G = 1, 4 blocks per resident slot for G > 1
  const int64_t cap =
      (int64_t)sm_count(device) * per_sm * (G == 1 ? 1 : kOversub);
  const unsigned grid = (unsigned)(groups < cap ? groups : cap);
  rmsnorm_kernel_rows<TX, TW, G>
      <<<grid, (unsigned)(slots * 32 * G), 0, stream>>>(
          static_cast<const TX*>(x), static_cast<const TW*>(w),
          static_cast<TX*>(out), rows, d, ldx, eps);
  return cudaGetLastError();
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, void* out, int64_t rows,
                   int d, int64_t ldx, float eps, int device,
                   cudaStream_t stream, int* chosen) {
  const int g = choose_group(d, ldx, sizeof(TX), x, w, out);
  *chosen = g;
  switch (g) {
    case 1:
      return launch_rows<TX, TW, 1>(x, w, out, rows, d, ldx, eps, device,
                                    stream);
    case 2:
      return launch_rows<TX, TW, 2>(x, w, out, rows, d, ldx, eps, device,
                                    stream);
    case 4:
      return launch_rows<TX, TW, 4>(x, w, out, rows, d, ldx, eps, device,
                                    stream);
    case 8:
      return launch_rows<TX, TW, 8>(x, w, out, rows, d, ldx, eps, device,
                                    stream);
  }
  constexpr int kVec = 16 / sizeof(TX);
  const bool vec = d % kVec == 0 && ldx % kVec == 0 && aligned16(x) &&
                   aligned16(out);
  const unsigned grid = (unsigned)(rows < kMaxGrid ? rows : kMaxGrid);
  rmsnorm_kernel<TX, TW><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<TX*>(out), rows, d, ldx, eps, vec);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t launch_w(int w_dtype, const void* x, const void* w, void* out,
                     int64_t rows, int d, int64_t ldx, float eps, int device,
                     cudaStream_t stream, int* chosen) {
  if (w_dtype == 0)
    return launch<TX, float>(x, w, out, rows, d, ldx, eps, device, stream,
                             chosen);
  return launch<TX, __nv_bfloat16>(x, w, out, rows, d, ldx, eps, device,
                                   stream, chosen);
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
      x_dtype > 1 || w_dtype < 0 || w_dtype > 1 || device < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int chosen = 0;
  if (x_dtype == 0)
    err = launch_w<float>(w_dtype, x, w, out, rows, (int)d, ldx, eps, device,
                          s, &chosen);
  else
    err = launch_w<__nv_bfloat16>(w_dtype, x, w, out, rows, (int)d, ldx, eps,
                                  device, s, &chosen);
  if (err == cudaSuccess) g_launches[variant_index(chosen)]++;
  return (int)err;
}

// Which kernel rmsnorm_launch runs for these arguments, from the shape and
// the alignment alone: 1 for the register kernel, with its warps per row
// in *groups and its rows per block in *rows_per_block; 0 for the generic
// kernel (*groups = 0, *rows_per_block = 1); -1 for arguments that
// rmsnorm_launch refuses.  Needs no device.
int rmsnorm_variant(int64_t rows, int64_t d, int64_t ldx, int x_dtype,
                    const void* x, const void* w, const void* out,
                    int* groups, int* rows_per_block) {
  if (rows <= 0 || d <= 0 || d > (1 << 30) || ldx < d || x_dtype < 0 ||
      x_dtype > 1)
    return -1;
  const int g = choose_group(d, ldx, x_dtype == 0 ? 4 : 2, x, w, out);
  *groups = g;
  *rows_per_block = g ? row_block(g) / (32 * g) : 1;
  return g ? 1 : 0;
}

// The successful launches of each kernel in this process so far:
// counts[0] the generic kernel, counts[1 + log2 G] the register kernel
// with G warps per row (G = 1, 2, 4, 8).
void rmsnorm_variant_launches(int64_t* counts) {
  for (int i = 0; i < 5; ++i) counts[i] = g_launches[i].load();
}

const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
