// Register-blocked IEEE-f32 GEMM for Hopper (sm_90a), bound to Python with
// ctypes (see repro_torch/kernels/dgemm/kernel.py).
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
// FMAs on the CUDA cores, never TF32 (HPL's residual depends on it).
//
// Bound.  At HPL's step-0 update for n = 32768, nb = 256, (32512, 256) @
// (256, 32256) is 5.37e11 flop: 8.0 ms at 67 TFLOP/s f32, against 8.5 GB
// (c read and written once, x and y read once), 2.5 ms at 3.35 TB/s.  So
// it is bound by operations, and the design aims at FMA throughput.
//
// Design.  Two block tiles, 128 x 128 (the default, and HPL's) and 64 x
// 128, each with 8 x 8 outputs per thread in registers ((kBM / 8) x 16
// threads: 256 and 128), a k step of 16 and a ring of 4 shared-memory
// stages, so three k steps of loads are in flight while one is multiplied
// and there is one barrier per 1024 FMAs of a thread.  The 64-row tile has
// twice the blocks for a small output, at the price of reading y twice as
// often; the autotuner (repro_torch/autotune) chooses between them.  Each
// output element is summed over k in the same order by both tiles, so the
// two give the same bits.
//   - float32 inputs go global -> shared by cp.async and hold no
//     registers.  The A tile is stored transposed (k-major, rows padded by
//     4 floats), each element by a 4-byte cp.async.ca; the B tile, already
//     k-major, by 16-byte cp.async.cg where y and its leading dimension
//     are 16-byte aligned (HPL's views are), else by 4-byte copies.  Edges
//     in m, n and k copy fewer source bytes and zero-fill the rest, so no
//     dimension need divide a tile and K may be 0.
//   - bfloat16 inputs go through registers (converted to float32 on the
//     way): the loads for stage t + 3 are issued before stage t's FMAs and
//     stored after them.
//   - Per k each thread reads its 8 A values and 8 B values as four float4
//     (rows {4ty..4ty+3, kBM/2+4ty..}, columns {4tx.., 64+4tx..}): 64 FMAs
//     per 4 shared loads, 4 per value, and a warp's reads are broadcasts or
//     one 128-byte line (no bank conflicts).
//   - The grid is rasterized in groups of 8 row tiles: the blocks resident
//     on 132 SMs share 8 strips of x and a few dozen of y in L2, instead of
//     one strip of x against all of y.  Several resident blocks per SM
//     (two of the 128-row tile, four of the 64-row one, as the register
//     budget below allows) let one block's epilogue overlap the others'
//     loads and FMAs.
// The epilogue uses float4 when c is float32, 16-byte aligned and its
// leading dimension a multiple of 4, else scalars.  wgmma, TMA and a
// tensor-core path are not used: they would not keep IEEE f32 sums.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBN = 128, kBK = 16;
constexpr int kStages = 4;
constexpr int kGroupM = 8;                  // row tiles per raster group

// The block tile kBM x kBN x kBK and what follows from it.
template <int kBM>
struct Tile {
  static_assert(kBM == 64 || kBM == 128, "the tiles are 64 and 128 rows");
  static constexpr int kThreads = (kBM / 8) * (kBN / 8);
  static constexpr int kALd = kBM + 4;      // As[k][m], padded
  static constexpr int kBLd = kBN;          // Bs[k][n]
  static constexpr int kStageFloats = kBK * kALd + kBK * kBLd;
  static constexpr int kSmemBytes = kStages * kStageFloats * (int)sizeof(float);
  // A copies: rows a_m + kAStep j (j < kAJ) of column a_k
  static constexpr int kAStep = kThreads / kBK;
  static constexpr int kAJ = kBM / kAStep;
  // B copies, 16-byte: rows b_k + kBVecStep j (j < kBVecJ)
  static constexpr int kBVecStep = kThreads / 32;
  static constexpr int kBVecJ = kBK / kBVecStep;
  // B copies, 4-byte: rows b_k + kBStep j (j < kBJ) of column tid % kBN
  static constexpr int kBStep = kThreads / kBN;
  static constexpr int kBJ = kBK / kBStep;
  static_assert(kAJ <= 8, "a_rows holds 8 row bits");
};

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// copies src_bytes (0..16) from src and zero-fills the rest of 16 bytes
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
// copies src_bytes (0 or 4) from src and zero-fills the rest of 4 bytes
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

template <int kBM, typename TIn>
constexpr int min_blocks() {
  // the same register budget per thread for both tiles: 128 for float32;
  // bfloat16 stages its loads in registers, so give it room
  return (sizeof(TIn) == 4 ? 2 : 1) * 256 / Tile<kBM>::kThreads;
}

template <int kBM, typename TIn, typename TOut, bool kUpdate, bool kVecB>
__global__ void __launch_bounds__(Tile<kBM>::kThreads, (min_blocks<kBM, TIn>()))
gemm_kernel(const TIn* __restrict__ x, const TIn* __restrict__ y,
            TOut* __restrict__ c, int64_t m, int64_t n, int64_t k,
            int64_t ldx, int64_t ldy, int64_t ldc, int tiles_m, int tiles_n,
            bool vec_c) {
  using T = Tile<kBM>;
  constexpr int kALd = T::kALd, kBLd = T::kBLd, kStageFloats = T::kStageFloats;
  extern __shared__ __align__(16) float smem[];
  constexpr bool kAsync = std::is_same<TIn, float>::value;

  // rasterized tile order: groups of kGroupM row tiles, column-major inside
  const int pid = blockIdx.x;
  const int width = kGroupM * tiles_n;
  const int first = pid / width * kGroupM;
  const int gsize = min(tiles_m - first, kGroupM);
  const int r = pid % width;
  const int64_t m0 = (int64_t)(first + r % gsize) * kBM;
  const int64_t n0 = (int64_t)(r / gsize) * kBN;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  // A copies: column a_k of rows a_m + kAStep j (j < kAJ); xa points at
  // the next tile's j = 0 element.  The row tests are made once, the k
  // test per tile.
  const int a_k = tid % kBK, a_m = tid / kBK;
  const TIn* xa = x + (m0 + a_m) * ldx + a_k;
  const int64_t xa_j = T::kAStep * ldx;
  unsigned a_rows = 0;
#pragma unroll
  for (int j = 0; j < T::kAJ; ++j)
    if (m0 + a_m + T::kAStep * j < m) a_rows |= 1u << j;
  // B copies.  16-byte: columns 4 (tid % 32).. of rows tid / 32 +
  // kBVecStep j.  Scalar: column tid % 128 of rows tid / 128 + kBStep j.
  const int b_k = kVecB ? tid / 32 : tid / kBN;
  const int b_n = kVecB ? 4 * (tid % 32) : tid % kBN;
  const TIn* yb = y + b_k * ldy + n0 + b_n;
  const int64_t left = n - n0 - b_n;        // columns from b_n to the edge
  const int b_bytes = left >= 4 ? 16 : left > 0 ? 4 * (int)left : 0;
  const int64_t yb_j = (kVecB ? T::kBVecStep : T::kBStep) * ldy,
                yb_step = kBK * ldy;
  int64_t k0_next = 0;

  auto as_of = [&](int s) { return smem + s * kStageFloats; };
  auto bs_of = [&](int s) { return smem + s * kStageFloats + kBK * kALd; };

  // float32: issue the copies of the next tile into stage s
  auto load_async = [&](int s) {
    float* as = as_of(s) + a_k * kALd + a_m;
    const bool ka = k0_next + a_k < k;
#pragma unroll
    for (int j = 0; j < T::kAJ; ++j) {
      const bool ok = ka && ((a_rows >> j) & 1u);
      cp_async_4(smem_addr(as + T::kAStep * j), ok ? xa + j * xa_j : x,
                 ok ? 4 : 0);
    }
    float* bs = bs_of(s) + b_k * kBLd + b_n;
    if constexpr (kVecB) {
#pragma unroll
      for (int j = 0; j < T::kBVecJ; ++j) {
        const bool ok = k0_next + b_k + T::kBVecStep * j < k && b_bytes > 0;
        cp_async_16(smem_addr(bs + T::kBVecStep * j * kBLd),
                    ok ? yb + j * yb_j : y, ok ? b_bytes : 0);
      }
    } else {
      const bool col_ok = b_bytes > 0;
#pragma unroll
      for (int j = 0; j < T::kBJ; ++j) {
        const bool ok = col_ok && k0_next + b_k + T::kBStep * j < k;
        cp_async_4(smem_addr(bs + T::kBStep * j * kBLd),
                   ok ? yb + j * yb_j : y, ok ? 4 : 0);
      }
    }
    xa += kBK;
    yb += yb_step;
    k0_next += kBK;
  };

  // bfloat16: fetch the next tile into registers, later store it to s
  float ra[T::kAJ], rb[T::kBJ];
  auto fetch = [&]() {
    const bool ka = k0_next + a_k < k;
    const bool col_ok = b_bytes > 0;
#pragma unroll
    for (int j = 0; j < T::kAJ; ++j)
      ra[j] = ka && ((a_rows >> j) & 1u) ? to_f32(xa[j * xa_j]) : 0.f;
#pragma unroll
    for (int j = 0; j < T::kBJ; ++j)
      rb[j] = col_ok && k0_next + b_k + T::kBStep * j < k
                  ? to_f32(yb[j * yb_j]) : 0.f;
    xa += kBK;
    yb += yb_step;
    k0_next += kBK;
  };
  auto put = [&](int s) {
    float* as = as_of(s) + a_k * kALd + a_m;
    float* bs = bs_of(s) + b_k * kBLd + b_n;
#pragma unroll
    for (int j = 0; j < T::kAJ; ++j) as[T::kAStep * j] = ra[j];
#pragma unroll
    for (int j = 0; j < T::kBJ; ++j) bs[T::kBStep * j * kBLd] = rb[j];
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  auto compute = [&](int s) {
    const float* as = as_of(s);
    const float* bs = bs_of(s);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * kALd +
                                                         4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(
          as + kk * kALd + kBM / 2 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * kBLd +
                                                         4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + kk * kBLd + 64 +
                                                         4 * tx);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  };

  const int64_t tiles_k = (k + kBK - 1) / kBK;
  if constexpr (kAsync) {
    // one commit group per tile (empty past the end), so that waiting for
    // all but the newest kStages - 2 groups means tile t has landed
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < tiles_k) load_async(s);
      cp_async_commit();
    }
    for (int64_t t = 0; t < tiles_k; ++t) {
      cp_async_wait<kStages - 2>();
      // tile t is visible to all, and every thread is done with tile t - 1,
      // whose stage the copies below refill
      __syncthreads();
      if (t + kStages - 1 < tiles_k) load_async((int)((t + kStages - 1) %
                                                      kStages));
      cp_async_commit();
      compute((int)(t % kStages));
    }
  } else {
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < tiles_k) {
        fetch();
        put(s);
      }
    }
    for (int64_t t = 0; t < tiles_k; ++t) {
      __syncthreads();
      const bool more = t + kStages - 1 < tiles_k;
      if (more) fetch();                  // in flight during the FMAs below
      compute((int)(t % kStages));
      if (more) put((int)((t + kStages - 1) % kStages));
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t row =
        m0 + (i < 4 ? 4 * ty + i : kBM / 2 + 4 * ty + i - 4);
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

template <int kBM, typename TIn, typename TOut, bool kUpdate, bool kVecB>
cudaError_t launch_kernel(const void* x, const void* y, void* c, int64_t m,
                          int64_t n, int64_t k, int64_t ldx, int64_t ldy,
                          int64_t ldc, cudaStream_t stream) {
  using T = Tile<kBM>;
  auto kern = gemm_kernel<kBM, TIn, TOut, kUpdate, kVecB>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int64_t tiles_m = (m + kBM - 1) / kBM, tiles_n = (n + kBN - 1) / kBN;
  if (tiles_m * tiles_n > 0x7fffffff || tiles_n * kGroupM > 0x7fffffff)
    return cudaErrorInvalidConfiguration;
  const bool vec_c = sizeof(TOut) == 4 && ldc % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(c) % 16 == 0;
  kern<<<(unsigned)(tiles_m * tiles_n), T::kThreads, T::kSmemBytes, stream>>>(
      static_cast<const TIn*>(x), static_cast<const TIn*>(y),
      static_cast<TOut*>(c), m, n, k, ldx, ldy, ldc, (int)tiles_m,
      (int)tiles_n, vec_c);
  return cudaGetLastError();
}

template <int kBM, typename TIn, typename TOut, bool kUpdate>
cudaError_t launch(const void* x, const void* y, void* c, int64_t m,
                   int64_t n, int64_t k, int64_t ldx, int64_t ldy,
                   int64_t ldc, cudaStream_t stream) {
  if constexpr (std::is_same<TIn, float>::value) {
    if (ldy % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0)
      return launch_kernel<kBM, TIn, TOut, kUpdate, true>(
          x, y, c, m, n, k, ldx, ldy, ldc, stream);
  }
  return launch_kernel<kBM, TIn, TOut, kUpdate, false>(x, y, c, m, n, k, ldx,
                                                       ldy, ldc, stream);
}

template <int kBM, typename TIn, bool kUpdate>
cudaError_t launch_out(int out_dtype, const void* x, const void* y, void* c,
                       int64_t m, int64_t n, int64_t k, int64_t ldx,
                       int64_t ldy, int64_t ldc, cudaStream_t stream) {
  if (out_dtype == 0)
    return launch<kBM, TIn, float, kUpdate>(x, y, c, m, n, k, ldx, ldy, ldc,
                                            stream);
  return launch<kBM, TIn, __nv_bfloat16, kUpdate>(x, y, c, m, n, k, ldx, ldy,
                                                  ldc, stream);
}

template <int kBM>
cudaError_t launch_tile(int in_dtype, int out_dtype, int update,
                        const void* x, const void* y, void* c, int64_t m,
                        int64_t n, int64_t k, int64_t ldx, int64_t ldy,
                        int64_t ldc, cudaStream_t s) {
  if (in_dtype == 0)
    return update ? launch_out<kBM, float, true>(out_dtype, x, y, c, m, n, k,
                                                 ldx, ldy, ldc, s)
                  : launch_out<kBM, float, false>(out_dtype, x, y, c, m, n, k,
                                                  ldx, ldy, ldc, s);
  return update ? launch_out<kBM, __nv_bfloat16, true>(out_dtype, x, y, c, m,
                                                       n, k, ldx, ldy, ldc, s)
                : launch_out<kBM, __nv_bfloat16, false>(out_dtype, x, y, c, m,
                                                        n, k, ldx, ldy, ldc, s);
}

}  // namespace

extern "C" {

// Enqueues one kernel on ``stream`` of ``device`` and returns the launch's
// cudaError_t (0 on success); it does not synchronise.  Dtype codes: 0 is
// float32, 1 is bfloat16.  ``update`` != 0 selects c -= x @ y, else
// c = x @ y.  ``bm`` is the block tile's rows, 128 or 64.  m and n must be
// positive.
int gemm_launch(const void* x, const void* y, void* c, int64_t m, int64_t n,
                int64_t k, int64_t ldx, int64_t ldy, int64_t ldc,
                int in_dtype, int out_dtype, int update, int bm, int device,
                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (m <= 0 || n <= 0 || k < 0 || in_dtype < 0 || in_dtype > 1 ||
      out_dtype < 0 || out_dtype > 1 || (bm != 128 && bm != 64))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bm == 128)
    err = launch_tile<128>(in_dtype, out_dtype, update, x, y, c, m, n, k, ldx,
                           ldy, ldc, s);
  else
    err = launch_tile<64>(in_dtype, out_dtype, update, x, y, c, m, n, k, ldx,
                          ldy, ldc, s);
  return (int)err;
}

const char* gemm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
