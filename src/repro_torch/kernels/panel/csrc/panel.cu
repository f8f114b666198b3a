// HPL's panel factorization and its row swaps for Hopper (sm_90a), bound
// to Python with ctypes (see repro_torch/kernels/panel/kernel.py).
//
// Replaces no Pallas kernel: the JAX package factors the panel with jnp
// code (src/repro/hpl/lu.py), and the port did the same with PyTorch ops,
// about 26 launches a column (repro_torch/hpl/lu.py::_panel_factor, kept
// as the plain version).  At n = 65536, nb = 256 that was 6,683 launches a
// panel, and the card sat idle three quarters of the factorization while
// the host issued them.  Two kernels take their place, one launch each a
// panel:
//
//   panel_lu_kernel  factors columns [0, nb) of the m x nb panel (a view
//                    of a larger row-major matrix), with partial pivoting:
//                    the first largest |a| of each column (torch.argmax's
//                    rule, NaN above all), the pivot row swapped within
//                    the panel's columns only, the column divided
//                    (correctly rounded) by where(|pivot| < 1e-30, 1,
//                    pivot), and the rank-1 update as one fmaf an element,
//                    as the plain version's addr_.
//   laswp_kernel     applies the panel's swaps, in order, to the columns
//                    outside it, with the pivots read on the device.
//
// Bound.  Not the card's rates: a column needs the largest |a| over every
// row below the diagonal before any row can move, so each of the n
// columns of a factorization waits on every block of the grid, a few
// round trips through L2 (~1 us each), ~0.2-0.4 s at n = 65536.  The bytes
// come second: the panel at k0 = 0 is 65536 x 256 f32, 64 MB, more than
// the SMs' shared memory and the 50 MB L2, so a column-at-a-time pass
// over device memory would move ~34 GB a panel.  (On an H100 at 700 W:
// 1.84 ms a panel at k0 = 0, 1.52 ms at k0 = n / 2, ~7 us a column.)
//
// Design of panel_lu_kernel.  One cooperative launch of B <= #SMs blocks
// (B from the panel's rows, ~128 rows a block at least), 512 threads
// each.  Block b owns the rows r = b (mod B), cyclically, so the rows that
// retire above the diagonal leave every block about as busy.  The panel's
// columns go in chunks of 32:
//   - A block holds its rows of the chunk in shared memory (up to ~1,500
//     rows: 210 KB).  For each column it publishes its largest |a| and
//     that row's 32 values, and the owner of the diagonal row publishes
//     that row; one grid-wide barrier; then one warp of every block picks
//     the pivot row from the B candidates as every block does, and reads
//     the pivot row's values (for the update) and the diagonal row's (for
//     the owner of the pivot row, to swap them within the chunk).  Then a
//     thread a row divides, applies the rank-1 update and notes its |a| of
//     the next column, whose largest the block publishes next.  The
//     published values are double-buffered: a block overwrites a column's
//     only after the next column's barrier, so after every block has read
//     them.
//   - At the end of a chunk its rows go back to device memory; the
//     chunk's 32 swaps, as one move of at most 64 rows, are applied to
//     the panel's other columns (one thread a column); one grid-wide
//     barrier; then every block solves the chunk's 32 rows of U for the
//     later columns (the same values in every block, from a copy the swap
//     pass made) and updates its own rows of those columns, 128 columns at
//     a time.  Each element sees the same fmaf's in the same order as in
//     the column-by-column plain version.
// Every read of another block's writes comes after a grid barrier that
// follows the write: the swap pass of a chunk reads the rows that their
// owners updated in the previous chunk, with the chunk's column barriers
// in between.  So a panel costs a barrier a column and one more a chunk,
// and moves its bytes about nb / 64 times instead of nb times.
//
// Design of laswp_kernel.  The nb swaps, taken 256 at a time, are turned
// into one move of at most 512 rows (the same for every column); each
// block computes it once and then moves tiles of 32 columns through
// shared memory: all sources read, then all destinations written.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 512;              // panel_lu_kernel's block
constexpr int kWarps = kThreads / 32;
constexpr int kW = 32;                     // columns of a chunk, one a lane
constexpr int kLd = kW + 1;                // a row of the stripe, padded
constexpr int kTC = 128;                   // trailing columns a tile
constexpr int kRowsPerBlock = 128;         // rows a block at least holds
constexpr int kSwapThreads = 512;          // laswp_kernel's block
constexpr int kGroup = 256;                // swaps turned into one move
constexpr int kColTile = 32;               // laswp's columns a tile
constexpr unsigned kFull = 0xffffffffu;

// workspace of panel_lu_kernel, in bytes, for B blocks and nb columns:
// the barrier's count, zero at the launch; two of each of the values that
// blocks publish a column (their candidates' |a| and rows, the candidates'
// rows of the chunk, the diagonal row); the chunk's rows of U
constexpr int64_t kBarrierBytes = 128;
int64_t workspace_bytes(int blocks, int nb) {
  return kBarrierBytes +
         4LL * (2 * (2 * blocks + blocks * kW + kW) + (int64_t)kW * nb);
}

// (v, r) before (bv, br): NaN above all, then larger v, then lower r
__device__ __forceinline__ bool better(float v, int r, float bv, int br) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn != bn) return vn;
  if (!vn && v != bv) return v > bv;
  return r < br;
}

__device__ __forceinline__ void warp_best(float& v, int& r) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int orow = __shfl_xor_sync(kFull, r, o);
    if (better(ov, orow, v, r)) {
      v = ov;
      r = orow;
    }
  }
}

// loads through L2 (another block's stores, after a barrier); volatile,
// so that the compiler keeps them after the barrier
__device__ __forceinline__ float ld_cg(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ int ld_cg(const int* p) {
  int v;
  asm volatile("ld.global.cg.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// Every block of the grid waits here for all the others; the writes made
// before it by any block are visible after it (to loads through L2).
// ``count`` is 0 at the launch; ``target`` is this block's running total.
__device__ __forceinline__ void grid_barrier(unsigned* count, unsigned blocks,
                                             unsigned& target) {
  __syncthreads();
  if (blocks > 1) {
    target += blocks;
    if (threadIdx.x == 0) {
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(count)
                   : "memory");
      while (ld_acquire(count) < target) {
      }
    }
    __syncthreads();
  }
}

constexpr int kNoRow = 0x7fffffff;         // a candidate of no row

// The swaps (base + t, p[t]) for t < count, applied in order, as one move
// of rows: afterwards row dst[s] holds what row src[s] held, for every
// slot s < 2 count with dst[s] >= 0.  Slot t < count is row base + t; slot
// count + t is row p[t] when that lies below base + count and t is its
// first swap.  p[t] >= base + t.  All threads of the block call it, and
// it ends on a barrier of the block.
__device__ void net_move(const int* p, int count, int base, int* slot,
                         int* dst, int* src) {
  for (int t = threadIdx.x; t < count; t += blockDim.x) {
    const int pt = p[t];
    int s = pt - base;
    if (s >= count) {
      int first = t;
      for (int u = 0; u < t; ++u)
        if (p[u] == pt) {
          first = u;
          break;
        }
      s = count + first;
    }
    slot[t] = s;
    dst[t] = src[t] = base + t;
    const bool first = s == count + t;
    dst[count + t] = src[count + t] = first ? pt : -1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int t = 0; t < count; ++t) {
      const int s = slot[t];
      const int x = src[t];
      src[t] = src[s];
      src[s] = x;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
panel_lu_kernel(float* __restrict__ a, int64_t lda, int m, int nb, int row0,
                int* __restrict__ piv, unsigned* __restrict__ barrier,
                float* __restrict__ cand_v, int* __restrict__ cand_r,
                float* __restrict__ cand_rows, float* __restrict__ diag,
                float* __restrict__ ubuf) {
  extern __shared__ float stripe[];        // [rows of this block][kLd]
  __shared__ float l11[kW * kLd];
  __shared__ __align__(16) float ut[kW * kTC];
  __shared__ float prow[kW];
  __shared__ float warp_v[kWarps];
  __shared__ int warp_r[kWarps];
  __shared__ int chunk_p[kW], slot[kW], mv_dst[2 * kW], mv_src[2 * kW];
  __shared__ float best_v;
  __shared__ int best_r;

  const int B = gridDim.x, b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nrows = b < m ? (m - 1 - b) / B + 1 : 0;
  unsigned target = 0;
  // the first of this block's rows at or below row r
  auto first_local = [&](int r) { return r <= b ? 0 : (r - b + B - 1) / B; };
  auto row_of = [&](int i) { return b + i * B; };
  auto srow = [&](int r) { return stripe + (r / B) * kLd; };
  auto agl = [&](int64_t r, int c) { return a + r * lda + c; };

  // (v, r), this thread's best, becomes the block's in best_v, best_r
  auto block_best = [&](float v, int r) {
    warp_best(v, r);
    if (lane == 0) {
      warp_v[warp] = v;
      warp_r[warp] = r;
    }
    __syncthreads();
    if (warp == 0) {
      v = lane < kWarps ? warp_v[lane] : -1.f;
      r = lane < kWarps ? warp_r[lane] : kNoRow;
      warp_best(v, r);
      if (lane == 0) {
        best_v = v;
        best_r = r;
      }
    }
    __syncthreads();
  };

  int buf = 0;
  for (int j0 = 0; j0 < nb; j0 += kW) {
    const int w = min(kW, nb - j0);
    for (int i = first_local(j0) + warp; i < nrows; i += kWarps)
      if (lane < w) stripe[i * kLd + lane] = ld_cg(agl(row_of(i), j0 + lane));
    __syncthreads();
    {
      float v = -1.f;
      int r = kNoRow;
      for (int i = first_local(j0) + tid; i < nrows; i += kThreads) {
        const float x = fabsf(stripe[i * kLd]);
        if (better(x, row_of(i), v, r)) {
          v = x;
          r = row_of(i);
        }
      }
      block_best(v, r);
    }

    for (int jj = 0; jj < w; ++jj) {
      const int j = j0 + jj;
      // publish this block's candidate with its row, and the diagonal row
      if (tid < w)
        cand_rows[((int64_t)buf * B + b) * kW + tid] =
            best_r != kNoRow ? srow(best_r)[tid] : 0.f;
      if (j % B == b && tid >= 32 && tid < 32 + w)
        diag[buf * kW + tid - 32] = srow(j)[tid - 32];
      if (tid == 64) {
        cand_v[buf * B + b] = best_v;
        cand_r[buf * B + b] = best_r;
      }
      grid_barrier(barrier, B, target);
      // warp 0 picks the pivot row from every block's candidate as every
      // block does; it swaps the two rows within the chunk
      if (warp == 0) {
        float v = -1.f;
        int r = kNoRow;
        for (int k = lane; k < B; k += 32) {
          const float cv = ld_cg(cand_v + buf * B + k);
          const int cr = ld_cg(cand_r + buf * B + k);
          if (better(cv, cr, v, r)) {
            v = cv;
            r = cr;
          }
        }
        warp_best(v, r);
        if (lane < w) {
          const float pr =
              ld_cg(cand_rows + ((int64_t)buf * B + r % B) * kW + lane);
          prow[lane] = pr;
          if (j % B == b) srow(j)[lane] = pr;
          if (r != j && r % B == b) srow(r)[lane] = ld_cg(diag + buf * kW + lane);
        }
        if (lane == 0) {
          chunk_p[jj] = r;
          if (b == 0) piv[j] = row0 + r;
        }
      }
      __syncthreads();
      // this block's rows below row j: divide, update, and find the best of
      // the next column; a thread a row
      const float pv = prow[jj];
      const float d = fabsf(pv) < 1e-30f ? 1.f : pv;
      const bool more = jj + 1 < w;
      float v = -1.f;
      int r = kNoRow;
      for (int i = first_local(j + 1) + tid; i < nrows; i += kThreads) {
        float* row = stripe + i * kLd;
        const float l = __fdiv_rn(row[jj], d);
        row[jj] = l;
#pragma unroll 4
        for (int c = jj + 1; c < w; ++c) row[c] = __fmaf_rn(-l, prow[c], row[c]);
        if (more) {
          const float y = fabsf(row[jj + 1]);
          if (better(y, row_of(i), v, r)) {
            v = y;
            r = row_of(i);
          }
        }
      }
      if (more) block_best(v, r);
      else __syncthreads();
      buf ^= 1;
    }

    // the chunk back to device memory
    for (int i = first_local(j0) + warp; i < nrows; i += kWarps)
      if (lane < w) *agl(row_of(i), j0 + lane) = stripe[i * kLd + lane];
    const int rest = nb - w;
    if (rest == 0) break;
    const bool tail = j0 + w < nb;
    // the chunk's swaps on the panel's other columns, and a copy of the
    // chunk's rows of the later columns for every block's solve
    net_move(chunk_p, w, j0, slot, mv_dst, mv_src);
    for (int c = b * kThreads + tid; c < rest; c += B * kThreads) {
      const int col = c < j0 ? c : c + w;
      float x[2 * kW];
#pragma unroll
      for (int s = 0; s < 2 * kW; ++s)
        if (s < 2 * w && mv_dst[s] >= 0) x[s] = ld_cg(agl(mv_src[s], col));
#pragma unroll
      for (int s = 0; s < 2 * kW; ++s)
        if (s < 2 * w && mv_dst[s] >= 0 && mv_src[s] != mv_dst[s])
          *agl(mv_dst[s], col) = x[s];
      if (col >= j0 + w) {
#pragma unroll
        for (int s = 0; s < kW; ++s)
          if (s < w) ubuf[(int64_t)s * nb + col] = x[s];
      }
    }
    if (!tail) break;
    grid_barrier(barrier, B, target);

    for (int e = tid; e < w * w; e += kThreads)
      l11[(e / w) * kLd + e % w] = ld_cg(agl(j0 + e / w, j0 + e % w));
    const int i0 = first_local(j0 + w);
    for (int c0 = j0 + w; c0 < nb; c0 += kTC) {
      const int tc = min(kTC, nb - c0);
      __syncthreads();
      for (int e = tid; e < kW * kTC; e += kThreads) {
        const int t = e / kTC, c = e % kTC;
        ut[e] = t < w && c < tc ? ld_cg(ubuf + (int64_t)t * nb + c0 + c) : 0.f;
      }
      __syncthreads();
      // U12 = L11^-1 (the chunk's rows), in the plain version's order
      if (tid < tc) {
        for (int t = 1; t < w; ++t) {
          float x = ut[t * kTC + tid];
          for (int s = 0; s < t; ++s)
            x = __fmaf_rn(-l11[t * kLd + s], ut[s * kTC + tid], x);
          ut[t * kTC + tid] = x;
        }
      }
      __syncthreads();
      for (int e = tid; e < w * tc; e += kThreads) {
        const int t = e / tc, c = e % tc;
        if ((j0 + t) % B == b) *agl(j0 + t, c0 + c) = ut[t * kTC + c];
      }
      // this block's rows below the chunk: A22 -= L21 U12, in column order
      for (int i = i0 + warp; i < nrows; i += kWarps) {
        float* arow = agl(row_of(i), c0);
        const float* lrow = stripe + i * kLd;
        float x[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          x[q] = 4 * lane + q < tc ? ld_cg(arow + 4 * lane + q) : 0.f;
        for (int t = 0; t < w; ++t) {
          const float l = lrow[t];
          const float4 uv = *reinterpret_cast<const float4*>(ut + t * kTC + 4 * lane);
          x[0] = __fmaf_rn(-l, uv.x, x[0]);
          x[1] = __fmaf_rn(-l, uv.y, x[1]);
          x[2] = __fmaf_rn(-l, uv.z, x[2]);
          x[3] = __fmaf_rn(-l, uv.w, x[3]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (4 * lane + q < tc) arow[4 * lane + q] = x[q];
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kSwapThreads)
laswp_kernel(float* __restrict__ a, int64_t lda, int cols, int k0, int nb,
             const int* __restrict__ piv) {
  extern __shared__ float tile[];          // [moved rows][kColTile]
  __shared__ int p[kGroup], slot[kGroup];
  __shared__ int mv_dst[2 * kGroup], mv_src[2 * kGroup];
  __shared__ int pd[2 * kGroup], ps[2 * kGroup];
  __shared__ int moved;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kSwapWarps = kSwapThreads / 32;
  const int outside = cols - nb;           // columns [0, k0) and [k0 + nb, cols)

  for (int g0 = 0; g0 < nb; g0 += kGroup) {
    const int count = min(kGroup, nb - g0);
    __syncthreads();                       // the last group's move is done
    for (int t = tid; t < count; t += kSwapThreads) p[t] = piv[g0 + t];
    if (tid == 0) moved = 0;
    __syncthreads();
    net_move(p, count, k0 + g0, slot, mv_dst, mv_src);
    for (int s = tid; s < 2 * count; s += kSwapThreads) {
      if (mv_dst[s] >= 0 && mv_src[s] != mv_dst[s]) {
        const int k = atomicAdd(&moved, 1);
        pd[k] = mv_dst[s];
        ps[k] = mv_src[s];
      }
    }
    __syncthreads();
    const int np = moved;
    for (int c0 = blockIdx.x * kColTile; c0 < outside;
         c0 += gridDim.x * kColTile) {
      const int c = c0 + lane;
      const bool ok = c < outside;
      const int col = c < k0 ? c : c + nb;
      // 8 rows a warp in flight, so the loads keep HBM busy
#pragma unroll 8
      for (int k = warp; k < np; k += kSwapWarps)
        if (ok) tile[k * kColTile + lane] = a[(int64_t)ps[k] * lda + col];
      __syncthreads();
#pragma unroll 8
      for (int k = warp; k < np; k += kSwapWarps)
        if (ok) a[(int64_t)pd[k] * lda + col] = tile[k * kColTile + lane];
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" {

// Bytes of device memory panel_lu_launch needs as ``work`` for a panel of
// nb columns on ``device`` (any number of rows).
int64_t panel_lu_workspace(int nb, int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    return -1;
  return workspace_bytes(sms, nb);
}

// Factors the m x nb panel at ``a`` (row stride lda, in floats) in place
// and writes its pivots, as rows of the matrix (row0 + panel row), to
// piv[0..nb).  ``work`` holds panel_lu_workspace(nb) bytes.  Enqueues a
// memset and one cooperative launch on ``stream`` and returns the
// cudaError_t (0 on success); it does not synchronise.  m >= nb >= 1.
int panel_lu_launch(float* a, int64_t lda, int m, int nb, int row0, int* piv,
                    void* work, int64_t work_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nb < 1 || m < nb || lda < nb) return (int)cudaErrorInvalidValue;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  int blocks = (int)std::min<int64_t>(sms, (m + kRowsPerBlock - 1) / kRowsPerBlock);
  blocks = blocks < 1 ? 1 : blocks;
  const int rows = (m + blocks - 1) / blocks;
  const size_t smem = (size_t)rows * kLd * sizeof(float);
  if (work_bytes < workspace_bytes(sms, nb)) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(panel_lu_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, panel_lu_kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  char* wp = static_cast<char*>(work);
  unsigned* barrier = reinterpret_cast<unsigned*>(wp);
  float* cand_v = reinterpret_cast<float*>(wp + kBarrierBytes);
  int* cand_r = reinterpret_cast<int*>(cand_v + 2 * blocks);
  float* cand_rows = reinterpret_cast<float*>(cand_r + 2 * blocks);
  float* diag = cand_rows + 2 * blocks * kW;
  float* ubuf = diag + 2 * kW;
  err = cudaMemsetAsync(wp, 0, kBarrierBytes, s);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&a, &lda, &m, &nb, &row0, &piv, &barrier,
                  &cand_v, &cand_r, &cand_rows, &diag, &ubuf};
  err = cudaLaunchCooperativeKernel((const void*)panel_lu_kernel, dim3(blocks),
                                    dim3(kThreads), args, smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Applies the row swaps (k0 + j, piv[j]), j < nb, in order, to the columns
// [0, k0) and [k0 + nb, cols) of the matrix at ``a`` (row stride lda).
// Enqueues one launch on ``stream`` (none when there are no such columns)
// and returns the cudaError_t; it does not synchronise.
int laswp_launch(float* a, int64_t lda, int cols, int k0, int nb,
                 const int* piv, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nb < 1 || k0 < 0 || k0 + nb > cols || lda < cols)
    return (int)cudaErrorInvalidValue;
  const int outside = cols - nb;
  if (outside == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)2 * kGroup * kColTile * sizeof(float);
  err = cudaFuncSetAttribute(laswp_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, laswp_kernel,
                                                      kSwapThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (outside + kColTile - 1) / kColTile;
  const int blocks = std::min(tiles, std::max(per_sm, 1) * sms);
  laswp_kernel<<<blocks, kSwapThreads, smem, (cudaStream_t)stream>>>(
      a, lda, cols, k0, nb, piv);
  return (int)cudaGetLastError();
}

const char* panel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
