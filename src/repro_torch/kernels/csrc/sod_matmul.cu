// Fused Sparse-on-Dense matmul for Hopper: y = x @ decompress(W), W TiledCSC.
//
// Replaces the TPU kernel src/repro/kernels/sod_matmul.py:sod_matmul_pallas
// (body _sod_matmul_kernel, helper _decompress_tile), for qmode "none".
//
// Layout.  W is cut into (bk, bn) tiles; vals[kt][nt][s][j] is slot s of
// column j of tile (kt, nt) and rows[kt][nt][s][j] its in-tile row (int8,
// -1 = padding).  Padding slots may sit between real slots, so every slot is
// visited; none is a stop marker.
//
// What bounds it.  At decode (M = 4) each packed slot (2 bytes of value +
// 1 byte of row index) feeds 4 multiply-adds: far below the ~295 operations
// per byte at which an H100 stops being limited by HBM.  The kernel is bound
// by the bytes of vals + rows; the aim is to read each packed byte once and
// to keep enough bytes in flight to fill the memory system.
//
// What the design does about it.
//  * No dense tile.  The TPU kernel densifies each (bk, bn) tile because its
//    matrix unit only takes dense operands.  Here thread j owns column j of
//    the tile and, for each stored slot (r, v), adds v * x[m][r] into its M
//    accumulators, reading x[:, r] from shared memory.  That is the same sum
//    as x @ tile (every real slot once, f32 accumulation) with cap instead of
//    bk multiply-adds per column, and no shared-memory round trip of a tile.
//  * One CTA per (N tile, M block, K split).  A CTA stages its (bm, bk) slice
//    of x in shared memory (as f32, transposed so the bm values of one row are
//    one 16-byte load apart), then walks its slots 8 at a time so that 8
//    independent loads of vals and rows are in flight per thread.  At decode
//    the whole M is one block, so each packed byte is read once.
//  * Split-K.  The TPU grid walks K sequentially inside one core; on Hopper a
//    small N (wq: 16 tiles) gives far fewer CTAs than the 132 SMs.  The
//    wrapper splits the K tiles over gridDim.z so that about two CTAs per SM
//    run; each split writes f32 partial sums, and a second kernel adds them
//    in split order (deterministic) and casts to the output type.
//  * Not yet: wgmma on a densified tile for prefill-sized M, TMA or cp.async
//    staging, a persistent schedule (later changes).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; plain C entry point, loaded with ctypes.

#include "common.cuh"

namespace {

// acc[m] += v * x[m][r] for a stored slot (r, v) of the tile; r < 0 is padding.
template <int BM>
__device__ __forceinline__ void slot_fma(float (&acc)[BM], const float* xs, int r, float v) {
  if (r >= 0) row_fma<BM>(acc, xs, r, v);
}

template <typename TIn, typename TOut, int BM>
__global__ void sod_matmul_kernel(const TIn* __restrict__ x, const TIn* __restrict__ vals,
                                  const int8_t* __restrict__ rows, TOut* __restrict__ out,
                                  float* __restrict__ partial, int m, int k, int n, int kt_total,
                                  int nt_total, int cap, int bk, int kt_per_split) {
  extern __shared__ __align__(16) float xs[];  // [bk][BM + 4]
  constexpr int LD = BM + 4;
  const int j = threadIdx.x;
  const int bn = blockDim.x;
  const int nt = blockIdx.x;
  const int m0 = blockIdx.y * BM;
  const int kt0 = blockIdx.z * kt_per_split;
  const int kt1 = min(kt0 + kt_per_split, kt_total);

  float acc[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) acc[i] = 0.f;

  for (int kt = kt0; kt < kt1; ++kt) {
    __syncthreads();  // the previous tile's readers are done with xs
    for (int idx = threadIdx.x; idx < BM * bk; idx += bn) {
      const int mm = idx / bk, r = idx - mm * bk;  // neighbours read neighbouring columns of x
      const int row = m0 + mm, col = kt * bk + r;
      xs[r * LD + mm] = (row < m && col < k) ? to_f32(x[(size_t)row * k + col]) : 0.f;
    }
    __syncthreads();

    const size_t base = ((size_t)kt * nt_total + nt) * (size_t)cap * bn + j;
    const int8_t* rp = rows + base;
    const TIn* vp = vals + base;
    int s = 0;
    for (; s + 8 <= cap; s += 8) {
      int r[8];
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        r[u] = rp[(size_t)(s + u) * bn];
        v[u] = to_f32(vp[(size_t)(s + u) * bn]);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) slot_fma<BM>(acc, xs, r[u], v[u]);
    }
    for (; s < cap; ++s) slot_fma<BM>(acc, xs, rp[(size_t)s * bn], to_f32(vp[(size_t)s * bn]));
  }

  const int col = nt * bn + j;
  if (col >= n) return;
#pragma unroll
  for (int i = 0; i < BM; ++i) {
    const int row = m0 + i;
    if (row >= m) break;
    if (partial != nullptr) {
      partial[((size_t)blockIdx.z * m + row) * n + col] = acc[i];
    } else {
      out[(size_t)row * n + col] = from_f32<TOut>(acc[i]);
    }
  }
}

template <typename TIn, typename TOut, int BM>
void launch(const void* x, const void* vals, const void* rows, void* out, void* partial, int m,
            int k, int n, int kt, int nt, int cap, int bk, int bn, int splits,
            cudaStream_t stream) {
  const int kt_per_split = (kt + splits - 1) / splits;
  const dim3 grid(nt, (m + BM - 1) / BM, splits);
  const size_t smem = (size_t)bk * (BM + 4) * sizeof(float);
  float* part = splits > 1 ? static_cast<float*>(partial) : nullptr;
  sod_matmul_kernel<TIn, TOut, BM><<<grid, bn, smem, stream>>>(
      static_cast<const TIn*>(x), static_cast<const TIn*>(vals),
      static_cast<const int8_t*>(rows), static_cast<TOut*>(out), part, m, k, n, kt, nt, cap, bk,
      kt_per_split);
  if (splits > 1) launch_reduce_splits<TOut>(part, out, splits, (size_t)m * n, stream);
}

template <typename TIn, typename TOut>
void launch_bm(const void* x, const void* vals, const void* rows, void* out, void* partial, int m,
               int k, int n, int kt, int nt, int cap, int bk, int bn, int splits,
               cudaStream_t stream) {
  if (m <= 8) {
    launch<TIn, TOut, 8>(x, vals, rows, out, partial, m, k, n, kt, nt, cap, bk, bn, splits,
                         stream);
  } else {
    launch<TIn, TOut, 32>(x, vals, rows, out, partial, m, k, n, kt, nt, cap, bk, bn, splits,
                          stream);
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  `partial` is an f32 buffer of
// splits * m * n elements when splits > 1 (unused otherwise).  Returns the
// cudaError_t of the launches (0 = success).
extern "C" int sod_matmul_launch(const void* x, const void* vals, const void* rows, void* out,
                                 void* partial, int m, int k, int n, int kt, int nt, int cap,
                                 int bk, int bn, int splits, int in_dtype, int out_dtype,
                                 void* stream) {
  if (m <= 0 || n <= 0 || kt <= 0 || nt <= 0 || cap <= 0 || bk <= 0 || bk > 128 ||
      bn <= 0 || bn > 1024 || bn % 32 != 0 || splits < 1 || splits > kt ||
      (m + 31) / 32 > 65535 || in_dtype < 0 || in_dtype > 1 || out_dtype < 0 || out_dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0) {
    launch_bm<float, float>(x, vals, rows, out, partial, m, k, n, kt, nt, cap, bk, bn, splits, s);
  } else if (in_dtype == 0) {
    launch_bm<float, __nv_bfloat16>(x, vals, rows, out, partial, m, k, n, kt, nt, cap, bk, bn,
                                    splits, s);
  } else if (out_dtype == 0) {
    launch_bm<__nv_bfloat16, float>(x, vals, rows, out, partial, m, k, n, kt, nt, cap, bk, bn,
                                    splits, s);
  } else {
    launch_bm<__nv_bfloat16, __nv_bfloat16>(x, vals, rows, out, partial, m, k, n, kt, nt, cap,
                                            bk, bn, splits, s);
  }
  return (int)cudaGetLastError();
}
