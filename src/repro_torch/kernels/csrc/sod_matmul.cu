// Fused Sparse-on-Dense matmul for Hopper: y = x @ decompress(W), W TiledCSC.
//
// Replaces the TPU kernel src/repro/kernels/sod_matmul.py:sod_matmul_pallas
// (body _sod_matmul_kernel, helpers _decompress_tile and _dequant_chunk), in
// every qmode: "none", "int8", "fp8" and "codebook".
//
// Layout.  W is cut into (bk, bn) tiles; vals[kt][nt][s][j] is slot s of
// column j of tile (kt, nt) and rows[kt][nt][s][j] its in-tile row (int8,
// -1 = padding).  Padding slots may sit between real slots, so every slot is
// visited; none is a stop marker.  Under a quantized qmode vals holds codes
// (int8, fp8 e4m3, or int8 indices into the layer's codebook) and the side
// band is scale[kt][nt] (int8, fp8) or codebook[ncodes] (codebook).
//
// What bounds it.  At decode (M = 4) each packed slot (2 bytes of bf16 value,
// or 1 byte of code, + 1 byte of row index) feeds 4 multiply-adds: far below
// the ~295 operations per byte at which an H100 stops being limited by HBM.
// The kernel is bound by the bytes of vals + rows; the aim is to read each
// packed byte once and to keep enough bytes in flight to fill the memory
// system.  A 1-byte code cuts those bytes by a third.
//
// What the design does about it.
//  * No dense tile.  The TPU kernel densifies each (bk, bn) tile because its
//    matrix unit only takes dense operands.  Here thread j owns column j of
//    the tile and, for each stored slot (r, v), adds v * x[m][r] into its M
//    accumulators, reading x[:, r] from shared memory.  That is the same sum
//    as x @ tile (every real slot once, f32 accumulation) with cap instead of
//    bk multiply-adds per column, and no shared-memory round trip of a tile.
//  * Dequantization per slot, at load.  The TPU kernel sums raw codes into
//    its dense tile and multiplies the finished tile by the tile's scale;
//    with no dense tile, each slot is dequantized as it is loaded (the value
//    paths of common.cuh): code * scale[kt][nt] in f32, or the codebook entry
//    from a 128-entry table staged in shared memory once per CTA.  Each
//    weight is then bit-equal to the plain version's dequantized weight.
//  * The dequantized weight stays f32.  The TPU kernel rounds its
//    dequantized tile to x's dtype before its dot (bf16 for bf16
//    activations); the plain version, which is the reference package's
//    oracle too, does not round, and this kernel follows the oracle.
//  * One CTA per (N tile, M block, K split).  A CTA stages its (bm, bk) slice
//    of x in shared memory (as f32, transposed so the bm values of one row are
//    one 16-byte load apart), then walks its slots 8 at a time so that 8
//    independent loads of vals and rows are in flight per thread.  Those
//    loads are pinned (load_pinned): left free, the compiler sank a slot's
//    value load into the padding branch, behind its row load, which in the
//    int8 build cost a second round trip per group.  At decode the whole M
//    is one block, so each packed byte is read once.
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
// The branch saves real work: at the tail of a tile column's slots whole
// warps hold padding.
template <int BM>
__device__ __forceinline__ void slot_fma(float (&acc)[BM], const float* xs, int r, float v) {
  if (r >= 0) row_fma<BM>(acc, xs, r, v);
}

template <typename TIn, typename TOut, int BM, typename Deq>
__global__ void sod_matmul_kernel(const TIn* __restrict__ x,
                                  const typename Deq::T* __restrict__ vals,
                                  const int8_t* __restrict__ rows,
                                  const float* __restrict__ scale,
                                  const float* __restrict__ codebook, TOut* __restrict__ out,
                                  float* __restrict__ partial, int m, int k, int n, int kt_total,
                                  int nt_total, int cap, int bk, int kt_per_split, int ncodes) {
  extern __shared__ __align__(16) float xs[];  // [bk][BM + 4]
  __shared__ float table[kMaxCodes];
  constexpr int LD = BM + 4;
  const int j = threadIdx.x;
  const int bn = blockDim.x;
  const int nt = blockIdx.x;
  const int m0 = blockIdx.y * BM;
  const int kt0 = blockIdx.z * kt_per_split;
  const int kt1 = min(kt0 + kt_per_split, kt_total);

  Deq deq;
  deq.begin(table, codebook, ncodes);  // the first tile's barriers publish it

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

    const size_t tile = (size_t)kt * nt_total + nt;
    deq.tile(scale, tile);
    const size_t base = tile * (size_t)cap * bn + j;
    const int8_t* rp = rows + base;
    const typename Deq::T* vp = vals + base;
    int s = 0;
    for (; s + 8 <= cap; s += 8) {
      int r[8];
      typename Deq::T c[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {  // all 16 loads issued before any is used
        r[u] = load_pinned(rp + (size_t)(s + u) * bn);
        c[u] = load_pinned(vp + (size_t)(s + u) * bn);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) slot_fma<BM>(acc, xs, r[u], deq(c[u]));
    }
    for (; s < cap; ++s) slot_fma<BM>(acc, xs, rp[(size_t)s * bn], deq(vp[(size_t)s * bn]));
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

struct Args {
  const void* x;
  const void* vals;
  const void* rows;
  const void* scale;
  const void* codebook;
  void* out;
  void* partial;
  int m, k, n, kt, nt, cap, bk, bn, splits, ncodes;
};

template <typename TIn, typename TOut, int BM, typename Deq>
int launch(const Args& a, cudaStream_t stream) {
  const int kt_per_split = (a.kt + a.splits - 1) / a.splits;
  const dim3 grid(a.nt, (a.m + BM - 1) / BM, a.splits);
  const size_t smem = (size_t)a.bk * (BM + 4) * sizeof(float);
  float* part = a.splits > 1 ? static_cast<float*>(a.partial) : nullptr;
  sod_matmul_kernel<TIn, TOut, BM, Deq><<<grid, a.bn, smem, stream>>>(
      static_cast<const TIn*>(a.x), static_cast<const typename Deq::T*>(a.vals),
      static_cast<const int8_t*>(a.rows), static_cast<const float*>(a.scale),
      static_cast<const float*>(a.codebook), static_cast<TOut*>(a.out), part, a.m, a.k, a.n,
      a.kt, a.nt, a.cap, a.bk, kt_per_split, a.ncodes);
  if (a.splits > 1) launch_reduce_splits<TOut>(part, a.out, a.splits, (size_t)a.m * a.n, stream);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (activations and output).  qmode
// codes: 0 = none (vals in the activations' dtype), 1 = int8 and 2 = fp8
// e4m3 (codes, with an f32 scale per (kt, nt) tile), 3 = codebook (int8
// indices into an f32 table of ncodes <= 128 entries).  scale and codebook
// are null where the qmode has none.  `partial` is an f32 buffer of
// splits * m * n elements when splits > 1 (unused otherwise).  Returns the
// cudaError_t of the launches (0 = success).
extern "C" int sod_matmul_launch(const void* x, const void* vals, const void* rows,
                                 const void* scale, const void* codebook, void* out,
                                 void* partial, int m, int k, int n, int kt, int nt, int cap,
                                 int bk, int bn, int splits, int in_dtype, int out_dtype,
                                 int qmode, int ncodes, void* stream) {
  if (m <= 0 || n <= 0 || kt <= 0 || nt <= 0 || cap <= 0 || bk <= 0 || bk > 128 ||
      bn <= 0 || bn > 1024 || bn % 32 != 0 || splits < 1 || splits > kt ||
      (m + 31) / 32 > 65535 || ((qmode == kInt8 || qmode == kFp8) && scale == nullptr) ||
      (qmode == kCodebook && (codebook == nullptr || ncodes < 1 || ncodes > kMaxCodes))) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{x, vals, rows, scale, codebook, out, partial, m, k, n, kt, nt, cap, bk, bn, splits,
               ncodes};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(in_dtype, out_dtype, qmode, [&](auto tin, auto tout, auto deq) -> int {
    using TIn = typename decltype(tin)::type;
    using TOut = typename decltype(tout)::type;
    using Deq = typename decltype(deq)::type;
    return m <= 8 ? launch<TIn, TOut, 8, Deq>(a, s) : launch<TIn, TOut, 32, Deq>(a, s);
  });
}
