// Block Sparse-on-Dense matmul for Hopper: y = x @ decompress(W), W BlockCSR.
//
// Replaces the TPU kernel src/repro/kernels/block_matmul.py:block_matmul_pallas
// (body _block_matmul_kernel), in every qmode: "none", "int8", "fp8" and
// "codebook".
//
// Layout.  W is cut into (bk, bn) macro tiles, each cut along K into
// (br, bn) sub-blocks.  block_vals[kt][nt][s] is stored sub-block s of tile
// (kt, nt), block_ids[kt][nt][s] its in-tile index (int32, -1 = padding),
// tile_nnz[kt][nt] the number stored.  The packer puts the stored sub-blocks
// first, so the ids are >= 0 exactly at s < tile_nnz: the kernel walks only
// those slots.  Under a quantized qmode block_vals holds codes (int8, fp8
// e4m3, or int8 codebook indices), with scale[kt][nt] per macro tile (int8,
// fp8) or the layer's codebook[ncodes] (codebook).
//
// What bounds it.  At decode (M = 4) each stored bf16 value feeds 4
// multiply-adds, far below the ~295 operations per byte at which an H100
// stops being limited by HBM.  The kernel is bound by the bytes of the
// stored sub-blocks, so it reads only the tile_nnz sub-blocks that are
// there, never the padding up to bcap, and each of them once at decode.
// A 1-byte code halves those bytes.
//
// What the design does about it.
//  * Empty macro tiles cost nothing.  tile_nnz is the same for the whole
//    CTA, so a tile with 0 is skipped before x is staged or a value read,
//    as the TPU kernel's pl.when(nnz > 0) skips its decompression and dot.
//  * No dense tile.  The TPU kernel densifies each macro tile into VMEM for
//    its matrix unit.  Here the CTA gathers, for its M block, the rows of x
//    that the stored sub-blocks select (row q of the gathered slice is
//    x[:, kt*bk + id[q / br]*br + q % br], zero for an id < 0), as f32 in
//    shared memory.  Thread j owns column j and adds
//    x_gathered[:, q] * block_vals[q][j] for q < tile_nnz * br: for a fixed
//    q the 128 threads read 256 contiguous bytes (bf16), and 16 such loads
//    are in flight per thread.  That is the same sum as x @ tile (f32
//    accumulation) with tile_nnz * br instead of bk multiply-adds a column.
//  * Dequantization per value, at load, as in sod_matmul.cu (the value
//    paths of common.cuh): code * the macro tile's f32 scale, or the entry
//    of the codebook staged in shared memory once per CTA.  The TPU kernel
//    instead sums the dequantized blocks into an f32 tile, scales it once,
//    and rounds it to x's dtype before its dot; this kernel keeps the f32
//    weight, as the plain version (the reference's oracle) does.
//  * One CTA per (N tile, M block, K split), split-K with f32 partials added
//    in split order by a second kernel, as in sod_matmul.cu.
//  * Not yet: wgmma on the gathered rows (K = tile_nnz * br, padded to 16)
//    for prefill-sized M, TMA or cp.async staging (later changes).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; plain C entry point, loaded with ctypes.

#include "common.cuh"

namespace {

constexpr int kInFlight = 16;  // loads of block_vals in flight per thread

template <typename TIn, typename TOut, int BM, typename Deq>
__global__ void block_matmul_kernel(const TIn* __restrict__ x,
                                    const typename Deq::T* __restrict__ bvals,
                                    const int* __restrict__ ids, const int* __restrict__ tile_nnz,
                                    const float* __restrict__ scale,
                                    const float* __restrict__ codebook, TOut* __restrict__ out,
                                    float* __restrict__ partial, int m, int k, int n,
                                    int kt_total, int nt_total, int bcap, int br, int bk,
                                    int kt_per_split, int ncodes) {
  extern __shared__ __align__(16) float xs[];  // [bk][BM + 4], the gathered rows of x
  __shared__ float table[kMaxCodes];
  constexpr int LD = BM + 4;
  const int j = threadIdx.x;
  const int bn = blockDim.x;
  const int nt = blockIdx.x;
  const int m0 = blockIdx.y * BM;
  const int kt0 = blockIdx.z * kt_per_split;
  const int kt1 = min(kt0 + kt_per_split, kt_total);

  Deq deq;
  deq.begin(table, codebook, ncodes);  // a non-empty tile's barriers publish it

  float acc[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) acc[i] = 0.f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const size_t tile = (size_t)kt * nt_total + nt;
    const int nnz = min(tile_nnz[tile], bcap);  // the same for every thread of the CTA
    if (nnz <= 0) continue;                      // an empty macro tile costs nothing
    const int nrows = nnz * br;
    const int* tid = ids + tile * bcap;
    __syncthreads();  // the previous tile's readers are done with xs
    for (int idx = threadIdx.x; idx < BM * nrows; idx += bn) {
      const int mm = idx / nrows, q = idx - mm * nrows;
      const int s = q / br;
      const int b = tid[s];
      const int row = m0 + mm, col = kt * bk + b * br + (q - s * br);
      xs[q * LD + mm] =
          (b >= 0 && row < m && col < k) ? to_f32(x[(size_t)row * k + col]) : 0.f;
    }
    __syncthreads();

    deq.tile(scale, tile);
    const typename Deq::T* vp = bvals + tile * (size_t)bcap * br * bn + j;
    int q = 0;
    for (; q + kInFlight <= nrows; q += kInFlight) {
      float v[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) v[u] = deq(vp[(size_t)(q + u) * bn]);
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) row_fma<BM>(acc, xs, q + u, v[u]);
    }
    for (; q < nrows; ++q) row_fma<BM>(acc, xs, q, deq(vp[(size_t)q * bn]));
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
  const void* bvals;
  const void* ids;
  const void* tile_nnz;
  const void* scale;
  const void* codebook;
  void* out;
  void* partial;
  int m, k, n, kt, nt, bcap, br, bk, bn, splits, ncodes;
};

template <typename TIn, typename TOut, int BM, typename Deq>
int launch(const Args& a, cudaStream_t stream) {
  const int kt_per_split = (a.kt + a.splits - 1) / a.splits;
  const dim3 grid(a.nt, (a.m + BM - 1) / BM, a.splits);
  const size_t smem = (size_t)a.bk * (BM + 4) * sizeof(float);
  float* part = a.splits > 1 ? static_cast<float*>(a.partial) : nullptr;
  block_matmul_kernel<TIn, TOut, BM, Deq><<<grid, a.bn, smem, stream>>>(
      static_cast<const TIn*>(a.x), static_cast<const typename Deq::T*>(a.bvals),
      static_cast<const int*>(a.ids), static_cast<const int*>(a.tile_nnz),
      static_cast<const float*>(a.scale), static_cast<const float*>(a.codebook),
      static_cast<TOut*>(a.out), part, a.m, a.k, a.n, a.kt, a.nt, a.bcap, a.br, a.bk,
      kt_per_split, a.ncodes);
  if (a.splits > 1) launch_reduce_splits<TOut>(part, a.out, a.splits, (size_t)a.m * a.n, stream);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (activations and output).  qmode
// codes: 0 = none (block_vals in the activations' dtype), 1 = int8 and
// 2 = fp8 e4m3 (codes, with an f32 scale per (kt, nt) macro tile),
// 3 = codebook (int8 indices into an f32 table of ncodes <= 128 entries).
// scale and codebook are null where the qmode has none.  `partial` is an f32
// buffer of splits * m * n elements when splits > 1 (unused otherwise).
// Returns the cudaError_t of the launches (0 = success).
extern "C" int block_matmul_launch(const void* x, const void* bvals, const void* ids,
                                   const void* tile_nnz, const void* scale,
                                   const void* codebook, void* out, void* partial, int m, int k,
                                   int n, int kt, int nt, int bcap, int br, int bk, int bn,
                                   int splits, int in_dtype, int out_dtype, int qmode,
                                   int ncodes, void* stream) {
  if (m <= 0 || n <= 0 || kt <= 0 || nt <= 0 || bcap <= 0 || br <= 0 || bk <= 0 || bk > 256 ||
      bk % br != 0 || bcap * br > bk || bn <= 0 || bn > 1024 || bn % 32 != 0 || splits < 1 ||
      splits > kt || (m + 31) / 32 > 65535 ||
      ((qmode == kInt8 || qmode == kFp8) && scale == nullptr) ||
      (qmode == kCodebook && (codebook == nullptr || ncodes < 1 || ncodes > kMaxCodes))) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{x, bvals, ids, tile_nnz, scale, codebook, out, partial, m, k, n, kt, nt, bcap, br,
               bk, bn, splits, ncodes};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(in_dtype, out_dtype, qmode, [&](auto tin, auto tout, auto deq) -> int {
    using TIn = typename decltype(tin)::type;
    using TOut = typename decltype(tout)::type;
    using Deq = typename decltype(deq)::type;
    return m <= 8 ? launch<TIn, TOut, 8, Deq>(a, s) : launch<TIn, TOut, 32, Deq>(a, s);
  });
}
