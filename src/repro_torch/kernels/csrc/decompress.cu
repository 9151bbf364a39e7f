// Standalone decompression unit for Hopper: the dense (K, N) matrix of a
// TiledCSC operand.
//
// Replaces the TPU kernel src/repro/kernels/decompress.py:decompress_pallas
// (body _decompress_kernel, via sod_matmul.py:_decompress_tile and
// _dequant_chunk), in every qmode.  The TPU kernel writes the padded
// (Kp, Np) matrix; this one writes the logical (K, N) matrix directly,
// masking the ragged edge as sod_matmul.cu does.  As the TPU kernel, it takes
// an output dtype: the value dtype by default, float32 for a quantized
// operand (the stored codes are not values).
//
// Layout.  vals[kt][nt][s][j] is slot s of column j of tile (kt, nt) and
// rows[kt][nt][s][j] its in-tile row (int8, -1 = padding).  Padding may sit
// between real slots, so every slot is visited; none is a stop marker.
// Under a quantized qmode vals holds codes, dequantized through scale[kt][nt]
// (int8, fp8) or the layer's codebook (codebook).
//
// What bounds it.  No arithmetic: the bytes of vals + rows read and of the
// dense matrix written, and the dense write is the larger (K * N values
// against cap * N slots at density 0.3; 4 bytes a value for the f32 output
// of a quantized operand).
//
// What the design does about it.  One CTA per (N tile, K tile), thread j
// owning column j of the tile.  It zeroes its column of a (bk, bn) tile in
// shared memory, places each real slot of its column there, then writes the
// column out row by row: for a fixed row the warp's 32 threads write 32
// neighbouring values.  The slots are read 8 at a time, so 8 loads of rows
// and of vals are in flight per thread.  Each thread touches only its own
// column, so the phases need no barrier (one barrier publishes a staged
// codebook).
//
// Bit-equal to the plain version (TiledCSC.to_dense, the reference's scatter
// oracle).  Each slot is dequantized by the value paths of common.cuh (the
// stored value, one f32 multiply code * scale, or the table entry), added
// to +0.0 as the scatter adds it to its zeroed matrix (which turns a -0.0
// code into +0.0), and converted once to the output dtype: exact for f32
// and for bf16 values kept in bf16, round to nearest even otherwise, as
// torch's cast of the plain version.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; plain C entry point, loaded with ctypes.

#include "common.cuh"

namespace {

constexpr size_t kMaxSmem = 232448;  // bytes of shared memory a block may use on sm_90
constexpr int kInFlight = 8;         // slots whose loads are in flight per thread

template <typename TOut, typename Deq>
__global__ void decompress_kernel(const typename Deq::T* __restrict__ vals,
                                  const int8_t* __restrict__ rows,
                                  const float* __restrict__ scale,
                                  const float* __restrict__ codebook, TOut* __restrict__ out,
                                  int k, int n, int nt_total, int cap, int bk, int ncodes) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float table[kMaxCodes];
  TOut* tile = reinterpret_cast<TOut*>(smem);  // [bk][bn]
  const int j = threadIdx.x;
  const int bn = blockDim.x;
  const int nt = blockIdx.x;
  const int kt = blockIdx.y;
  const size_t t = (size_t)kt * nt_total + nt;

  Deq deq;
  deq.begin(table, codebook, ncodes);
  __syncthreads();
  deq.tile(scale, t);

  const TOut zero = from_f32<TOut>(0.f);
  for (int r = 0; r < bk; ++r) tile[r * bn + j] = zero;
  const int8_t* rp = rows + t * (size_t)cap * bn + j;
  const typename Deq::T* vp = vals + (rp - rows);
  int s = 0;
  for (; s + kInFlight <= cap; s += kInFlight) {
    int r[kInFlight];
    float v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      r[u] = rp[(size_t)(s + u) * bn];
      v[u] = deq(vp[(size_t)(s + u) * bn]);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      if (r[u] >= 0) tile[r[u] * bn + j] = from_f32<TOut>(__fadd_rn(0.f, v[u]));
    }
  }
  for (; s < cap; ++s) {
    const int r = rp[(size_t)s * bn];
    if (r >= 0) tile[r * bn + j] = from_f32<TOut>(__fadd_rn(0.f, deq(vp[(size_t)s * bn])));
  }

  const int col = nt * bn + j;
  if (col >= n) return;
  const int row0 = kt * bk;
  const int rend = min(bk, k - row0);
  for (int r = 0; r < rend; ++r) out[(size_t)(row0 + r) * n + col] = tile[r * bn + j];
}

template <typename TOut, typename Deq>
int launch(const void* vals, const void* rows, const void* scale, const void* codebook,
           void* out, int k, int n, int kt, int nt, int cap, int bk, int bn, int ncodes,
           cudaStream_t stream) {
  const size_t smem = (size_t)bk * bn * sizeof(TOut);
  if (smem > kMaxSmem - kMaxCodes * sizeof(float)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(decompress_kernel<TOut, Deq>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decompress_kernel<TOut, Deq><<<dim3(nt, kt), bn, smem, stream>>>(
      static_cast<const typename Deq::T*>(vals), static_cast<const int8_t*>(rows),
      static_cast<const float*>(scale), static_cast<const float*>(codebook),
      static_cast<TOut*>(out), k, n, nt, cap, bk, ncodes);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; `val_dtype` is the stored value
// dtype under qmode 0 (none) and is ignored otherwise, `out_dtype` the dtype
// of `out`, a contiguous (k, n) buffer.  qmode codes: 1 = int8 and 2 = fp8
// e4m3 (codes, with an f32 scale per tile), 3 = codebook (int8 indices into
// an f32 table of ncodes <= 128 entries); scale and codebook are null where
// the qmode has none.  Returns the cudaError_t of the launch (0 = success).
extern "C" int decompress_launch(const void* vals, const void* rows, const void* scale,
                                 const void* codebook, void* out, int k, int n, int kt, int nt,
                                 int cap, int bk, int bn, int val_dtype, int out_dtype,
                                 int qmode, int ncodes, void* stream) {
  if (k <= 0 || n <= 0 || kt <= 0 || nt <= 0 || cap <= 0 || bk <= 0 || bk > 128 || bn <= 0 ||
      bn > 1024 || bn % 32 != 0 || kt > 65535 || k > kt * bk || n > nt * bn ||
      ((qmode == kInt8 || qmode == kFp8) && scale == nullptr) ||
      (qmode == kCodebook && (codebook == nullptr || ncodes < 1 || ncodes > kMaxCodes))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(val_dtype, out_dtype, qmode, [&](auto, auto tout, auto deq) -> int {
    using TOut = typename decltype(tout)::type;
    using Deq = typename decltype(deq)::type;
    return launch<TOut, Deq>(vals, rows, scale, codebook, out, k, n, kt, nt, cap, bk, bn, ncodes,
                             s);
  });
}
