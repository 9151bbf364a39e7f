// Standalone decompression unit for Hopper: the dense (K, N) matrix of a
// TiledCSC operand.
//
// Replaces the TPU kernel src/repro/kernels/decompress.py:decompress_pallas
// (body _decompress_kernel, via sod_matmul.py:_decompress_tile), for qmode
// "none".  The TPU kernel writes the padded (Kp, Np) matrix; this one writes
// the logical (K, N) matrix directly, masking the ragged edge as
// sod_matmul.cu does.
//
// Layout.  vals[kt][nt][s][j] is slot s of column j of tile (kt, nt) and
// rows[kt][nt][s][j] its in-tile row (int8, -1 = padding).  Padding may sit
// between real slots, so every slot is visited; none is a stop marker.
//
// What bounds it.  No arithmetic: the bytes of vals + rows read and of the
// dense matrix written, and the dense write is the larger (K * N values
// against cap * N slots at density 0.3).
//
// What the design does about it.  One CTA per (N tile, K tile), thread j
// owning column j of the tile.  It zeroes its column of a (bk, bn) tile in
// shared memory, places each real slot of its column there (one value
// placed once, moved as raw bits, so the result is bit-equal to the
// scatter of TiledCSC.to_dense), then writes the column out row by row: for
// a fixed row the warp's 32 threads write 32 neighbouring values.  The slots
// are read 8 at a time, so 8 loads of rows and of vals are in flight per
// thread.  Each thread touches only its own column, so the phases need no
// barrier.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; plain C entry point, loaded with ctypes.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr size_t kMaxSmem = 232448;  // bytes of shared memory a block may use on sm_90
constexpr int kInFlight = 8;         // slots whose loads are in flight per thread

// W is the value's bit pattern: uint16_t for bfloat16, uint32_t for float32.
template <typename W>
__global__ void decompress_kernel(const W* __restrict__ vals, const int8_t* __restrict__ rows,
                                  W* __restrict__ out, int k, int n, int nt_total, int cap,
                                  int bk) {
  extern __shared__ __align__(16) unsigned char smem[];
  W* tile = reinterpret_cast<W*>(smem);  // [bk][bn]
  const int j = threadIdx.x;
  const int bn = blockDim.x;
  const int nt = blockIdx.x;
  const int kt = blockIdx.y;

  for (int r = 0; r < bk; ++r) tile[r * bn + j] = W(0);
  const int8_t* rp = rows + ((size_t)kt * nt_total + nt) * (size_t)cap * bn + j;
  const W* vp = vals + (rp - rows);
  int s = 0;
  for (; s + kInFlight <= cap; s += kInFlight) {
    int r[kInFlight];
    W v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      r[u] = rp[(size_t)(s + u) * bn];
      v[u] = vp[(size_t)(s + u) * bn];
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      if (r[u] >= 0) tile[r[u] * bn + j] = v[u];
    }
  }
  for (; s < cap; ++s) {
    const int r = rp[(size_t)s * bn];
    if (r >= 0) tile[r * bn + j] = vp[(size_t)s * bn];
  }

  const int col = nt * bn + j;
  if (col >= n) return;
  const int row0 = kt * bk;
  const int rend = min(bk, k - row0);
  for (int r = 0; r < rend; ++r) out[(size_t)(row0 + r) * n + col] = tile[r * bn + j];
}

template <typename W>
int launch(const void* vals, const void* rows, void* out, int k, int n, int kt, int nt, int cap,
           int bk, int bn, cudaStream_t stream) {
  const size_t smem = (size_t)bk * bn * sizeof(W);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(decompress_kernel<W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decompress_kernel<W><<<dim3(nt, kt), bn, smem, stream>>>(
      static_cast<const W*>(vals), static_cast<const int8_t*>(rows), static_cast<W*>(out), k, n,
      nt, cap, bk);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  `out` is a contiguous (k, n)
// buffer of the value dtype.  Returns the cudaError_t of the launch
// (0 = success).
extern "C" int decompress_launch(const void* vals, const void* rows, void* out, int k, int n,
                                 int kt, int nt, int cap, int bk, int bn, int dtype,
                                 void* stream) {
  if (k <= 0 || n <= 0 || kt <= 0 || nt <= 0 || cap <= 0 || bk <= 0 || bk > 128 || bn <= 0 ||
      bn > 1024 || bn % 32 != 0 || kt > 65535 || k > kt * bk || n > nt * bn || dtype < 0 ||
      dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<uint32_t>(vals, rows, out, k, n, kt, nt, cap, bk, bn, s)
                    : launch<uint16_t>(vals, rows, out, k, n, kt, nt, cap, bk, bn, s);
}
