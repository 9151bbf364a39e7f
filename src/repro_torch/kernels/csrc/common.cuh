// Device helpers shared by the Sparse-on-Dense matmul kernels: conversions
// between the storage types and f32, the per-slot multiply-add over a staged
// slice of x, and the fixed-order reduction of split-K partial sums.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// acc[m] += v * xs[r][m] for the BM rows of a staged x slice whose rows are
// BM + 4 floats apart (the padding keeps each row 16-byte aligned).
template <int BM>
__device__ __forceinline__ void row_fma(float (&acc)[BM], const float* xs, int r, float v) {
  const float4* xr = reinterpret_cast<const float4*>(xs + r * (BM + 4));
#pragma unroll
  for (int q = 0; q < BM / 4; ++q) {
    const float4 xv = xr[q];
    acc[4 * q + 0] += xv.x * v;
    acc[4 * q + 1] += xv.y * v;
    acc[4 * q + 2] += xv.z * v;
    acc[4 * q + 3] += xv.w * v;
  }
}

// out[i] = sum over splits, in split order, of partial[z][i].
template <typename TOut>
__global__ void reduce_splits_kernel(const float* __restrict__ partial, TOut* __restrict__ out,
                                     int splits, size_t mn) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * mn + i];
  out[i] = from_f32<TOut>(s);
}

template <typename TOut>
void launch_reduce_splits(const float* partial, void* out, int splits, size_t mn,
                          cudaStream_t stream) {
  reduce_splits_kernel<TOut><<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
      partial, static_cast<TOut*>(out), splits, mn);
}

}  // namespace
