// Device helpers shared by the Sparse-on-Dense kernels: conversions between
// the storage types and f32, the value paths of the four qmodes (how a stored
// slot becomes its f32 weight), the dispatch of the C entry points' dtype and
// qmode codes onto template instantiations, the per-slot multiply-add over a
// staged slice of x, and the fixed-order reduction of split-K partial sums.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 v) { return static_cast<float>(v); }  // exact

// A read-only global load issued where the source puts it: asm volatile is
// neither moved across other asm volatile nor sunk into a branch that uses
// its result, so a group of loads goes out together, before any is used.
__device__ __forceinline__ unsigned ld_nc_u8(const void* p) {
  unsigned v;
  asm volatile("ld.global.nc.u8 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ unsigned ld_nc_u16(const void* p) {
  unsigned short v;
  asm volatile("ld.global.nc.u16 %0, [%1];" : "=h"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ unsigned ld_nc_u32(const void* p) {
  unsigned v;
  asm volatile("ld.global.nc.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ int8_t load_pinned(const int8_t* p) {
  return static_cast<int8_t>(ld_nc_u8(p));
}
__device__ __forceinline__ __nv_fp8_e4m3 load_pinned(const __nv_fp8_e4m3* p) {
  __nv_fp8_e4m3 v;
  v.__x = static_cast<__nv_fp8_storage_t>(ld_nc_u8(p));
  return v;
}
__device__ __forceinline__ __nv_bfloat16 load_pinned(const __nv_bfloat16* p) {
  __nv_bfloat16_raw raw;
  raw.x = static_cast<unsigned short>(ld_nc_u16(p));
  return __nv_bfloat16(raw);
}
__device__ __forceinline__ float load_pinned(const float* p) {
  return __uint_as_float(ld_nc_u32(p));
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// qmode codes of the C entry points, as the wrappers pass them.
enum QMode { kNone = 0, kInt8 = 1, kFp8 = 2, kCodebook = 3 };
constexpr int kMaxCodes = 128;  // int8 codebook indices address at most 128 entries

// The value paths.  Each has the stored type T; begin(), which every thread
// of a CTA calls once before a __syncthreads(); tile(), called when the CTA
// moves to tile t of the (Kt, Nt) grid; and operator(), which turns one
// stored slot into its f32 weight.  The weight is bit-equal to the plain
// version's dequantized value (formats._dequant_values): one f32 multiply
// code * scale, or the table entry.  Padding holds code 0, which is 0.0 in
// every mode.
template <typename TV>
struct Plain {  // qmode "none": the stored value itself
  using T = TV;
  __device__ __forceinline__ void begin(float*, const float*, int) {}
  __device__ __forceinline__ void tile(const float*, size_t) {}
  __device__ __forceinline__ float operator()(TV v) const { return to_f32(v); }
};

template <typename TC>
struct Scaled {  // "int8" and "fp8": the code times its tile's f32 scale
  using T = TC;
  float s = 1.f;
  __device__ __forceinline__ void begin(float*, const float*, int) {}
  __device__ __forceinline__ void tile(const float* scale, size_t t) { s = scale[t]; }
  __device__ __forceinline__ float operator()(TC c) const { return __fmul_rn(to_f32(c), s); }
};

struct Codebook {  // "codebook": the entry of the layer's shared-value table
  using T = int8_t;
  const float* table = nullptr;
  // Stages the table into shared memory once per CTA, zero past ncodes, so
  // that every int8 code (masked to 7 bits) reads inside it.
  __device__ __forceinline__ void begin(float* smem, const float* codebook, int ncodes) {
    for (int i = threadIdx.x; i < kMaxCodes; i += blockDim.x) smem[i] = i < ncodes ? codebook[i] : 0.f;
    table = smem;
  }
  __device__ __forceinline__ void tile(const float*, size_t) {}
  __device__ __forceinline__ float operator()(int8_t c) const { return table[c & (kMaxCodes - 1)]; }
};

template <typename T>
struct Type {
  using type = T;
};

// Calls f(Type<TIn>{}, Type<TOut>{}, Type<Deq>{}) for the dtype codes of the
// activations and of the output (0 = float32, 1 = bfloat16) and the qmode
// code; under qmode "none" the stored values have the activations' type.
// Returns cudaErrorInvalidValue for a code out of range, else what f returns.
template <typename F>
int dispatch(int in_dtype, int out_dtype, int qmode, F&& f) {
  if (in_dtype < 0 || in_dtype > 1 || out_dtype < 0 || out_dtype > 1 || qmode < kNone ||
      qmode > kCodebook) {
    return (int)cudaErrorInvalidValue;
  }
  auto with_in = [&](auto tin) -> int {
    using TIn = typename decltype(tin)::type;
    auto with_out = [&](auto tout) -> int {
      switch (qmode) {
        case kInt8:
          return f(tin, tout, Type<Scaled<int8_t>>{});
        case kFp8:
          return f(tin, tout, Type<Scaled<__nv_fp8_e4m3>>{});
        case kCodebook:
          return f(tin, tout, Type<Codebook>{});
        default:
          return f(tin, tout, Type<Plain<TIn>>{});
      }
    };
    return out_dtype == 0 ? with_out(Type<float>{}) : with_out(Type<__nv_bfloat16>{});
  };
  return in_dtype == 0 ? with_in(Type<float>{}) : with_in(Type<__nv_bfloat16>{});
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

// Bulk copies from global into shared memory that complete on an mbarrier
// (Hopper's cp.async.bulk, the TMA's raw-bytes mode: one thread asks for the
// copy, the hardware moves the bytes and counts them off the barrier).
// Source and destination must be 16-byte aligned and the size a multiple of
// 16.  A barrier completes a phase when its one expected arrival
// (arrive_expect_tx) has come and every byte it was told to expect has
// landed; waiters name the phase by its parity.
namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread initialises; the fence makes the barrier visible to the copy
// engine, and a __syncthreads() before any other thread waits on it.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(arrivals)
               : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrive once and add `bytes` to the phase's expected transaction count.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of the given parity has completed; the bytes of its
// copies are then visible to the calling thread.  A phase that has not
// completed after 2^26 polls (seconds; a slab lands in microseconds) can
// only mean a wrong byte count: the kernel traps, and the launch fails
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// dst (shared) <- src (global), `bytes` of them, completing on `bar`.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

}  // namespace
