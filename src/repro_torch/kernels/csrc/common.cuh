// Device helpers shared by the Sparse-on-Dense kernels: conversions between
// the storage types and f32, the value paths of the four qmodes (how a stored
// slot becomes its f32 weight), the dispatch of the C entry points' dtype and
// qmode codes onto template instantiations, the multiply-add of one weight
// into a row of staged x, bulk copies into shared memory on mbarriers, the
// launch configuration of a kernel with a large ring, and split-K reduced
// inside the launch.
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

namespace {

constexpr int kMaxStages = 8;          // stages of a kernel's ring of slabs
constexpr int kSmemPerBlock = 232448;  // 227 KB: the most one CTA may hold on an H100
constexpr int kMaxDevices = 64;

// acc[m] += v * xr[m] for the BM values of one row of a staged x slice,
// held in x's own dtype: one 16-byte shared-memory load per four f32 or
// eight bf16 values (an 8-byte load for four bf16).  A bf16 value widens to
// f32 exactly (a shift), so the products are those of the f32 slice.
template <int BM>
__device__ __forceinline__ void row_fma_x(float (&acc)[BM], const float* row, float v) {
  const float4* xr = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int q = 0; q < BM / 4; ++q) {
    const float4 xv = xr[q];
    acc[4 * q + 0] += xv.x * v;
    acc[4 * q + 1] += xv.y * v;
    acc[4 * q + 2] += xv.z * v;
    acc[4 * q + 3] += xv.w * v;
  }
}
__device__ __forceinline__ void bf16x2_fma(float& lo, float& hi, uint32_t w, float v) {
  lo += __uint_as_float(w << 16) * v;
  hi += __uint_as_float(w & 0xffff0000u) * v;
}
template <int BM>
__device__ __forceinline__ void row_fma_x(float (&acc)[BM], const __nv_bfloat16* row, float v) {
  if constexpr (BM == 4) {
    const uint2 w = *reinterpret_cast<const uint2*>(row);
    bf16x2_fma(acc[0], acc[1], w.x, v);
    bf16x2_fma(acc[2], acc[3], w.y, v);
  } else {
    const uint4* xr = reinterpret_cast<const uint4*>(row);
#pragma unroll
    for (int q = 0; q < BM / 8; ++q) {
      const uint4 w = xr[q];
      bf16x2_fma(acc[8 * q + 0], acc[8 * q + 1], w.x, v);
      bf16x2_fma(acc[8 * q + 2], acc[8 * q + 3], w.y, v);
      bf16x2_fma(acc[8 * q + 4], acc[8 * q + 5], w.z, v);
      bf16x2_fma(acc[8 * q + 6], acc[8 * q + 7], w.w, v);
    }
  }
}

// Raise the kernel's dynamic shared memory limit to what a CTA may hold and
// prefer the largest shared-memory carveout, once per device (`done` is the
// instantiation's own record).
template <typename K>
cudaError_t configure(K kernel, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < kMaxDevices && done[dev])) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kernel);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemPerBlock - (int)attr.sharedSizeBytes);
  }
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  }
  if (e == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return e;
}

// A fence at device scope with acquire-release semantics.  After a
// __syncthreads(), one thread's fence releases (or, after an atomic that
// observed the other CTAs' arrivals, acquires) the writes of the whole CTA,
// as CUTLASS's split-K barrier does: cheaper than a sequentially consistent
// __threadfence() in every thread.
__device__ __forceinline__ void fence_acq_rel_gpu() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

// The end of a CTA of a split-K launch (one CTA per (N tile, M block, K
// split); a thread owns output columns col0 .. col0 + CP - 1, some of which
// may lie past n, and acc[c][i] is its sum for column col0 + c and row
// m0 + i).  With one split (partial == nullptr) the sums are the output.
// Otherwise each CTA writes its f32 partials, releases them and bumps the
// arrival counter `slot` of its (N tile, M block); the CTA that arrives last
// sums partial[0..splits-1] in split order (deterministic, whichever CTA is
// last), reading them through L2 (__ldcg: L1 is not coherent), casts to the
// output type, and resets the counter to 0 for the next launch on the
// stream.  At BM <= 8 the loads of 64 / BM splits of the BM rows go out
// together; at BM = 32 a row at a time (batching 32 rows' loads doubled the
// time of a 2048 x 512 prefill).  Every thread of the CTA calls it.
template <int BM, int CP, typename TOut>
__device__ __forceinline__ void finish_splits(const float (&acc)[CP][BM],
                                              TOut* __restrict__ out,
                                              float* __restrict__ partial,
                                              int* __restrict__ counters, int m, int n, int m0,
                                              int col0, int slot) {
  __shared__ int last;
  if (partial == nullptr) {
#pragma unroll
    for (int c = 0; c < CP; ++c) {
      if (col0 + c >= n) break;
#pragma unroll
      for (int i = 0; i < BM; ++i) {
        if (m0 + i < m) out[(size_t)(m0 + i) * n + col0 + c] = from_f32<TOut>(acc[c][i]);
      }
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < CP; ++c) {
    if (col0 + c >= n) break;
#pragma unroll
    for (int i = 0; i < BM; ++i) {
      if (m0 + i < m) partial[((size_t)blockIdx.z * m + m0 + i) * n + col0 + c] = acc[c][i];
    }
  }
  __syncthreads();  // every thread's partials are written; thread 0 releases them
  if (threadIdx.x == 0) {
    fence_acq_rel_gpu();
    last = atomicAdd(&counters[slot], 1) == (int)gridDim.z - 1;
    if (last) fence_acq_rel_gpu();  // acquires every other CTA's partials
  }
  __syncthreads();
  if (!last) return;
#pragma unroll
  for (int c = 0; c < CP; ++c) {
    const int col = col0 + c;
    if (col >= n) break;
    if constexpr (BM <= 8) {
      constexpr int kZ = 64 / BM;  // splits whose loads go out together
      float sum[BM];
#pragma unroll
      for (int i = 0; i < BM; ++i) sum[i] = 0.f;
      for (int z0 = 0; z0 < (int)gridDim.z; z0 += kZ) {
        float v[kZ][BM];
#pragma unroll
        for (int z = 0; z < kZ; ++z) {
#pragma unroll
          for (int i = 0; i < BM; ++i) {
            v[z][i] = z0 + z < (int)gridDim.z && m0 + i < m
                          ? __ldcg(&partial[((size_t)(z0 + z) * m + m0 + i) * n + col])
                          : 0.f;
          }
        }
#pragma unroll
        for (int z = 0; z < kZ; ++z) {
#pragma unroll
          for (int i = 0; i < BM; ++i) sum[i] += v[z][i];
        }
      }
#pragma unroll
      for (int i = 0; i < BM; ++i) {
        if (m0 + i < m) out[(size_t)(m0 + i) * n + col] = from_f32<TOut>(sum[i]);
      }
    } else {
      for (int i = 0; i < BM; ++i) {
        const int row = m0 + i;
        if (row >= m) break;
        float sum = 0.f;
        for (int z = 0; z < (int)gridDim.z; ++z) sum += __ldcg(&partial[((size_t)z * m + row) * n + col]);
        out[(size_t)row * n + col] = from_f32<TOut>(sum);
      }
    }
  }
  if (threadIdx.x == 0) counters[slot] = 0;  // ready for the next launch on this stream
}

// The same for a thread that owns one column.
template <int BM, typename TOut>
__device__ __forceinline__ void finish_splits(const float (&acc)[BM], TOut* __restrict__ out,
                                              float* __restrict__ partial,
                                              int* __restrict__ counters, int m, int n, int m0,
                                              int col, int slot) {
  finish_splits<BM, 1>(reinterpret_cast<const float(&)[1][BM]>(acc), out, partial, counters, m,
                       n, m0, col, slot);
}

}  // namespace
