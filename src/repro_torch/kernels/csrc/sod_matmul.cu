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
// band is scale[kt][nt] (int8, fp8) or codebook[ncodes] (codebook).  A
// tile's slots are one contiguous slab: cap * bn values, and cap * bn bytes
// of rows.
//
// What bounds it.  At decode (M = 4) each packed slot (2 bytes of bf16 value,
// or 1 byte of code, + 1 byte of row index) feeds 4 multiply-adds: far below
// the ~295 operations per byte at which an H100 stops being limited by HBM.
// The kernel is bound by the bytes of vals + rows.  Reading them as many
// small loads per thread made it bound by the count of dependent round trips
// instead (a cap of 72 slots cost 9 of them a tile, whatever its bytes).
// Once the slabs stream in, the next limit is inside the SM: every real slot
// gathers row r of the staged x from shared memory at a random r, so bank
// conflicts and the bytes of that gather cost more than the slot's
// multiply-adds.  At prefill (M = 128) the gather and the multiply-adds on
// CUDA cores bound it.
//
// What the design does about it.
//  * A ring of tile slabs in shared memory, filled by bulk copies.  One
//    thread of the CTA asks, per K tile of its split, for two
//    cp.async.bulk copies (the tile's vals slab and its rows slab) into one
//    stage of an S-stage ring, completing on that stage's mbarrier with the
//    sum of both sizes as its expected bytes.  Up to S tiles are in flight
//    before any thread touches one; at decode a CTA owns 1-4 tiles, so all
//    of its slabs usually go out at once and a tile costs about one round
//    trip.  Stage reuse (a write after the consumers' reads) is released by
//    a __syncthreads() before the refill is issued.
//  * The consumers.  Thread j owns column j of the tile: it waits on the
//    stage's barrier by phase parity, then walks rows_s[s][j] and
//    vals_s[s][j] out of shared memory and, for each real slot (r, v), adds
//    v * x[m][r] into its BM accumulators, reading x[:, r] from shared
//    memory.  That is the sum x @ tile (every real slot once, f32
//    accumulation) with cap instead of bk multiply-adds per column.  Slots
//    go in groups of 8 whose gathers are in flight together: a group that
//    is padding (r < 0) in the whole warp is skipped, and a padding slot
//    inside a group reads a staged zero row (column_fma).
//  * x staging.  x is small and sits in L2; threads stage it transposed, in
//    its own dtype, so the BM values of one row are one gather of BM * 2
//    bytes for bf16 (8 at decode), half of what f32 would take.  Where the
//    budget allows (decode), the CTA's whole K range of x is staged once,
//    while the first slabs are in flight (x_tiles = tiles of the split);
//    otherwise (prefill) one tile of x at a time.
//  * Dequantization per slot, at load: code * scale[kt][nt] in one f32
//    multiply, or the codebook entry from a 128-entry table staged in shared
//    memory once per CTA (common.cuh).  Each weight is bit-equal to the plain
//    version's dequantized weight (formats._dequant_values), and stays f32:
//    the TPU kernel rounds its dequantized tile to x's dtype before its dot;
//    the plain version, the reference package's oracle too, does not.
//  * One CTA per (N tile, M block, K split).  A small N (wq: 16 tiles) gives
//    far fewer CTAs than the 132 SMs, so the wrapper splits the K tiles over
//    gridDim.z, aiming at two CTAs per SM.  Split-K is reduced inside the
//    launch by the CTA that arrives last at its output tile
//    (common.cuh:finish_splits): sums in split order, deterministic, with
//    the counters the wrapper keeps per (device, stream).
//  * One body for every M block: BM = 4 (M <= 4, decode at batch 4),
//    BM = 8 (M <= 8) and BM = 32 share the ring and the slot walk.
//
// Rules the wrapper's launch plan (sod_matmul.py:plan_launch) keeps and this
// entry point checks.  A bulk copy needs 16-byte aligned source and
// destination and a size that is a multiple of 16: bn % 32 == 0 makes every
// slab a multiple of 32 bytes, and vals and rows must start 16-byte aligned
// (a view into a stacked operand may not; the wrapper raises).  Dynamic
// shared memory is S * cap * bn * (sizeof(value) + 1) bytes of ring plus
// (x_tiles * bk + 1) * BM * sizeof(x) of x and a zero row; S >= 2, and the
// planned CTAs per SM fit in its 228 KB.  Above 48 KB the launch raises the
// kernel's limit first.
//
// Not yet: wgmma on a densified slab for prefill-sized M, a persistent
// schedule, warp-specialised producers (later changes).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; plain C entry point, loaded with ctypes.

#include "common.cuh"

namespace {

// acc[m] += v * x[m][r] for the stored slots (r, v) of one tile column
// (rows rp[s * bn], values vp[s * bn]); r < 0 is padding and adds nothing.
// Slots go in groups of 8.  A group in which the whole warp holds padding
// (the tail of the columns) is skipped; otherwise a padding slot gathers the
// staged zero row (0 * v adds nothing, whatever x holds), so the group's 8
// gathers have no branch between them and are in flight together, not one
// shared-memory round trip per slot.  The last cap % 8 slots go one by one.
template <int BM, typename TX, typename T, typename Deq>
__device__ __forceinline__ void column_fma(float (&acc)[BM], const TX* xt, const TX* zero,
                                           const int8_t* rp, const T* vp, int cap, int bn,
                                           const Deq& deq) {
  int s = 0;
  for (; s + 8 <= cap; s += 8) {
    int r[8];
    bool real = false;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      r[u] = rp[(size_t)(s + u) * bn];
      real |= r[u] >= 0;
    }
    if (!__any_sync(0xffffffffu, real)) continue;  // warp-uniform: bn % 32 == 0
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = deq(vp[(size_t)(s + u) * bn]);
#pragma unroll
    for (int u = 0; u < 8; ++u) row_fma_x<BM>(acc, r[u] >= 0 ? xt + r[u] * BM : zero, v[u]);
  }
  // The unroll matters even when cap % 8 == 0: without it the BM = 4 bf16
  // walk was given fewer registers and decode took 13 % longer.
#pragma unroll 8
  for (; s < cap; ++s) {
    const int r = rp[(size_t)s * bn];
    if (r >= 0) row_fma_x<BM>(acc, xt + r * BM, deq(vp[(size_t)s * bn]));
  }
}

template <typename TIn, typename TOut, int BM, typename Deq>
__global__ void sod_matmul_kernel(const TIn* __restrict__ x,
                                  const typename Deq::T* __restrict__ vals,
                                  const int8_t* __restrict__ rows,
                                  const float* __restrict__ scale,
                                  const float* __restrict__ codebook, TOut* __restrict__ out,
                                  float* __restrict__ partial, int* __restrict__ counters, int m,
                                  int k, int n, int kt_total, int nt_total, int cap, int bk,
                                  int kt_per_split, int stages, int x_tiles, int ncodes) {
  using T = typename Deq::T;
  extern __shared__ __align__(16) unsigned char smem[];  // ring of vals, ring of rows, x
  __shared__ float table[kMaxCodes];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  const int j = threadIdx.x;
  const int bn = blockDim.x;
  const int nt = blockIdx.x;
  const int m0 = blockIdx.y * BM;
  const int kt0 = blockIdx.z * kt_per_split;
  const int tiles = min(kt_per_split, kt_total - kt0);
  const size_t slab = (size_t)cap * bn;  // slots of one tile
  const uint32_t vbytes = (uint32_t)(slab * sizeof(T)), rbytes = (uint32_t)slab;
  T* vals_s = reinterpret_cast<T*>(smem);
  int8_t* rows_s = reinterpret_cast<int8_t*>(smem + stages * (size_t)vbytes);
  TIn* xs = reinterpret_cast<TIn*>(smem + stages * ((size_t)vbytes + rbytes));
  TIn* zero = xs + (size_t)x_tiles * bk * BM;  // one row of zeros after the x tiles

  // tile i of the split into stage i % stages (thread 0 only)
  auto issue = [&](int i) {
    const int st = i % stages;
    const size_t tile = (size_t)(kt0 + i) * nt_total + nt;
    mbar_arrive_expect_tx(&full[st], vbytes + rbytes);
    bulk_copy_g2s(vals_s + st * slab, vals + tile * slab, vbytes, &full[st]);
    bulk_copy_g2s(rows_s + st * slab, rows + tile * slab, rbytes, &full[st]);
  };
  if (j == 0) {
    for (int st = 0; st < stages; ++st) mbar_init(&full[st], 1);
    fence_mbar_init();
    for (int i = 0; i < min(stages, tiles); ++i) issue(i);
  }

  Deq deq;
  deq.begin(table, codebook, ncodes);  // published by the first x staging's barrier
  for (int mm = j; mm < BM; mm += bn) zero[mm] = from_f32<TIn>(0.f);  // and so is this

  float acc[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) acc[i] = 0.f;

  for (int i = 0; i < tiles; ++i) {
    if (i % x_tiles == 0) {  // stage x for tiles i .. i + x_tiles - 1
      __syncthreads();       // the previous chunk's readers are done with xs
#pragma unroll 4
      for (int t = 0; t < x_tiles; ++t) {
        for (int r = j; r < bk; r += bn) {  // neighbours read neighbouring columns of x
          const int col = (kt0 + i + t) * bk + r;
          const bool in = i + t < tiles && col < k;
          TIn* dst = xs + (size_t)(t * bk + r) * BM;
#pragma unroll
          for (int mm = 0; mm < BM; ++mm) {
            const int row = m0 + mm;
            dst[mm] = in && row < m ? x[(size_t)row * k + col] : from_f32<TIn>(0.f);
          }
        }
      }
      __syncthreads();  // also publishes the barriers' init and the codebook
    }
    deq.tile(scale, (size_t)(kt0 + i) * nt_total + nt);
    const int st = i % stages;
    mbar_wait(&full[st], (uint32_t)(i / stages) & 1u);
    const int8_t* rp = rows_s + st * slab + j;
    const T* vp = vals_s + st * slab + j;
    const TIn* xt = xs + (size_t)(i % x_tiles) * bk * BM;
    column_fma<BM>(acc, xt, zero, rp, vp, cap, bn, deq);
    if (i + stages < tiles) {
      __syncthreads();  // every reader is done with stage st: refill it
      if (j == 0) issue(i + stages);
    }
  }

  finish_splits<BM>(acc, out, partial, counters, m, n, m0, nt * bn + j,
                    blockIdx.y * nt_total + nt);
}

struct Args {
  const void* x;
  const void* vals;
  const void* rows;
  const void* scale;
  const void* codebook;
  void* out;
  void* partial;
  void* counters;
  int m, k, n, kt, nt, cap, bk, bn, bm, splits, stages, x_tiles, smem, ncodes;
};

template <typename TIn, typename TOut, int BM, typename Deq>
int launch(const Args& a, cudaStream_t stream) {
  const int kt_per_split = (a.kt + a.splits - 1) / a.splits;
  const size_t ring = (size_t)a.stages * a.cap * a.bn * (sizeof(typename Deq::T) + 1);
  const size_t xbytes = ((size_t)a.x_tiles * a.bk + 1) * BM * sizeof(TIn);  // + the zero row
  if (ring + xbytes != (size_t)a.smem || a.x_tiles > kt_per_split) return (int)cudaErrorInvalidValue;
  auto kernel = sod_matmul_kernel<TIn, TOut, BM, Deq>;
  static bool configured[kMaxDevices] = {};
  const cudaError_t e = configure(kernel, configured);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.nt, (a.m + BM - 1) / BM, a.splits);
  float* part = a.splits > 1 ? static_cast<float*>(a.partial) : nullptr;
  kernel<<<grid, a.bn, a.smem, stream>>>(
      static_cast<const TIn*>(a.x), static_cast<const typename Deq::T*>(a.vals),
      static_cast<const int8_t*>(a.rows), static_cast<const float*>(a.scale),
      static_cast<const float*>(a.codebook), static_cast<TOut*>(a.out), part,
      static_cast<int*>(a.counters), a.m, a.k, a.n, a.kt, a.nt, a.cap, a.bk, kt_per_split,
      a.stages, a.x_tiles, a.ncodes);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (activations and output).  qmode
// codes: 0 = none (vals in the activations' dtype), 1 = int8 and 2 = fp8
// e4m3 (codes, with an f32 scale per (kt, nt) tile), 3 = codebook (int8
// indices into an f32 table of ncodes <= 128 entries).  scale and codebook
// are null where the qmode has none.  When splits > 1, `partial` is an f32
// buffer of splits * m * n elements and `counters` an int32 buffer of at
// least nt * ceil(m / bm) zeros, left zero by every launch; both unused
// otherwise.  bm (4, 8 or 32), stages, x_tiles and smem (dynamic shared bytes)
// are the wrapper's launch plan; vals and rows must be 16-byte aligned.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int sod_matmul_launch(const void* x, const void* vals, const void* rows,
                                 const void* scale, const void* codebook, void* out,
                                 void* partial, void* counters, int m, int k, int n, int kt,
                                 int nt, int cap, int bk, int bn, int bm, int splits, int stages,
                                 int x_tiles, int smem, int in_dtype, int out_dtype, int qmode,
                                 int ncodes, void* stream) {
  if (m <= 0 || n <= 0 || kt <= 0 || nt <= 0 || cap <= 0 || bk <= 0 || bk > 128 ||
      bn <= 0 || bn > 1024 || bn % 32 != 0 || (bm != 4 && bm != 8 && bm != 32) || splits < 1 ||
      splits > kt || (m + bm - 1) / bm > 65535 || stages < 1 || stages > kMaxStages ||
      x_tiles < 1 || smem <= 0 || smem > kSmemPerBlock ||
      reinterpret_cast<uintptr_t>(vals) % 16 != 0 || reinterpret_cast<uintptr_t>(rows) % 16 != 0 ||
      (splits > 1 && (partial == nullptr || counters == nullptr)) ||
      ((qmode == kInt8 || qmode == kFp8) && scale == nullptr) ||
      (qmode == kCodebook && (codebook == nullptr || ncodes < 1 || ncodes > kMaxCodes))) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{x,  vals, rows, scale, codebook, out,    partial, counters, m,       k,
               n,  kt,   nt,   cap,   bk,       bn,     bm,      splits,   stages,  x_tiles,
               smem, ncodes};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(in_dtype, out_dtype, qmode, [&](auto tin, auto tout, auto deq) -> int {
    using TIn = typename decltype(tin)::type;
    using TOut = typename decltype(tout)::type;
    using Deq = typename decltype(deq)::type;
    if (bm == 4) return launch<TIn, TOut, 4, Deq>(a, s);
    return bm == 8 ? launch<TIn, TOut, 8, Deq>(a, s) : launch<TIn, TOut, 32, Deq>(a, s);
  });
}
