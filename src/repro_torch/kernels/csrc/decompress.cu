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
// (int8, fp8) or the layer's codebook (codebook).  A tile's slots are one
// contiguous slab: cap * bn values, and cap * bn bytes of rows.
//
// What bounds it.  No arithmetic: the bytes of vals + rows read and of the
// dense matrix written, and the dense write is the larger (K * N values
// against cap * N slots at density 0.3; 4 bytes a value for the f32 output
// of a quantized operand).  So the card's memory has to be kept busy both
// ways at once, with wide accesses.
//
// What the design does about it.
//  * Persistent CTAs.  The wrapper launches min(tiles, SMs * CTAs per SM)
//    CTAs; CTA b densifies tiles b, b + gridDim.x, ... of the row-major
//    (Kt, Nt) grid.  Each tile is written by exactly one CTA, so the output
//    does not depend on the grid, and no wave is left partly empty.
//  * A ring of tile slabs in shared memory, filled by bulk copies.  Thread 0
//    asks, for each of the CTA's tiles, for two cp.async.bulk copies (the
//    tile's vals slab and its rows slab) into one stage of an S-stage ring,
//    completing on that stage's mbarrier.  The next S - 1 tiles' slabs are in
//    flight while a tile is densified and written; a stage is refilled after
//    the __syncthreads() that ends its tile's scatter.
//  * Densify in shared memory.  A packed column never holds two real slots
//    with the same row (the pack is lossless), so any thread may place any
//    slot: thread t takes column t % bn and slots t / bn, t / bn + T / bn,
//    ... of the staged slab (T = blockDim.x, a multiple of bn), four slots'
//    loads in flight at a time, and writes each real slot into a (bk, bn)
//    dense tile of the output dtype.  A warp's 32 stores go to 32
//    neighbouring columns: no bank conflict in f32, two-way in bf16.
//  * Whole rows out with 16-byte stores.  A tile row is bn * sizeof(TOut)
//    contiguous bytes of the output; thread t moves 16-byte chunks of the
//    dense tile to global memory, neighbouring threads on neighbouring
//    chunks, and writes zeros back into each chunk it has read, so the tile
//    is clean for its next use without a pass of its own.  The ragged edge
//    (col >= n, row >= k) and rows whose start is not 16-byte aligned
//    (n * sizeof(TOut) % 16 != 0) go element by element.
//  * Two dense tiles where shared memory allows (dense_buffers = 2): tile
//    i's write-out overlaps tile i + 1's scatter, and one barrier a tile is
//    enough.  With one, a second barrier orders the write-out before the next
//    scatter.
//
// Bit-equal to the plain version (TiledCSC.to_dense, the reference's scatter
// oracle).  Each slot is dequantized by the value paths of common.cuh (the
// stored value, one f32 multiply code * scale, or the table entry), added
// to +0.0 as the scatter adds it to its zeroed matrix (which turns a -0.0
// code into +0.0), and converted once to the output dtype: exact for f32
// and for bf16 values kept in bf16, round to nearest even otherwise, as
// torch's cast of the plain version.
//
// Rules the wrapper's launch plan (decompress.py:plan_launch) keeps and this
// entry point checks: bn % 32 == 0 (every slab a multiple of 32 bytes, every
// tile row of 16-byte chunks), vals and rows 16-byte aligned, grid <= tiles,
// blockDim a multiple of bn and of 32 up to 1024, 2 <= stages <= kMaxStages,
// dense_buffers 1 or 2, and smem = dense_buffers * bk * bn * sizeof(TOut) +
// stages * cap * bn * (sizeof(value) + 1) within what one CTA may hold.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; plain C entry point, loaded with ctypes.

#include "common.cuh"

namespace {

constexpr int kUnroll = 4;  // slots a thread has in flight in the scatter

// The real slots of one staged slab (rp, vp: cap * bn rows and values) into
// the zeroed dense tile (bk, bn) `dense`.
template <typename TOut, typename Deq>
__device__ __forceinline__ void scatter(TOut* dense, const int8_t* rp,
                                        const typename Deq::T* vp, int cap, int bn,
                                        const Deq& deq) {
  const int j = threadIdx.x % bn;
  const int ds = blockDim.x / bn;
  int s = threadIdx.x / bn;
  for (; s + (kUnroll - 1) * ds < cap; s += kUnroll * ds) {
    int r[kUnroll];
    typename Deq::T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      r[u] = rp[(s + u * ds) * bn + j];
      v[u] = vp[(s + u * ds) * bn + j];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r[u] >= 0) dense[r[u] * bn + j] = from_f32<TOut>(__fadd_rn(0.f, deq(v[u])));
    }
  }
  for (; s < cap; s += ds) {
    const int r = rp[s * bn + j];
    if (r >= 0) dense[r * bn + j] = from_f32<TOut>(__fadd_rn(0.f, deq(vp[s * bn + j])));
  }
}

// The dense tile (bk, bn) at (row0, col0) of the (k, n) output, in 16-byte
// chunks, each chunk zeroed in shared memory once read.  `vec` says that
// output rows start 16-byte aligned.
template <typename TOut>
__device__ __forceinline__ void write_out(TOut* dense, TOut* __restrict__ out, int row0,
                                          int col0, int k, int n, int bk, int bn, bool vec) {
  constexpr int kE = 16 / sizeof(TOut);  // values a chunk
  const int cpr = bn / kE;               // chunks a row; blockDim.x is a multiple of it
  const int cc = threadIdx.x % cpr;
  const int col = col0 + cc * kE;
  const int rend = min(bk, k - row0);
  const bool whole = vec && col + kE <= n;
  uint4* chunks = reinterpret_cast<uint4*>(dense);
  for (int r = threadIdx.x / cpr; r < bk; r += blockDim.x / cpr) {
    const uint4 v = chunks[r * cpr + cc];
    chunks[r * cpr + cc] = make_uint4(0u, 0u, 0u, 0u);
    if (r >= rend) continue;
    TOut* dst = out + (size_t)(row0 + r) * n + col;
    if (whole) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const TOut* e = reinterpret_cast<const TOut*>(&v);
#pragma unroll
      for (int u = 0; u < kE; ++u) {
        if (col + u < n) dst[u] = e[u];
      }
    }
  }
}

template <typename TOut, typename Deq>
__global__ void __launch_bounds__(1024) decompress_kernel(
    const typename Deq::T* __restrict__ vals, const int8_t* __restrict__ rows,
    const float* __restrict__ scale, const float* __restrict__ codebook, TOut* __restrict__ out,
    int k, int n, int nt_total, int tiles, int cap, int bk, int bn, int stages,
    int dense_buffers, int ncodes) {
  using T = typename Deq::T;
  extern __shared__ __align__(16) unsigned char smem[];  // dense tiles, ring of vals, of rows
  __shared__ float table[kMaxCodes];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  const size_t tile_elems = (size_t)bk * bn;
  const size_t slab = (size_t)cap * bn;  // slots of one tile
  const uint32_t vbytes = (uint32_t)(slab * sizeof(T)), rbytes = (uint32_t)slab;
  TOut* dense = reinterpret_cast<TOut*>(smem);
  T* vals_s = reinterpret_cast<T*>(smem + dense_buffers * tile_elems * sizeof(TOut));
  int8_t* rows_s = reinterpret_cast<int8_t*>(vals_s + stages * slab);
  const int mine = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const bool vec = (n * sizeof(TOut)) % 16 == 0;

  // the CTA's tile i into stage i % stages (thread 0 only)
  auto issue = [&](int i) {
    const int st = i % stages;
    const size_t t = blockIdx.x + (size_t)i * gridDim.x;
    mbar_arrive_expect_tx(&full[st], vbytes + rbytes);
    bulk_copy_g2s(vals_s + st * slab, vals + t * slab, vbytes, &full[st]);
    bulk_copy_g2s(rows_s + st * slab, rows + t * slab, rbytes, &full[st]);
  };
  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) mbar_init(&full[st], 1);
    fence_mbar_init();
    for (int i = 0; i < min(stages, mine); ++i) issue(i);
  }
  Deq deq;
  deq.begin(table, codebook, ncodes);
  uint4* chunks = reinterpret_cast<uint4*>(dense);
  const int nchunks = (int)(dense_buffers * tile_elems * sizeof(TOut) / 16);
  for (int c = threadIdx.x; c < nchunks; c += blockDim.x) chunks[c] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();  // publishes the barriers' init, the codebook and the zeroed tiles

  for (int i = 0; i < mine; ++i) {
    const int t = blockIdx.x + i * gridDim.x;
    const int kt = t / nt_total, nt = t - kt * nt_total;
    const int st = i % stages;
    TOut* d = dense + (i % dense_buffers) * tile_elems;
    deq.tile(scale, t);
    mbar_wait(&full[st], (uint32_t)(i / stages) & 1u);
    scatter<TOut>(d, rows_s + st * slab, vals_s + st * slab, cap, bn, deq);
    __syncthreads();  // the tile is dense, and stage st is read: refill it
    if (threadIdx.x == 0 && i + stages < mine) issue(i + stages);
    write_out(d, out, kt * bk, nt * bn, k, n, bk, bn, vec);
    if (dense_buffers == 1) __syncthreads();  // zeroed before the next scatter
  }
}

struct Args {
  const void* vals;
  const void* rows;
  const void* scale;
  const void* codebook;
  void* out;
  int k, n, kt, nt, cap, bk, bn, grid, threads, stages, dense_buffers, smem, ncodes;
};

template <typename TOut, typename Deq>
int launch(const Args& a, cudaStream_t stream) {
  const size_t want = (size_t)a.dense_buffers * a.bk * a.bn * sizeof(TOut) +
                      (size_t)a.stages * a.cap * a.bn * (sizeof(typename Deq::T) + 1);
  if (want != (size_t)a.smem) return (int)cudaErrorInvalidValue;
  auto kernel = decompress_kernel<TOut, Deq>;
  static bool configured[kMaxDevices] = {};
  const cudaError_t e = configure(kernel, configured);
  if (e != cudaSuccess) return (int)e;
  kernel<<<a.grid, a.threads, a.smem, stream>>>(
      static_cast<const typename Deq::T*>(a.vals), static_cast<const int8_t*>(a.rows),
      static_cast<const float*>(a.scale), static_cast<const float*>(a.codebook),
      static_cast<TOut*>(a.out), a.k, a.n, a.nt, a.kt * a.nt, a.cap, a.bk, a.bn, a.stages,
      a.dense_buffers, a.ncodes);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; `val_dtype` is the stored value
// dtype under qmode 0 (none) and is ignored otherwise, `out_dtype` the dtype
// of `out`, a contiguous (k, n) buffer.  qmode codes: 1 = int8 and 2 = fp8
// e4m3 (codes, with an f32 scale per tile), 3 = codebook (int8 indices into
// an f32 table of ncodes <= 128 entries); scale and codebook are null where
// the qmode has none.  grid, threads, stages, dense_buffers and smem (dynamic
// shared bytes) are the wrapper's launch plan; vals and rows must be 16-byte
// aligned.  Returns the cudaError_t of the launch (0 = success).
extern "C" int decompress_launch(const void* vals, const void* rows, const void* scale,
                                 const void* codebook, void* out, int k, int n, int kt, int nt,
                                 int cap, int bk, int bn, int grid, int threads, int stages,
                                 int dense_buffers, int smem, int val_dtype, int out_dtype,
                                 int qmode, int ncodes, void* stream) {
  if (k <= 0 || n <= 0 || kt <= 0 || nt <= 0 || cap <= 0 || bk <= 0 || bk > 128 || bn <= 0 ||
      bn > 1024 || bn % 32 != 0 || k > kt * bk || n > nt * bn || (long long)kt * nt > (1 << 30) ||
      grid < 1 || (long long)grid > (long long)kt * nt || threads < bn || threads > 1024 ||
      threads % bn != 0 || stages < 2 || stages > kMaxStages ||
      (dense_buffers != 1 && dense_buffers != 2) || smem <= 0 || smem > kSmemPerBlock ||
      reinterpret_cast<uintptr_t>(vals) % 16 != 0 || reinterpret_cast<uintptr_t>(rows) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      ((qmode == kInt8 || qmode == kFp8) && scale == nullptr) ||
      (qmode == kCodebook && (codebook == nullptr || ncodes < 1 || ncodes > kMaxCodes))) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{vals, rows, scale, codebook, out, k, n, kt, nt, cap, bk, bn,
               grid, threads, stages, dense_buffers, smem, ncodes};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(val_dtype, out_dtype, qmode, [&](auto, auto tout, auto deq) -> int {
    using TOut = typename decltype(tout)::type;
    using Deq = typename decltype(deq)::type;
    return launch<TOut, Deq>(a, s);
  });
}
