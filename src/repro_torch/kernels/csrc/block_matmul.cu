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
// first, so the ids are >= 0 exactly at s < tile_nnz, and a tile's stored
// values are one contiguous slab of tile_nnz * br * bn values.  Under a
// quantized qmode block_vals holds codes (int8, fp8 e4m3, or int8 codebook
// indices), with scale[kt][nt] per macro tile (int8, fp8) or the layer's
// codebook[ncodes] (codebook).
//
// What bounds it.  At decode (M = 4) each stored bf16 value feeds 4
// multiply-adds, far below the ~295 operations per byte at which an H100
// stops being limited by HBM: the kernel is bound by the bytes of the stored
// sub-blocks.  A CTA owns a few tiles at decode, so what it must not do is
// spend its time on dependent round trips (tile_nnz, then the ids, then x,
// then the values) instead of on those bytes.
//
// What the design does about it.
//  * A ring of stored slabs in shared memory, filled by bulk copies.  Warp 0
//    reads tile_nnz for every tile of the CTA's K split at once and lists the
//    non-empty ones in shared memory; thread 0 then asks, for each listed
//    tile, for one cp.async.bulk copy of exactly its tile_nnz * br * bn
//    stored values into one stage of an S-stage ring, and one of its ids,
//    both completing on that stage's mbarrier with the sum of their sizes as
//    its expected bytes.  An empty tile is never listed, so it issues no copy
//    and takes no stage, as the TPU kernel's pl.when(nnz > 0) skips it.  At
//    decode a CTA owns 1-4 tiles, so all of its slabs usually go out at once.
//    Stage reuse is released by a __syncthreads() before the refill.
//  * The ids' copy starts at the 16-byte boundary at or below the tile's ids
//    and is rounded up to 16 bytes, so it needs no alignment of bcap or of
//    the buffer (a layer of a stacked operand starts wherever the layers
//    before it end); the consumers skip the 0-12 leading bytes.  The bytes
//    read around the ids lie in the same 16-byte granules as ids that are
//    read, so never on another page.
//  * x without a gather.  A sub-block selects br consecutive rows of K, so
//    the CTA stages x for its K range as x lies, row-major (at decode the
//    whole split, by warps 1.. while warp 0 fills the ring, 8-value pieces
//    with 16-byte loads, 128 bytes in flight a thread; at prefill, where
//    that does not fit beside two stages, one tile at a time).  For 8 rows of a
//    sub-block, row m of x is then one or two 16-byte loads that every
//    thread of the warp makes at once: a shared-memory broadcast, without
//    bank conflicts.  (A transposed x, BM values per K row, costs scalar
//    stores with 16-way bank conflicts at 32 rows.)
//  * The consumers.  A thread owns CP neighbouring columns of the tile: it
//    waits on the stage's barrier by phase parity, then walks the slab's
//    tile_nnz sub-blocks 8 value rows at a time from shared memory and adds
//    v * x[m][row] into BM * CP f32 accumulators.  That is the sum x @ tile
//    (every stored value once, f32 accumulation) with tile_nnz * br instead
//    of bk multiply-adds a column.  At decode (BM <= 8) x stays in its own
//    dtype and CP = 1.  At prefill the walk is bound by its instructions and
//    shared-memory loads, so x is staged in f32 (no shift a multiply-add to
//    widen bf16) and CP = 2 (one load of x feeds two columns).
//  * Dequantization per value, at load (the value paths of common.cuh):
//    code * the macro tile's f32 scale, or the entry of the codebook staged
//    in shared memory once per CTA, bit-equal to formats._dequant_values.
//    The TPU kernel instead sums the dequantized blocks into an f32 tile,
//    scales it once, and rounds it to x's dtype before its dot; this kernel
//    keeps the f32 weight, as the plain version (the reference's oracle) does.
//  * One CTA per (N tile, M block, K split), split-K reduced inside the
//    launch by the CTA that arrives last (common.cuh:finish_splits): sums in
//    split order, deterministic, no second kernel.
//  * One body for every M block: BM = 4 (M <= 4, decode at batch 4), BM = 8
//    (M <= 8) and BM = 16.  Above 16 rows a CTA holds mg groups of bn / 2
//    threads, each group BM = 16 rows of M, and the groups share the ring: a
//    slab is copied once for up to mg * 16 rows, not once per 16.
//
// Rules the wrapper's launch plan (block_matmul.py:plan_launch) keeps and
// this entry point checks.  A bulk copy needs 16-byte aligned source and
// destination and a size that is a multiple of 16: bn % 32 == 0 makes every
// slab a multiple of 32 bytes, and block_vals must start 16-byte aligned (the
// wrapper raises otherwise).  Dynamic shared memory is S stages of
// bcap * br * bn * sizeof(value) + ids_stage_bytes(bcap), then x_tiles * bk *
// BM * mg values of x (x's dtype at BM <= 8, f32 at BM = 16), then 8 bytes
// per tile of the split for the list of non-empty tiles; S >= 2.  Above
// 48 KB the launch raises the kernel's limit first.
//
// Not yet: wgmma on the densified slab for prefill-sized M, a persistent
// schedule (later changes).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; plain C entry point, loaded with ctypes.

#include "common.cuh"

namespace {

// Bytes of a stage's ids: bcap int32 ids and up to 12 leading bytes of the
// 16-byte granule they start in, rounded up to 16.
__host__ __device__ constexpr uint32_t ids_stage_bytes(int bcap) {
  return (4u * (uint32_t)bcap + 12u + 15u) & ~15u;
}

// x as staged: f32 widened exactly, or x's own value.
template <typename TX, typename TIn>
__device__ __forceinline__ TX stage_cast(TIn v) {
  if constexpr (sizeof(TX) == sizeof(TIn)) {
    return v;
  } else {
    return to_f32(v);
  }
}

// How a CTA of M block BM works.  At decode (BM <= 8) x is staged in its own
// dtype and a thread owns one column.  At BM = 16 (prefill) x is staged in
// f32, since each staged value meets 16 multiply-adds a row and widening it
// once saves a shift per multiply-add, and a thread owns two neighbouring
// columns, so one broadcast load of x feeds both: half the shared-memory
// loads per multiply-add.  (BM = 32 with one column a thread took 1.1x the
// time at M = 128; two columns at BM = 32 spilled.)  A CTA holds at most
// kMaxThreads threads, so each may use 128 registers.
constexpr int kMaxThreads = 512;
template <typename TIn, int BM>
struct Shape {
  using TX = TIn;
  static constexpr int kCols = 1;
};
template <typename TIn>
struct Shape<TIn, 16> {
  using TX = float;
  static constexpr int kCols = 2;
};

// The 8 consecutive K values of one row of staged x at xr (16-byte aligned
// shared memory), as f32: one 16-byte load for bf16 (widened exactly, by a
// shift), two for f32.
__device__ __forceinline__ void load8(float (&xv)[8], const __nv_bfloat16* xr) {
  const uint4 q = *reinterpret_cast<const uint4*>(xr);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    xv[2 * u] = __uint_as_float(w[u] << 16);
    xv[2 * u + 1] = __uint_as_float(w[u] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(float (&xv)[8], const float* xr) {
  const float4 a = reinterpret_cast<const float4*>(xr)[0];
  const float4 b = reinterpret_cast<const float4*>(xr)[1];
  xv[0] = a.x, xv[1] = a.y, xv[2] = a.z, xv[3] = a.w;
  xv[4] = b.x, xv[5] = b.y, xv[6] = b.z, xv[7] = b.w;
}

// acc[c][mm] += x[mm][id * br + r] * v[r][c] over the nnz stored sub-blocks
// of CP neighbouring tile columns: sub-block s has in-tile id ids[s] and
// value rows vp[(s * br + r) * bn + c]; row mm of the tile's staged x starts
// at xt + mm * ldx.  With br % 8 == 0 (vec == br) the rows go 8 at a time:
// 8 weights a column, then for each of the BM rows of x one broadcast load
// of its 8 values; each sum runs in row order.
template <int BM, int CP, typename TX, typename T, typename Deq>
__device__ __forceinline__ void block_fma(float (&acc)[CP][BM], const TX* xt, int ldx,
                                          const int* ids, const T* vp, int nnz, int br,
                                          int vec, int bn, const Deq& deq) {
  for (int s = 0; s < nnz; ++s) {
    const int id = ids[s];  // the same for the whole CTA: a broadcast
    if (id < 0) continue;   // padding (not stored below tile_nnz by the packer)
    const TX* xr = xt + id * br;
    const T* v = vp + (size_t)s * br * bn;
    int q = 0;
    for (; q < vec; q += 8) {
      float w[CP][8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
#pragma unroll
        for (int c = 0; c < CP; ++c) w[c][u] = deq(v[(size_t)(q + u) * bn + c]);
      }
#pragma unroll
      for (int mm = 0; mm < BM; ++mm) {
        float xv[8];
        load8(xv, xr + mm * ldx + q);
#pragma unroll
        for (int c = 0; c < CP; ++c) {
#pragma unroll
          for (int u = 0; u < 8; ++u) acc[c][mm] += xv[u] * w[c][u];
        }
      }
    }
    for (; q < br; ++q) {
      float w[CP];
#pragma unroll
      for (int c = 0; c < CP; ++c) w[c] = deq(v[(size_t)q * bn + c]);
#pragma unroll
      for (int mm = 0; mm < BM; ++mm) {
        const float xv = to_f32(xr[mm * ldx + q]);
#pragma unroll
        for (int c = 0; c < CP; ++c) acc[c][mm] += xv * w[c];
      }
    }
  }
}

// One CTA: mg groups of bn / CP threads, group g owning rows m0 + g * BM ..
// + BM of the CTA's BM * mg rows of x, thread t of a group owning columns
// t * CP .. t * CP + CP - 1 of the N tile.  All groups share the ring: a
// slab is copied once for them.
template <typename TIn, typename TOut, int BM, typename Deq>
__global__ void __launch_bounds__(kMaxThreads)
    block_matmul_kernel(const TIn* __restrict__ x, const typename Deq::T* __restrict__ bvals,
                        const int* __restrict__ ids, const int* __restrict__ tile_nnz,
                        const float* __restrict__ scale, const float* __restrict__ codebook,
                        TOut* __restrict__ out, float* __restrict__ partial,
                        int* __restrict__ counters, int m, int k, int n, int kt_total,
                        int nt_total, int bcap, int br, int bk, int bn, int kt_per_split,
                        int stages, int x_tiles, int ncodes) {
  using T = typename Deq::T;
  using TX = typename Shape<TIn, BM>::TX;
  constexpr int CP = Shape<TIn, BM>::kCols;
  extern __shared__ __align__(16) unsigned char smem[];  // ring, x, the live-tile list
  __shared__ float table[kMaxCodes];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ int nlive;
  const int tid = threadIdx.x;
  const int group = bn / CP;                // threads of a group
  const int j = tid % group * CP;           // the thread's first column
  const int g = tid / group;
  const int rows = BM * (blockDim.x / group);  // rows of x this CTA stages
  const int nt = blockIdx.x;
  const int mc = blockIdx.y * rows;         // the CTA's first row
  const int kt0 = blockIdx.z * kt_per_split;
  const int tiles = min(kt_per_split, kt_total - kt0);
  const int ldx = x_tiles * bk;             // staged x: [rows][ldx], row-major as x
  const size_t slab = (size_t)bcap * br * bn;  // values of one stage
  const size_t vstage = slab * sizeof(T);
  const size_t stage_bytes = vstage + ids_stage_bytes(bcap);
  TX* xs = reinterpret_cast<TX*>(smem + stages * stage_bytes);
  int* live = reinterpret_cast<int*>(xs + (size_t)rows * ldx);  // tile i of the split
  int* live_nnz = live + kt_per_split;                          // and its tile_nnz

  auto tile_of = [&](int i) { return (size_t)(kt0 + i) * nt_total + nt; };
  // Offset, in ids, of a tile's first id from the 16-byte granule it starts in.
  auto ids_lead = [&](size_t tile) {
    return (int)((reinterpret_cast<uintptr_t>(ids + tile * bcap) & 15u) / 4u);
  };
  // live tile c into stage c % stages (thread 0 only)
  auto issue = [&](int c) {
    const int st = c % stages;
    const size_t tile = tile_of(live[c]);
    const int nnz = live_nnz[c];
    const int lead = ids_lead(tile);
    const uint32_t vbytes = (uint32_t)((size_t)nnz * br * bn * sizeof(T));
    const uint32_t ibytes = (4u * (uint32_t)(lead + nnz) + 15u) & ~15u;
    unsigned char* dst = smem + st * stage_bytes;
    mbar_arrive_expect_tx(&full[st], vbytes + ibytes);
    bulk_copy_g2s(dst, bvals + tile * slab, vbytes, &full[st]);
    bulk_copy_g2s(dst + vstage, ids + tile * bcap - lead, ibytes, &full[st]);
  };
  if (tid < 32) {  // warp 0: list the split's non-empty tiles, then fill the ring
    int count = 0;
    for (int base = 0; base < tiles; base += 32) {
      const int i = base + tid;
      const int nnz = i < tiles ? min(tile_nnz[tile_of(i)], bcap) : 0;
      const unsigned ballot = __ballot_sync(0xffffffffu, nnz > 0);
      if (nnz > 0) {
        const int c = count + __popc(ballot & ((1u << tid) - 1u));
        live[c] = i;
        live_nnz[c] = nnz;
      }
      count += __popc(ballot);
    }
    __syncwarp();
    if (tid == 0) {
      nlive = count;
      for (int st = 0; st < stages; ++st) mbar_init(&full[st], 1);
      fence_mbar_init();
      for (int c = 0; c < min(stages, count); ++c) issue(c);
    }
  }

  // Rows mc .. mc + rows - 1 of x over K tiles chunk * x_tiles .. + x_tiles
  // - 1 of the split into xs, zero past M, K and the split, by threads
  // first .. first + nthreads - 1.  Neighbouring threads copy neighbouring
  // 8-value pieces of a row: 16-byte loads and stores where x allows, 128
  // bytes a thread in flight at once.
  const int kend = min(k, (kt0 + tiles) * bk);
  const bool vec_x = k % 8 == 0 && bk % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  auto stage_x = [&](int chunk, int first, int nthreads) {
    const int col0 = (kt0 + chunk * x_tiles) * bk;
    if (vec_x) {
      // kBatch pieces a thread, 128 bytes of x: all their loads go out
      // before any store
      constexpr int kIn = 8 * sizeof(TIn) / 16, kOut = 8 * sizeof(TX) / 16, kBatch = 8 / kIn;
      const int per_row = ldx / 8, pieces = rows * per_row;
      for (int base = tid - first; base < pieces; base += kBatch * nthreads) {
        uint4 in[kBatch][kIn];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int idx = base + b * nthreads;
          const int r = idx / per_row, c = (idx - r * per_row) * 8;
          if (idx < pieces && mc + r < m && col0 + c < kend) {  // kend % 8 == 0: all 8 in
            const uint4* src =
                reinterpret_cast<const uint4*>(x + (size_t)(mc + r) * k + col0 + c);
#pragma unroll
            for (int u = 0; u < kIn; ++u) in[b][u] = src[u];
          } else {
#pragma unroll
            for (int u = 0; u < kIn; ++u) in[b][u] = make_uint4(0u, 0u, 0u, 0u);
          }
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int idx = base + b * nthreads;
          if (idx >= pieces) break;
          const int r = idx / per_row, c = (idx - r * per_row) * 8;
          uint4 outv[kOut];
          const TIn* iv = reinterpret_cast<const TIn*>(in[b]);
          TX* ov = reinterpret_cast<TX*>(outv);
#pragma unroll
          for (int u = 0; u < 8; ++u) ov[u] = stage_cast<TX>(iv[u]);
          uint4* dst = reinterpret_cast<uint4*>(xs + (size_t)r * ldx + c);
#pragma unroll
          for (int u = 0; u < kOut; ++u) dst[u] = outv[u];
        }
      }
    } else {
      for (int idx = tid - first; idx < rows * ldx; idx += nthreads) {
        const int r = idx / ldx, c = idx - r * ldx;
        const bool in = mc + r < m && col0 + c < kend;
        xs[idx] = in ? stage_cast<TX>(x[(size_t)(mc + r) * k + col0 + c]) : from_f32<TX>(0.f);
      }
    }
  };

  Deq deq;
  deq.begin(table, codebook, ncodes);
  // Warp 0 is busy with the copies: the other warps stage x meanwhile.
  const int first = blockDim.x > 32 ? 32 : 0;
  if (tid >= first) stage_x(0, first, blockDim.x - first);
  int chunk = 0;
  __syncthreads();  // publishes the list, the barriers' init, the codebook and x

  float acc[CP][BM];
#pragma unroll
  for (int c = 0; c < CP; ++c) {
#pragma unroll
    for (int i = 0; i < BM; ++i) acc[c][i] = 0.f;
  }

  const int vec = br % 8 == 0 ? br : 0;
  const TX* xg = xs + (size_t)g * BM * ldx;  // this group's rows
  const int count = nlive;
  for (int c = 0; c < count; ++c) {
    const int i = live[c];
    if (i / x_tiles != chunk) {  // only when x is staged a tile at a time
      __syncthreads();           // the previous chunk's readers are done with xs
      chunk = i / x_tiles;
      stage_x(chunk, 0, blockDim.x);
      __syncthreads();
    }
    const size_t tile = tile_of(i);
    deq.tile(scale, tile);
    const int st = c % stages;
    mbar_wait(&full[st], (uint32_t)(c / stages) & 1u);
    const unsigned char* base = smem + st * stage_bytes;
    const int* sid = reinterpret_cast<const int*>(base + vstage) + ids_lead(tile);
    block_fma<BM, CP>(acc, xg + (i % x_tiles) * bk, ldx, sid,
                      reinterpret_cast<const T*>(base) + j, live_nnz[c], br, vec, bn, deq);
    if (c + stages < count) {
      __syncthreads();  // every reader is done with stage st: refill it
      if (tid == 0) issue(c + stages);
    }
  }

  finish_splits<BM, CP>(acc, out, partial, counters, m, n, mc + g * BM, nt * bn + j,
                        blockIdx.y * nt_total + nt);
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
  void* counters;
  int m, k, n, kt, nt, bcap, br, bk, bn, mg, splits, stages, x_tiles, smem, ncodes;
};

template <typename TIn, typename TOut, int BM, typename Deq>
int launch(const Args& a, cudaStream_t stream) {
  const int kt_per_split = (a.kt + a.splits - 1) / a.splits;
  const size_t stage =
      (size_t)a.bcap * a.br * a.bn * sizeof(typename Deq::T) + ids_stage_bytes(a.bcap);
  using S = Shape<TIn, BM>;
  const size_t xbytes = (size_t)a.x_tiles * a.bk * BM * a.mg * sizeof(typename S::TX);
  const int threads = a.bn / S::kCols * a.mg;
  const size_t lists = (size_t)8 * kt_per_split;
  if (a.stages * stage + xbytes + lists != (size_t)a.smem || a.x_tiles > kt_per_split ||
      threads > kMaxThreads) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = block_matmul_kernel<TIn, TOut, BM, Deq>;
  static bool configured[kMaxDevices] = {};
  const cudaError_t e = configure(kernel, configured);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.nt, (a.m + BM * a.mg - 1) / (BM * a.mg), a.splits);
  float* part = a.splits > 1 ? static_cast<float*>(a.partial) : nullptr;
  kernel<<<grid, threads, a.smem, stream>>>(
      static_cast<const TIn*>(a.x), static_cast<const typename Deq::T*>(a.bvals),
      static_cast<const int*>(a.ids), static_cast<const int*>(a.tile_nnz),
      static_cast<const float*>(a.scale), static_cast<const float*>(a.codebook),
      static_cast<TOut*>(a.out), part, static_cast<int*>(a.counters), a.m, a.k, a.n, a.kt,
      a.nt, a.bcap, a.br, a.bk, a.bn, kt_per_split, a.stages, a.x_tiles, a.ncodes);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (activations and output).  qmode
// codes: 0 = none (block_vals in the activations' dtype), 1 = int8 and
// 2 = fp8 e4m3 (codes, with an f32 scale per (kt, nt) macro tile),
// 3 = codebook (int8 indices into an f32 table of ncodes <= 128 entries).
// scale and codebook are null where the qmode has none.  When splits > 1,
// `partial` is an f32 buffer of splits * m * n elements and `counters` an
// int32 buffer of at least nt * ceil(m / bm) zeros, left zero by every
// launch; both unused otherwise.  bm (4, 8 or 16), mg (groups of bm rows a
// CTA: 1 unless bm == 16, where a group is bn / 2 threads; a CTA holds at
// most 512 threads), stages, x_tiles and smem
// (dynamic shared bytes) are the wrapper's launch plan; bvals must be
// 16-byte aligned.  Returns the cudaError_t of the launch (0 = success).
extern "C" int block_matmul_launch(const void* x, const void* bvals, const void* ids,
                                   const void* tile_nnz, const void* scale,
                                   const void* codebook, void* out, void* partial,
                                   void* counters, int m, int k, int n, int kt, int nt,
                                   int bcap, int br, int bk, int bn, int bm, int mg, int splits,
                                   int stages, int x_tiles, int smem, int in_dtype,
                                   int out_dtype, int qmode, int ncodes, void* stream) {
  if (m <= 0 || n <= 0 || kt <= 0 || nt <= 0 || bcap <= 0 || br <= 0 || bk <= 0 || bk > 256 ||
      bk % br != 0 || bcap * br > bk || bn <= 0 || bn > 1024 || bn % 32 != 0 ||
      (bm != 4 && bm != 8 && bm != 16) || mg < 1 || (mg > 1 && bm != 16) ||
      splits < 1 || splits > kt || (m + bm * mg - 1) / (bm * mg) > 65535 || stages < 2 || stages > kMaxStages || x_tiles < 1 ||
      smem <= 0 || smem > kSmemPerBlock || reinterpret_cast<uintptr_t>(bvals) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(ids) % 4 != 0 ||
      (splits > 1 && (partial == nullptr || counters == nullptr)) ||
      ((qmode == kInt8 || qmode == kFp8) && scale == nullptr) ||
      (qmode == kCodebook && (codebook == nullptr || ncodes < 1 || ncodes > kMaxCodes))) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{x,  bvals, ids, tile_nnz, scale, codebook, out,     partial, counters,
               m,  k,     n,   kt,       nt,    bcap,     br,      bk,      bn,
               mg, splits, stages, x_tiles, smem, ncodes};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(in_dtype, out_dtype, qmode, [&](auto tin, auto tout, auto deq) -> int {
    using TIn = typename decltype(tin)::type;
    using TOut = typename decltype(tout)::type;
    using Deq = typename decltype(deq)::type;
    if (bm == 4) return launch<TIn, TOut, 4, Deq>(a, s);
    return bm == 8 ? launch<TIn, TOut, 8, Deq>(a, s) : launch<TIn, TOut, 16, Deq>(a, s);
  });
}
