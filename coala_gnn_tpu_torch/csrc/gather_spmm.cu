// ELL gather-SpMM for Hopper (sm_90a):  out[i, :] = sum_k w[i, k] * x[adj[i, k], :]
// with its int8 + per-row-scale table form and its backward.
//
// Replaces the two Pallas TPU kernels of the JAX package, which compute the
// same contract:
//   - coala_gnn_tpu/ops/pallas_spmm.py  ell_spmm_pallas  (f32 table streamed
//     from HBM through a DMA ring)            -> the float instantiation
//   - coala_gnn_tpu/ops/pallas_gather.py gather_sum_vmem (f32/bf16 table
//     parked in VMEM)                         -> the bf16 instantiation; no
//     on-chip store of this card (228 KB shared memory per SM, 50 MB L2)
//     holds such a table, so it streams from device memory like the other.
// and, new with the int8 cache lines and GAT:
//   - the int8 instantiation: the table's rows dequantised as they are read,
//     v = float(q) * scale[idx], the JAX order of dequantize_rows
//     (coala_gnn_tpu/cache/feature_cache.py) followed by the plane FMAs;
//   - the bf16-rounding reads of an f32 or int8 table (kRound): each widened
//     (int8: dequantised, q * scale in f32 first) element rounded to bf16,
//     round to nearest even, and widened back before its FMA. That is what
//     layer 0 of a bf16 model reads where JAX rounds the rows it gathered
//     (an f32 table under a bf16 model, int8 lines dequantised to a bf16
//     table); rounding inside the kernel keeps the [cap_src, dim] frontier
//     from being built and rounded in a pass of its own;
//   - gather_spmm_grad_w / gather_spmm_grad_x (with its transpose kernels):
//     the backward. Neither Pallas kernel has one; the JAX GAT
//     differentiates its XLA plane FMAs (coala_gnn_tpu/models/layers.py:143),
//     and these kernels are the Hopper form of that autodiff, because the
//     port runs GAT's attention combine through the forward kernel.
//
// Forward. What bounds it on this card: the bytes of the random row reads
// (layer 0 of the training step: N = 6144 dst rows, F = 10 slots, D = 256,
// ~44k distinct live rows of a 200k-row table); one FMA per element is
// negligible. What stands in the way is latency: a loop that loads one
// slot's row and FMAs it before the next load issues keeps one row read in
// flight per warp, and the kernel takes a chain of 2F dependent DRAM round
// trips. So the kernel loads first: a dst row's slots go in batches of
// kBatch = 4; for a batch, every lane reads the 4 indices and weights (the
// group's lanes read the same words, so memory serves each once; a later
// batch or column pass finds them in L1), then issues all 4 row reads into
// registers, and only then runs the FMAs, in slot order k = 0..F-1 with
// fmaf(w, v, acc): the order of the plain version, so the outputs do not
// depend on the batching and a staged window's losses equal a flat
// window's bitwise. The batch size is the card's choice: deeper batches
// were timed at the layer-0 shape and lost, because each lane's registers
// grew (54 for f32 at 4 slots) and fewer warps fit an SM; capping the
// registers by launch bounds spilled. The launch takes batches of 2
// where that alone fits the grid in one wave (asked of the occupancy
// API): a resident row pays its chain of dependent reads once, a row of
// a second wave pays it again (the bf16 table at layer 0: 768 blocks).
// Registers, not a TMA (cp.async.bulk) ring in shared memory: shared
// memory holds no more bytes in flight per SM than the register file, and
// a bulk-copy ring would add an mbarrier protocol and a shared-memory round
// trip per row.
//
// Lanes per dst row follow the row: a group of L lanes, L the power of two
// at or above row bytes / VB (VB the vector width below), at most a block.
// Each lane owns VB bytes of the row, so one pass covers it: f32 at
// D = 256 (1 KB) takes 64 lanes (two warps), bf16 32, int8 16 (two dst
// rows per warp), GAT layer 1's f32 D = 16 four (eight dst rows per warp);
// a row wider than 256 x VB loops. Groups never talk to each other, so a
// group may span warps.
//
// grad_w[n, k] = <g[n, :], x[adj[n, k], :]>. Bound by bytes: it reads the
// forward's rows again plus g (N x D x 4). A row at least a warp's vectors
// wide (f32 D >= 128 at 16-byte vectors; GAT layer 0) takes one warp per
// dst row; each slot's partial dot products are reduced by warp shuffles
// and written by lane 0. A narrower row would leave most of that warp's
// lanes empty (GAT layer 1, f32 D = 16: 4 live lanes of 32, its F slots one
// after another), so there each (dst row, slot) pair gets a lane group of
// lanes_for(row bytes) lanes, 32 / lanes dots per warp at once, reduced
// over the group's lanes only. The sums are bitwise the warp form's: a
// lane's partial is the same fmaf chain in both, the group's xor levels
// are the warp tree's lowest ones, and the warp tree's upper levels add
// +0 from lanes that hold no data. It is computed for EVERY slot, w == 0
// included: the forward may skip such a slot because it contributes
// nothing, but the derivative with respect to its weight is not zero.
//
// grad_x[s, :] = sum over the slots (n, k) with adj[n, k] = s, in slot
// order n * F + k, of w[n, k] * g[n, :]. Bound by bytes: it writes S x D x 4
// (277 MB at GAT layer 0) and reads g (25 MB) and the slots. Zero-filling
// the table and adding into it with atomics would move each output row
// across HBM three times (fill, atomic read, write-back). Instead it is a
// gather over the transpose of adj (row_ptr / slot, a CSR form): each row
// is written once, with no fill and no atomics, and the result is
// deterministic with repeated rows. A lane group owns kRowsPerGroup = 8
// consecutive table rows, whose slots are one contiguous range of the
// transpose; it walks that range in batches of kBatch slots (slot ids,
// then w, then the g rows of the live ones, all of a batch in flight),
// sums acc = acc + w * g in slot order (product and sum each rounded: the
// order and rounding of the plain index_add_), and stores each row as its
// slots end, zeros for a row no slot names, with streaming stores (__stcs,
// evict-first) so g's lines stay in L2. Eight rows per group put eight
// rows' reads behind one chain of dependent loads: GAT's layout names most
// rows once, and a group per row would wait out the chain row_ptr -> slot
// -> w -> g for every 1 KB it writes. A slot with w == 0 adds w * g = 0
// (g finite) and is skipped.
//
// The transpose (gather_spmm_adj_transpose): count per row (atomics), an
// exclusive scan, a placement by atomics, then an ordering pass that puts
// each row's slots in slot order: slot j lands at row_ptr[r] + #{slots of
// row r below j}, found by a walk over row r's placed slots. That walk
// costs sum over rows of (slots per row)^2: one per slot on GAT's
// contiguous layout, where every row is named by one slot, a few on a
// sampled layer's. Out-of-range indices are skipped; slot entries past
// row_ptr[S] hold -1. Its work is a few int32 per slot, so what bounds it
// is the chain of dependent passes, each a launch and a trip to device
// memory. Two forms, chosen by the shape alone:
//   - one launch, one block of kScanThreads, where the counts and the
//     placed slots (S + N * F int32) fit the block's shared memory (227 KB
//     on this card: the per-step adj of a sampled layer 1, S 6,144 x 5,120
//     slots, and GAT layer 1's kept one, S 24,576 x 20,480): every pass
//     runs in shared memory between barriers, and only adj (read once
//     where it fits the registers), row_ptr and slot touch device memory.
//     The placement's cursors are the scanned counts themselves: after it,
//     count[r] holds row r's end, so no memset and no scratch. One SM does
//     all of it, so the design counts its instructions and bank conflicts
//     (see the kernel);
//   - else (GAT layer 0: S 270,336 x 245,760 slots, 2 MB) the multi-pass
//     form over device-memory scratch: two memsets, count, a three-pass
//     scan over tiles, placement and ordering, each a grid of its own.
// GAT builds it once per shape (its adj depends only on shapes); a sampled
// layer whose input needs a gradient builds it every step.
//
// Vector width: each lane moves VB bytes per access, the largest of 16,
// 8, 4, 2, 1 that divides both D * sizeof(T) and the base addresses, so any
// D works (a bf16 row of width 100 starts only 8-byte aligned, and a
// 16-byte load there would fault). A slot whose index lies outside [0, S)
// is not read: its forward dst row and its grad_w entry come out NaN, so a
// bad frontier shows instead of faulting. Row offsets are 64-bit: adj * D
// passes 2^31 at 10M x 1024.
//
// The kernels allocate nothing, launch on the caller's stream and do not
// synchronise (the multi-pass transpose clears its scratch with
// cudaMemsetAsync on that stream). Each entry point returns
// cudaGetLastError(), or the error of a refused launch attribute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;     // forward, narrow grad_w, grad_x and
                                  // multi-pass transpose blocks
constexpr int kBatch = 4;         // slots whose reads are in flight together
constexpr int kRowsPerBlock = 8;  // grad_w, wide rows: one warp per dst row
constexpr int kRowsPerGroup = 8;  // grad_x: table rows per lane group
constexpr int kScanThreads = 1024;
constexpr int kSlotBatch = 8;     // one-block transpose: slots per thread
                                  // in registers (a sampled layer 1's all)
constexpr unsigned kFullMask = 0xffffffffu;

// VB bytes of a row, as one load.
template <int VB> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<1> { using type = unsigned char; };

// One table element -> f32: exact for all three types (bf16 is stored as
// its raw uint16 bits; widening is bits << 16).
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}
__device__ __forceinline__ float widen(int8_t v) {
  return static_cast<float>(v);
}

template <int VB>
__device__ __forceinline__ typename Raw<VB>::type load_raw(const void* p) {
  return __ldg(reinterpret_cast<const typename Raw<VB>::type*>(p));
}

// VB raw bytes of T -> VB / sizeof(T) floats.
template <typename T, int VB>
__device__ __forceinline__ void widen_raw(const typename Raw<VB>::type& r,
                                          float* v) {
  constexpr int E = VB / sizeof(T);
  T e[E];
  memcpy(e, &r, VB);
#pragma unroll
  for (int j = 0; j < E; ++j) v[j] = widen(e[j]);
}

// E consecutive f32 at p, 4E-byte aligned (E divides D).
template <int E>
__device__ __forceinline__ void load_f32(const float* p, float* v) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int j = 0; j < E; j += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p + j));
      v[j] = q.x; v[j + 1] = q.y; v[j + 2] = q.z; v[j + 3] = q.w;
    }
  } else if constexpr (E == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int E>
__device__ __forceinline__ void store_f32(float* p, const float* v) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int j = 0; j < E; j += 4)
      *reinterpret_cast<float4*>(p + j) =
          make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  } else if constexpr (E == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// store_f32 with evict-first streaming stores.
template <int E>
__device__ __forceinline__ void store_f32_cs(float* p, const float* v) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int j = 0; j < E; j += 4)
      __stcs(reinterpret_cast<float4*>(p + j),
             make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]));
  } else if constexpr (E == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    __stcs(p, v[0]);
  }
}

__device__ __forceinline__ bool out_of_range(int64_t idx, int64_t s) {
  return idx < 0 || idx >= s;
}

// f32 -> the nearest bf16 (ties to even) -> f32.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T, int VB, int KB, bool kRound>
__global__ void __launch_bounds__(kThreads)
gather_spmm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   const int32_t* __restrict__ adj,
                   const float* __restrict__ w, float* __restrict__ out,
                   int64_t s, int n, int f, int d, int lanes) {
  using R = typename Raw<VB>::type;
  constexpr int E = VB / sizeof(T);
  const int row = blockIdx.x * (kThreads / lanes) + threadIdx.x / lanes;
  if (row >= n) return;
  const int sub = threadIdx.x % lanes;
  const int32_t* adj_row = adj + (int64_t)row * f;
  const float* w_row = w + (int64_t)row * f;
  float* out_row = out + (int64_t)row * d;

  for (int c = sub * E; c < d; c += lanes * E) {  // one pass up to 256 x VB
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
    bool bad = false;
    for (int k0 = 0; k0 < f; k0 += KB) {
      int32_t idx[KB];
      float wk[KB];
      bool live[KB];
#pragma unroll
      for (int j = 0; j < KB; ++j) {          // indices and weights
        const bool in = k0 + j < f;
        idx[j] = in ? __ldg(adj_row + k0 + j) : 0;
        wk[j] = in ? __ldg(w_row + k0 + j) : 0.f;
        const bool oor = in && out_of_range(idx[j], s);
        bad |= oor;
        live[j] = in && !oor && wk[j] != 0.f;
      }
      R raw[KB];
      float sc[KB];
#pragma unroll
      for (int j = 0; j < KB; ++j) {          // every row read in flight
        if (live[j]) {
          raw[j] = load_raw<VB>(x + (int64_t)idx[j] * d + c);
          if constexpr (sizeof(T) == 1) sc[j] = __ldg(scale + idx[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < KB; ++j) {          // then the FMAs, in order
        if (!live[j]) continue;
        float v[E];
        widen_raw<T, VB>(raw[j], v);
        if constexpr (sizeof(T) == 1) {           // int8: dequantise first
#pragma unroll
          for (int e = 0; e < E; ++e) v[e] = v[e] * sc[j];
        }
        if constexpr (kRound) {                   // read as bf16
#pragma unroll
          for (int e = 0; e < E; ++e) v[e] = round_bf16(v[e]);
        }
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = fmaf(wk[j], v[e], acc[e]);
      }
    }
    if (bad) {
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = __int_as_float(0x7fc00000);
    }
    store_f32<E>(out_row + c, acc);
  }
}

template <typename T, int VB>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
grad_w_kernel(const T* __restrict__ x, const int32_t* __restrict__ adj,
              const float* __restrict__ g, float* __restrict__ gw,
              int64_t s, int n, int f, int d) {
  constexpr int E = VB / sizeof(T);
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= n) return;                     // whole warp: row is per warp
  const int32_t* adj_row = adj + (int64_t)row * f;
  const float* g_row = g + (int64_t)row * d;

  for (int k = 0; k < f; ++k) {
    const int64_t idx = adj_row[k];
    const bool bad = out_of_range(idx, s);
    float part = 0.f;
    if (!bad) {
      for (int c = lane * E; c < d; c += kWarp * E) {
        float v[E], gv[E];
        widen_raw<T, VB>(load_raw<VB>(x + idx * d + c), v);
        load_f32<E>(g_row + c, gv);
#pragma unroll
        for (int e = 0; e < E; ++e) part = fmaf(gv[e], v[e], part);
      }
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2)
      part += __shfl_xor_sync(kFullMask, part, off);
    if (lane == 0)
      gw[(int64_t)row * f + k] = bad ? __int_as_float(0x7fc00000) : part;
  }
}

// grad_w for rows narrower than a warp's vectors: a group of `lanes` (< 32)
// lanes per (dst row, slot) pair q = n * F + k, one pass over the row
// (lanes * E >= D). Every lane of a warp reaches the shuffles, pairs past
// the end included.
template <typename T, int VB>
__global__ void __launch_bounds__(kThreads)
grad_w_narrow_kernel(const T* __restrict__ x, const int32_t* __restrict__ adj,
                     const float* __restrict__ g, float* __restrict__ gw,
                     int64_t s, int64_t pairs, int f, int d, int lanes) {
  constexpr int E = VB / sizeof(T);
  const int64_t q =
      (int64_t)blockIdx.x * (kThreads / lanes) + threadIdx.x / lanes;
  const int sub = threadIdx.x % lanes;
  const bool in = q < pairs;
  const int64_t idx = in ? __ldg(adj + q) : 0;
  const bool bad = in && out_of_range(idx, s);
  const int c = sub * E;
  float part = 0.f;
  if (in && !bad && c < d) {
    float v[E], gv[E];
    widen_raw<T, VB>(load_raw<VB>(x + idx * d + c), v);
    load_f32<E>(g + (q / f) * d + c, gv);
#pragma unroll
    for (int e = 0; e < E; ++e) part = fmaf(gv[e], v[e], part);
  }
  for (int off = lanes / 2; off > 0; off /= 2)
    part += __shfl_xor_sync(kFullMask, part, off);
  if (in && sub == 0) gw[q] = bad ? __int_as_float(0x7fc00000) : part;
}

template <int VB>
__global__ void __launch_bounds__(kThreads)
grad_x_kernel(const int32_t* __restrict__ row_ptr,
              const int32_t* __restrict__ slot, const float* __restrict__ w,
              const float* __restrict__ g, float* __restrict__ gx, int64_t s,
              int f, int d, int lanes) {
  constexpr int E = VB / 4;
  const int64_t group =
      (int64_t)blockIdx.x * (kThreads / lanes) + threadIdx.x / lanes;
  const int64_t r_beg = group * kRowsPerGroup;
  if (r_beg >= s) return;
  const int64_t r_end = r_beg + kRowsPerGroup < s ? r_beg + kRowsPerGroup : s;
  const int sub = threadIdx.x % lanes;
  // the group's rows own the contiguous slot range [p_beg, p_end)
  const int p_beg = __ldg(row_ptr + r_beg), p_end = __ldg(row_ptr + r_end);

  for (int c = sub * E; c < d; c += lanes * E) {
    int64_t row = r_beg;
    int next = __ldg(row_ptr + row + 1);
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
    for (int p0 = p_beg; p0 < p_end; p0 += kBatch) {
      int32_t sl[kBatch];
      float wk[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        sl[j] = p0 + j < p_end ? __ldg(slot + p0 + j) : -1;
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        wk[j] = sl[j] >= 0 ? __ldg(w + sl[j]) : 0.f;
      float gv[kBatch][E];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)            // every g read in flight
        if (wk[j] != 0.f) load_f32<E>(g + (int64_t)(sl[j] / f) * d + c, gv[j]);
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {          // slot order
        if (sl[j] < 0) break;
        while (p0 + j >= next) {                  // rows finished before it
          store_f32_cs<E>(gx + row * d + c, acc);
#pragma unroll
          for (int e = 0; e < E; ++e) acc[e] = 0.f;
          next = __ldg(row_ptr + ++row + 1);
        }
        if (wk[j] == 0.f) continue;
#pragma unroll                                    // index_add_'s rounding:
        for (int e = 0; e < E; ++e)               // no FMA
          acc[e] = __fadd_rn(acc[e], __fmul_rn(wk[j], gv[j][e]));
      }
    }
    for (; row < r_end; ++row) {                  // the last row, then
      store_f32_cs<E>(gx + row * d + c, acc);     // rows without slots
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = 0.f;
    }
  }
}

// ---- the transpose of adj: row_ptr [S + 1], slot [N * F] ------------------

__global__ void __launch_bounds__(kThreads)
count_rows_kernel(const int32_t* __restrict__ adj, int64_t nf, int64_t s,
                  int32_t* __restrict__ counts) {
  for (int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x; j < nf;
       j += (int64_t)gridDim.x * kThreads) {
    const int64_t r = adj[j];
    if (!out_of_range(r, s)) atomicAdd(counts + r, 1);
  }
}

// Exclusive scan of v over the block -> (this thread's prefix, the block's
// total). Threads with nothing to add pass 0.
__device__ __forceinline__ int32_t block_scan(int32_t v, int32_t* total) {
  __shared__ int32_t warp_sums[kScanThreads / kWarp];
  const int lane = threadIdx.x % kWarp, wid = threadIdx.x / kWarp;
  int32_t incl = v;
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const int32_t u = __shfl_up_sync(kFullMask, incl, off);
    if (lane >= off) incl += u;
  }
  if (lane == kWarp - 1) warp_sums[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    const int32_t own = warp_sums[lane];
    int32_t wi = own;
#pragma unroll
    for (int off = 1; off < kWarp; off <<= 1) {
      const int32_t u = __shfl_up_sync(kFullMask, wi, off);
      if (lane >= off) wi += u;
    }
    warp_sums[lane] = wi - own;
    if (lane == kWarp - 1) *total = wi;
  }
  __syncthreads();
  const int32_t out = warp_sums[wid] + incl - v;
  __syncthreads();                    // warp_sums is reused by the next call
  return out;
}

// The exclusive scan of counts [s] into row_ptr [s + 1], in three passes
// over tiles of kScanThreads rows (one row per thread, coalesced): the
// tiles' sums, their scan by one block, each tile's scan plus its offset.
__global__ void __launch_bounds__(kScanThreads)
tile_sums_kernel(const int32_t* __restrict__ counts, int64_t s,
                 int32_t* __restrict__ tile_sums) {
  const int64_t i = (int64_t)blockIdx.x * kScanThreads + threadIdx.x;
  __shared__ int32_t total;
  block_scan(i < s ? counts[i] : 0, &total);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kScanThreads)
scan_tile_sums_kernel(int32_t* __restrict__ tile_sums, int64_t tiles,
                      int32_t* __restrict__ row_ptr, int64_t s) {
  __shared__ int32_t total;
  int32_t carry = 0;
  for (int64_t t0 = 0; t0 < tiles; t0 += kScanThreads) {  // in order
    const int64_t t = t0 + threadIdx.x;
    const int32_t v = t < tiles ? tile_sums[t] : 0;
    const int32_t excl = block_scan(v, &total);
    if (t < tiles) tile_sums[t] = carry + excl;
    carry += total;
    __syncthreads();
  }
  if (threadIdx.x == 0) row_ptr[s] = carry;
}

// Also clears counts: they become the placement's cursors.
__global__ void __launch_bounds__(kScanThreads)
scan_tiles_kernel(int32_t* __restrict__ counts, int64_t s,
                  const int32_t* __restrict__ tile_offsets,
                  int32_t* __restrict__ row_ptr) {
  const int64_t i = (int64_t)blockIdx.x * kScanThreads + threadIdx.x;
  __shared__ int32_t total;
  const int32_t excl = block_scan(i < s ? counts[i] : 0, &total);
  if (i < s) {
    row_ptr[i] = tile_offsets[blockIdx.x] + excl;
    counts[i] = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
place_slots_kernel(const int32_t* __restrict__ adj, int64_t nf, int64_t s,
                   const int32_t* __restrict__ row_ptr,
                   int32_t* __restrict__ cursor,
                   int32_t* __restrict__ placed) {
  for (int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x; j < nf;
       j += (int64_t)gridDim.x * kThreads) {
    const int64_t r = adj[j];
    if (!out_of_range(r, s))
      placed[row_ptr[r] + atomicAdd(cursor + r, 1)] = static_cast<int32_t>(j);
  }
}

__global__ void __launch_bounds__(kThreads)
order_slots_kernel(const int32_t* __restrict__ adj, int64_t nf, int64_t s,
                   const int32_t* __restrict__ row_ptr,
                   const int32_t* __restrict__ placed,
                   int32_t* __restrict__ slot) {
  for (int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x; j < nf;
       j += (int64_t)gridDim.x * kThreads) {
    const int64_t r = adj[j];
    if (out_of_range(r, s)) continue;
    const int beg = row_ptr[r], end = row_ptr[r + 1];
    int rank = 0;
    for (int p = beg; p < end; ++p) rank += placed[p] < j;
    slot[beg + rank] = static_cast<int32_t>(j);
  }
}

// kSlotBatch slots of adj from j0 on, one per kScanThreads stride, into r
// (-1 past nf): all reads in flight before any is used.
__device__ __forceinline__ void load_slots(const int32_t* __restrict__ adj,
                                           int j0, int nf, int32_t* r) {
#pragma unroll
  for (int b = 0; b < kSlotBatch; ++b) {
    const int j = j0 + b * kScanThreads + threadIdx.x;
    r[b] = j < nf ? __ldg(adj + j) : -1;
  }
}

// The whole transpose in one block of kScanThreads, s + nf <= 2^16: dynamic
// shared memory holds count [s] and placed [nf].
//   - count goes through three lives: the rows' counts, their exclusive
//     scan, and, as the placement's cursors advance, each row's end (row
//     r's slots then lie at [r ? count[r - 1] : 0, count[r]), and
//     row_ptr[r + 1] = count[r]).
//   - The scan: thread t sums rows [t * per, t * per + per) alone, one
//     block scan of those sums, then t writes its rows' prefixes. per is
//     odd, so a warp's 32 reads fall in 32 banks.
//   - A slot's row stays in registers from the count to the placement
//     where every slot fits one batch (nf <= kScanThreads * kSlotBatch),
//     else it is read again.
//   - placed[p] packs (row << 16 | slot), so the last pass walks the
//     positions p in order: it reads the row beside the slot, ranks the
//     slot among its row's placed slots (none on a row named once), and
//     its store lands at p itself where the row is named once: the stores
//     are coalesced, and adj is not read a third time.
__global__ void __launch_bounds__(kScanThreads)
transpose_one_block_kernel(const int32_t* __restrict__ adj, int s, int nf,
                           int32_t* __restrict__ row_ptr,
                           int32_t* __restrict__ slot) {
  extern __shared__ int32_t smem[];
  __shared__ int32_t total;
  int32_t* count = smem;
  uint32_t* placed = reinterpret_cast<uint32_t*>(smem + s);
  const int t = threadIdx.x;
  constexpr int kStep = kScanThreads * kSlotBatch;
  const bool held = nf <= kStep;

  int32_t r[kSlotBatch];
  load_slots(adj, 0, nf, r);            // in flight while count is zeroed
  for (int i = t; i < s; i += kScanThreads) count[i] = 0;
  __syncthreads();
  for (int j0 = 0; j0 < nf; j0 += kStep) {
    if (j0 > 0) load_slots(adj, j0, nf, r);
#pragma unroll
    for (int b = 0; b < kSlotBatch; ++b)
      if (!out_of_range(r[b], s)) atomicAdd(count + r[b], 1);
  }
  __syncthreads();
  const int per = ((s + kScanThreads - 1) / kScanThreads) | 1;
  const int lo = min(t * per, s), hi = min(lo + per, s);
  int32_t sum = 0;
  for (int i = lo; i < hi; ++i) sum += count[i];
  int32_t run = block_scan(sum, &total);
  for (int i = lo; i < hi; ++i) {
    const int32_t c = count[i];
    count[i] = run;
    run += c;
  }
  const int in_range = total;
  __syncthreads();
  for (int j0 = 0; j0 < nf; j0 += kStep) {   // placement, any order
    if (!held) load_slots(adj, j0, nf, r);
#pragma unroll
    for (int b = 0; b < kSlotBatch; ++b)
      if (!out_of_range(r[b], s))
        placed[atomicAdd(count + r[b], 1)] =
            static_cast<uint32_t>(r[b]) << 16 | (j0 + b * kScanThreads + t);
  }
  __syncthreads();
  for (int i = t; i <= s; i += kScanThreads)
    row_ptr[i] = i ? count[i - 1] : 0;
  for (int p = t; p < nf; p += kScanThreads) {  // each slot to its rank
    if (p >= in_range) {
      slot[p] = -1;
      continue;
    }
    const uint32_t v = placed[p];
    const int row = static_cast<int>(v >> 16);
    const int beg = row ? count[row - 1] : 0, end = count[row];
    int rank = 0;
    if (end - beg > 1)
      for (int q = beg; q < end; ++q) rank += placed[q] < v;
    slot[beg + rank] = static_cast<int32_t>(v & 0xffffu);
  }
}

// Largest vector width (bytes, at least sizeof(T)) that divides both the
// row's bytes and the base address of every row-major operand.
template <typename T>
int vec_bytes(int d, const void* a, const void* b = nullptr) {
  int vb = 16;
  const int64_t row_bytes = (int64_t)d * sizeof(T);
  while (vb > (int)sizeof(T) &&
         (row_bytes % vb || reinterpret_cast<uintptr_t>(a) % vb ||
          reinterpret_cast<uintptr_t>(b) % vb))
    vb >>= 1;
  return vb;
}

// Lanes per row: the power of two at or above row_bytes / vb, at most a
// block.
int lanes_for(int64_t row_bytes, int vb) {
  const int64_t need = (row_bytes + vb - 1) / vb;
  int lanes = 1;
  while (lanes < need && lanes < kThreads) lanes <<= 1;
  return lanes;
}

unsigned group_blocks(int64_t rows, int lanes) {
  const int64_t per = kThreads / lanes;
  return static_cast<unsigned>((rows + per - 1) / per);
}

unsigned stride_blocks(int64_t items) {
  const int64_t b = (items + kThreads - 1) / kThreads;
  return static_cast<unsigned>(b < 4096 ? (b > 0 ? b : 1) : 4096);
}

// Whether a grid of `blocks` is resident on the card at once (one wave).
template <typename K>
bool one_wave(K kernel, unsigned blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return blocks <= static_cast<unsigned>(per_sm) * sms;
}

template <typename T, bool kRound, int VB>
void forward_vb(const void* x, const void* scale, const void* adj,
                const void* w, void* out, int64_t s, int n, int f, int d,
                cudaStream_t stream) {
  if constexpr (VB >= (int)sizeof(T)) {
    const int lanes = lanes_for((int64_t)d * sizeof(T), VB);
    const unsigned blocks = group_blocks(n, lanes);
    // kBatch slots in flight, unless half as many (fewer registers, more
    // blocks per SM) let the whole grid be resident where kBatch does not:
    // then every row's chain of dependent reads is paid in one wave
    auto kernel = gather_spmm_kernel<T, VB, kBatch, kRound>;
    if (!one_wave(kernel, blocks) &&
        one_wave(gather_spmm_kernel<T, VB, kBatch / 2, kRound>, blocks))
      kernel = gather_spmm_kernel<T, VB, kBatch / 2, kRound>;
    kernel<<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(scale),
        static_cast<const int32_t*>(adj), static_cast<const float*>(w),
        static_cast<float*>(out), s, n, f, d, lanes);
  }
}

template <typename T, bool kRound = false>
int forward(const void* x, const void* scale, const void* adj, const void* w,
            void* out, int64_t s, int n, int f, int d, void* stream_p) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream_p);
  if (n > 0) {
    switch (vec_bytes<T>(d, x)) {
      case 16:
        forward_vb<T, kRound, 16>(x, scale, adj, w, out, s, n, f, d, st);
        break;
      case 8:
        forward_vb<T, kRound, 8>(x, scale, adj, w, out, s, n, f, d, st);
        break;
      case 4:
        forward_vb<T, kRound, 4>(x, scale, adj, w, out, s, n, f, d, st);
        break;
      case 2:
        forward_vb<T, kRound, 2>(x, scale, adj, w, out, s, n, f, d, st);
        break;
      default:
        forward_vb<T, kRound, 1>(x, scale, adj, w, out, s, n, f, d, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VB>
void grad_w_vb(const void* x, const void* adj, const void* g, void* gw,
               int64_t s, int n, int f, int d, cudaStream_t stream) {
  if constexpr (VB >= (int)sizeof(T)) {
    const int lanes = lanes_for((int64_t)d * sizeof(T), VB);
    if (lanes < kWarp) {
      const int64_t pairs = (int64_t)n * f;
      grad_w_narrow_kernel<T, VB><<<group_blocks(pairs, lanes), kThreads, 0,
                                    stream>>>(
          static_cast<const T*>(x), static_cast<const int32_t*>(adj),
          static_cast<const float*>(g), static_cast<float*>(gw), s, pairs, f,
          d, lanes);
    } else {
      grad_w_kernel<T, VB><<<(n + kRowsPerBlock - 1) / kRowsPerBlock,
                             kWarp * kRowsPerBlock, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const int32_t*>(adj),
          static_cast<const float*>(g), static_cast<float*>(gw), s, n, f, d);
    }
  }
}

template <typename T>
int grad_w(const void* x, const void* adj, const void* g, void* gw,
           int64_t s, int n, int f, int d, void* stream_p) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_p);
  if (n > 0) {
    // g is f32 [n, d], read E = VB / sizeof(T) floats at a time: E | d
    // keeps its rows aligned, and its base must be aligned to min(16, 4E)
    int vb = vec_bytes<T>(d, x);
    while (vb > (int)sizeof(T) &&
           reinterpret_cast<uintptr_t>(g) % (4 * vb / (int)sizeof(T) < 16
                                              ? 4 * vb / (int)sizeof(T)
                                              : 16))
      vb >>= 1;
    switch (vb) {
      case 16: grad_w_vb<T, 16>(x, adj, g, gw, s, n, f, d, stream); break;
      case 8: grad_w_vb<T, 8>(x, adj, g, gw, s, n, f, d, stream); break;
      case 4: grad_w_vb<T, 4>(x, adj, g, gw, s, n, f, d, stream); break;
      case 2: grad_w_vb<T, 2>(x, adj, g, gw, s, n, f, d, stream); break;
      default: grad_w_vb<T, 1>(x, adj, g, gw, s, n, f, d, stream); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <int VB>
void grad_x_vb(const void* row_ptr, const void* slot, const void* w,
               const void* g, void* gx, int64_t s, int f, int d,
               cudaStream_t stream) {
  const int lanes = lanes_for((int64_t)d * 4, VB);
  const int64_t groups = (s + kRowsPerGroup - 1) / kRowsPerGroup;
  grad_x_kernel<VB><<<group_blocks(groups, lanes), kThreads, 0, stream>>>(
      static_cast<const int32_t*>(row_ptr),
      static_cast<const int32_t*>(slot), static_cast<const float*>(w),
      static_cast<const float*>(g), static_cast<float*>(gx), s, f, d, lanes);
}

// The most int32 words (s + nf) the one-block transpose holds in one
// block's shared memory on the current device, its static shared memory
// left out, and at most 2^16 (a placed entry packs a row and a slot in 16
// bits each). The first call on a device raises the kernel's dynamic
// shared memory limit to that (above 48 KB it must be asked for) and keeps
// the answer, so a launch pays for neither; -1 if the device refused.
int64_t one_block_words() {
  constexpr int kMaxDevices = 64;
  static int64_t words[kMaxDevices] = {};   // 0: not asked yet
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return -1;
  if (words[dev] == 0) {
    int optin = 0;
    cudaFuncAttributes attr;
    if (cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess ||
        cudaFuncGetAttributes(&attr, transpose_one_block_kernel) !=
            cudaSuccess)
      return -1;
    const int bytes = optin - static_cast<int>(attr.sharedSizeBytes);
    if (cudaFuncSetAttribute(transpose_one_block_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes) != cudaSuccess)
      return -1;
    words[dev] = std::min(bytes / static_cast<int>(sizeof(int32_t)), 1 << 16);
  }
  return words[dev];
}

// The error a failed query left, never cudaSuccess.
int failed_query() {
  const cudaError_t err = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : cudaErrorUnknown);
}

}  // namespace

extern "C" {

// int32 scratch words the transpose of nf slots over s rows needs on the
// current device: 0 where one block holds it in shared memory (the
// one-launch form), else s + nf + its scan tiles (the multi-pass form);
// -1 if the device cannot be asked.
int64_t gather_spmm_transpose_scratch(int64_t s, int64_t nf) {
  const int64_t words = one_block_words();
  if (words < 0) return -1;
  return s + nf <= words ? 0 : s + nf + (s + kScanThreads - 1) / kScanThreads;
}

// x [s, d] f32, adj [n, f] int32, w [n, f] f32 -> out [n, d] f32.
int gather_spmm_f32(const void* x, const void* adj, const void* w, void* out,
                    int64_t s, int n, int f, int d, void* stream) {
  return forward<float>(x, nullptr, adj, w, out, s, n, f, d, stream);
}

// x [s, d] bf16 -> out [n, d] f32.
int gather_spmm_bf16(const void* x, const void* adj, const void* w, void* out,
                     int64_t s, int n, int f, int d, void* stream) {
  return forward<uint16_t>(x, nullptr, adj, w, out, s, n, f, d, stream);
}

// x [s, d] int8 with scale [s] f32 (row r is q[r] * scale[r]) -> out f32.
int gather_spmm_i8(const void* x, const void* scale, const void* adj,
                   const void* w, void* out, int64_t s, int n, int f, int d,
                   void* stream) {
  return forward<int8_t>(x, scale, adj, w, out, s, n, f, d, stream);
}

// x [s, d] f32 read as bf16: each element rounded to bf16 before its FMA.
int gather_spmm_f32_as_bf16(const void* x, const void* adj, const void* w,
                            void* out, int64_t s, int n, int f, int d,
                            void* stream) {
  return forward<float, true>(x, nullptr, adj, w, out, s, n, f, d, stream);
}

// int8 x with scale [s], each element dequantised (q * scale, f32) and then
// rounded to bf16 before its FMA.
int gather_spmm_i8_as_bf16(const void* x, const void* scale, const void* adj,
                           const void* w, void* out, int64_t s, int n, int f,
                           int d, void* stream) {
  return forward<int8_t, true>(x, scale, adj, w, out, s, n, f, d, stream);
}

// grad_w [n, f] f32 from x [s, d] f32 and g [n, d] f32 (16-byte aligned).
int gather_spmm_grad_w_f32(const void* x, const void* adj, const void* g,
                           void* gw, int64_t s, int n, int f, int d,
                           void* stream) {
  return grad_w<float>(x, adj, g, gw, s, n, f, d, stream);
}

// the same with a bf16 table.
int gather_spmm_grad_w_bf16(const void* x, const void* adj, const void* g,
                            void* gw, int64_t s, int n, int f, int d,
                            void* stream) {
  return grad_w<uint16_t>(x, adj, g, gw, s, n, f, d, stream);
}

// The transpose of adj [nf] (int32, rows in [0, s)): row_ptr [s + 1] and
// slot [nf] (each row's slots in slot order; -1 past row_ptr[s]). scratch
// is int32 [gather_spmm_transpose_scratch(s, nf)], null where that is 0:
// then one launch, else the multi-pass form's eight device operations.
int gather_spmm_adj_transpose(const void* adj, void* row_ptr, void* slot,
                              void* scratch, int64_t s, int64_t nf,
                              void* stream_p) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream_p);
  const int32_t* a = static_cast<const int32_t*>(adj);
  int32_t* rp = static_cast<int32_t*>(row_ptr);
  const int64_t need = gather_spmm_transpose_scratch(s, nf);
  if (need < 0) return failed_query();
  if (need == 0) {
    const int bytes = static_cast<int>((s + nf) * sizeof(int32_t));
    transpose_one_block_kernel<<<1, kScanThreads, bytes, st>>>(
        a, static_cast<int>(s), static_cast<int>(nf), rp,
        static_cast<int32_t*>(slot));
    return static_cast<int>(cudaGetLastError());
  }
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int32_t* counts = static_cast<int32_t*>(scratch);
  int32_t* placed = counts + s;
  int32_t* tile_sums = placed + nf;
  const int64_t tiles = (s + kScanThreads - 1) / kScanThreads;
  cudaMemsetAsync(counts, 0, s * sizeof(int32_t), st);
  cudaMemsetAsync(slot, 0xff, nf * sizeof(int32_t), st);
  const unsigned blocks = stride_blocks(nf);
  if (nf > 0) count_rows_kernel<<<blocks, kThreads, 0, st>>>(a, nf, s, counts);
  if (tiles > 0) {
    tile_sums_kernel<<<static_cast<unsigned>(tiles), kScanThreads, 0, st>>>(
        counts, s, tile_sums);
  }
  scan_tile_sums_kernel<<<1, kScanThreads, 0, st>>>(tile_sums, tiles, rp, s);
  if (tiles > 0) {
    scan_tiles_kernel<<<static_cast<unsigned>(tiles), kScanThreads, 0, st>>>(
        counts, s, tile_sums, rp);
  }
  if (nf > 0) {
    place_slots_kernel<<<blocks, kThreads, 0, st>>>(a, nf, s, rp, counts,
                                                    placed);
    order_slots_kernel<<<blocks, kThreads, 0, st>>>(
        a, nf, s, rp, placed, static_cast<int32_t*>(slot));
  }
  return static_cast<int>(cudaGetLastError());
}

// gx [s, d] f32 = the gather over the transpose (row_ptr [s + 1], slot
// [n * f]) of w[slot] * g[slot / f]; every row written.
int gather_spmm_grad_x(const void* row_ptr, const void* slot, const void* w,
                       const void* g, void* gx, int64_t s, int f, int d,
                       void* stream_p) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream_p);
  if (s > 0) {
    switch (vec_bytes<float>(d, g, gx)) {
      case 16: grad_x_vb<16>(row_ptr, slot, w, g, gx, s, f, d, st); break;
      case 8: grad_x_vb<8>(row_ptr, slot, w, g, gx, s, f, d, st); break;
      default: grad_x_vb<4>(row_ptr, slot, w, g, gx, s, f, d, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Name of a CUDA error code, for the wrapper's exception message.
const char* gather_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
