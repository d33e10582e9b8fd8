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
// grad_w[n, k] = <g[n, :], x[adj[n, k], :]>. Bound by bytes: it reads
// each distinct row of a dst row's slots once, g (N x D x 4) and adj, and
// writes N x F. It is computed for EVERY slot, w == 0 included: the
// forward may skip such a slot because it contributes nothing, but the
// derivative with respect to its weight is not zero.
//
// The wide form: a row at least a warp's vectors wide (f32 D >= 128, bf16
// D >= 256 at 16-byte vectors; layer 0 of GAT and RGAT) takes one warp per
// dst row. Where its time goes is the same latency as the forward's, plus
// repeats: the stacked relations' host layout points every dead slot at
// its own dst row (ops/aggregate.py live_or_own), so most of a dst row's
// slots name one row (8 relations, a fifth of slots masked: ~90% of them,
// the other relations' and the masked ones). A slot at a time (load the
// index, then the row and g, reduce, store) would read 2 KB per slot and
// keep one row read in flight per warp. So, per dst row:
//   1. g once: each lane loads its share of g[n] into registers (8
//      floats: a pass of kPassCols = 256 columns), before the indices'
//      load returns. Wider rows take passes of 256 columns, each loading
//      its slice of g once per group of distinct rows below.
//   2. indices once, repeats once: lane k loads slot k's index (32 slots
//      a chunk, one coalesced load), __match_any_sync names each slot's
//      first occurrence in the chunk, and a ballot gives the distinct
//      rows in slot order. Only they are read and reduced; a repeat takes
//      its first occurrence's dot, the same row against the same g in the
//      same order, so the same bits. Out-of-range slots read nothing and
//      come out NaN. Chunks do not share: F > 32 reads a row again in a
//      later chunk (bitwise the same dot).
//   3. reads in flight: the distinct rows go in batches, every lane's
//      vectors of a batch loaded before its FMAs, kDotVecs = 2 vectors in
//      flight per lane (f32 at D = 256: a row's 2 vectors, one row a
//      batch; bf16: 2 rows). What keeps the card's memory busy here is
//      resident warps more than rows per warp: at 16-byte vectors a lane
//      takes 46-48 registers (ptxas, no spill), so 5 blocks, 40 warps,
//      fit an SM. 4 vectors a lane (kDotVecs = 4: 54-59 registers, 32
//      warps) were 0.1-3.6% slower at the layer-0 shapes of GAT and RGAT
//      (chip_compare.py against a checkout so set).
//   4. one reduction for up to kDots = 4 dots: each lane keeps a partial
//      per distinct row in registers (the fmaf chain over its vectors in
//      column order, as before), and reduce_dots sums P of them together
//      (P the power of two at or above their count): a transposed
//      butterfly that halves the values a lane holds at each of the first
//      log2 P xor levels, so lane j * 32 / P ends with dot j; P - 1 + 5 -
//      log2 P shuffles for P dots (6 for 4), not 5 P. Every dot is summed
//      over the lanes in the tree of xor levels 16, 8, 4, 2, 1, so its
//      bits depend neither on its group nor on the repeats: they are those
//      of a warp that reduces each slot alone over the same lane partials.
//      Lane i then holds the i-th distinct row's dot, and each slot's lane
//      takes its first occurrence's with one shuffle: the chunk leaves as
//      one coalesced store, not one store per slot from lane 0. Eight dots
//      a group (kDots = 8 with a reduce_dots<8> branch, 48 registers) were
//      no faster (0.998-1.004x the time).
//   5. not used: a TMA ring, cp.async stages or shared memory. The rows
//      are random 1 KB reads that registers hold as well as a staged ring
//      would (the forward's argument), g is read once into registers, and
//      nothing is shared between warps: a warp's distinct rows come from
//      its own 32 indices.
// The narrow form: a narrower row would leave most of that warp's lanes
// empty (GAT layer 1, f32 D = 16: 4 live lanes of 32, its F slots one
// after another), so there each (dst row, slot) pair gets a lane group of
// lanes_for(row bytes) lanes, 32 / lanes dots per warp at once, reduced
// over the group's lanes only (repeats read again: its reads are a few
// dozen bytes). Its sums are bitwise the 32-lane xor tree's: a lane's
// partial is the same fmaf chain, the group's xor levels are the tree's
// lowest ones, and the tree's upper levels add +0 from lanes that hold no
// data.
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
// exclusive scan, a placement by atomics in any order, then an ordering
// that puts each row's slots in slot order. Out-of-range indices are
// skipped; slot entries past row_ptr[S] hold -1. Its work is a few int32
// per slot, so what bounds it is the chain of dependent passes: each pass
// is short (a few MB at most), and the time goes into what separates them.
// So each of its two forms is one launch, its passes separated by barriers
// on chip:
//   - one block of kScanThreads, where the counts and the placed slots
//     (S + N * F int32, at most 2^16) fit the block's shared memory (227 KB
//     on this card: the per-step adj of a sampled layer 1, S 6,144 x 5,120
//     slots, and GAT layer 1's kept one, S 24,576 x 20,480): every pass
//     runs in shared memory between __syncthreads, and only adj (read once
//     where it fits the registers), row_ptr and slot touch device memory.
//     The placement's cursors are the scanned counts themselves: after it,
//     count[r] holds row r's end, so no memset and no scratch. One SM does
//     all of it, so the design counts its instructions and bank conflicts
//     (see the kernel);
//   - above that (GAT layer 0, 516k words; RGAT's stacked layers 1 and 0,
//     135k and 1.5M words) a cooperative grid of resident blocks, the
//     passes between grid.sync(), the counts and the placed slots in
//     device-memory scratch that the kernel zeroes itself (the 50 MB L2
//     holds it). Its ordering ranks each row's placed slots with work per
//     row, not per slot: one lane's registers up to kLaneSlots (16) slots,
//     a warp's lanes up to 32, and a longer row a whole block through a
//     bitmap of its slots in shared memory (rank_long_row), so a skewed
//     row (a layout's padding naming a few rows) costs its bitmap, not
//     deg^2. Counting and placement aggregate a warp's atomics per row
//     (__match_any_sync).
// The form is chosen before the launch by the shape and by what the device
// was asked once (shared memory, resident blocks); a refused launch is an
// error, never a retry in another form. GAT builds it once per shape (its
// adj depends only on shapes); a sampled layer whose input needs a
// gradient builds it every step.
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
// synchronise; the transpose's grid form zeroes its own scratch. Each
// entry point returns cudaGetLastError(), or the error of a refused launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;     // forward, narrow grad_w and grad_x
                                  // blocks
constexpr int kBatch = 4;         // slots whose reads are in flight together
constexpr int kRowsPerBlock = 8;  // grad_w, wide rows: one warp per dst row
constexpr int kPassCols = 256;    // grad_w, wide rows: g's columns a warp
                                  // holds in registers (8 a lane)
constexpr int kDots = 4;          // grad_w, wide rows: distinct rows whose
                                  // dots are reduced together
constexpr int kDotVecs = 2;       // grad_w, wide rows: row vectors in
                                  // flight per lane
constexpr int kRowsPerGroup = 8;  // grad_x: table rows per lane group
constexpr int kScanThreads = 1024;  // transpose blocks
constexpr int kSlotBatch = 8;     // transpose: slots per thread in
                                  // registers (a sampled layer 1's all)
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

// P dots' lane partials v[0..P-1] (P a power of two, at most 32) summed
// over the warp together. At each of the first log2 P xor levels (offsets
// 16, 8, ...) a lane keeps half of its values and sends the other half to
// its partner, which adds them to its own; after them lane l holds value
// l / (32 / P) alone, and the remaining levels are the plain xor tree.
// Every value is summed over the lanes in the tree of __shfl_xor_sync
// levels 16, 8, 4, 2, 1, so each sum is bitwise that tree's.
template <int P>
__device__ __forceinline__ float reduce_dots(float* v, int lane) {
#pragma unroll
  for (int h = P / 2, off = kWarp / 2; h >= 1; h /= 2, off /= 2) {
    const bool up = lane & off;
#pragma unroll
    for (int j = 0; j < h; ++j) {
      const float send = up ? v[j] : v[j + h];
      const float keep = up ? v[j + h] : v[j];
      v[j] = keep + __shfl_xor_sync(kFullMask, send, off);
    }
  }
  float sum = v[0];
#pragma unroll
  for (int off = kWarp / (2 * P); off > 0; off /= 2)
    sum += __shfl_xor_sync(kFullMask, sum, off);
  return sum;
}

// g's columns [c0, c0 + kPassCols) of one dst row into a lane's registers:
// vector ch at column c0 + ch * 32 E + lane E, where it lies below d.
template <int E, int NC>
__device__ __forceinline__ void load_g_pass(const float* g_row, int c0, int d,
                                            int lane, float (&gv)[NC][E]) {
#pragma unroll
  for (int ch = 0; ch < NC; ++ch) {
    const int c = c0 + ch * kWarp * E + lane * E;
    if (c < d) load_f32<E>(g_row + c, gv[ch]);
  }
}

// grad_w for rows at least a warp's vectors wide: one warp per dst row
// (see the note at the top).
template <typename T, int VB>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
grad_w_kernel(const T* __restrict__ x, const int32_t* __restrict__ adj,
              const float* __restrict__ g, float* __restrict__ gw,
              int64_t s, int n, int f, int d) {
  using R = typename Raw<VB>::type;
  constexpr int E = VB / sizeof(T);
  constexpr int NC = kPassCols / (kWarp * E);   // vectors a lane holds
  constexpr int KB = NC < kDotVecs ? kDotVecs / NC : 1;   // rows a batch
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= n) return;                     // whole warp: row is per warp
  const int32_t* adj_row = adj + (int64_t)row * f;
  const float* g_row = g + (int64_t)row * d;
  const bool one_pass = d <= kPassCols;

  float gv[NC][E];
  if (one_pass) load_g_pass<E, NC>(g_row, 0, d, lane, gv);   // g once

  for (int k0 = 0; k0 < f; k0 += kWarp) {   // kWarp slots at a time
    const bool in = k0 + lane < f;
    const int32_t idx = in ? __ldg(adj_row + k0 + lane) : -1;
    const bool bad = in && out_of_range(idx, s);
    // a slot's first occurrence in the chunk; the distinct rows to read
    const int first = __ffs(__match_any_sync(kFullMask, idx)) - 1;
    const unsigned todo =
        __ballot_sync(kFullMask, in && !bad && first == lane);
    const int nd = __popc(todo);
    float dot = 0.f;          // lane i: the dot of the i-th distinct row
    unsigned rest = todo;
    for (int i0 = 0; i0 < nd; i0 += kDots) {
      float part[kDots];
#pragma unroll
      for (int i = 0; i < kDots; ++i) part[i] = 0.f;
      for (int c0 = 0; c0 < d; c0 += kPassCols) {
        if (!one_pass) load_g_pass<E, NC>(g_row, c0, d, lane, gv);
        unsigned left = rest;
#pragma unroll
        for (int b = 0; b < kDots; b += KB) {
          if (i0 + b >= nd) break;
          R raw[KB][NC];
#pragma unroll
          for (int j = 0; j < KB; ++j) {      // the batch's reads in flight
            const int64_t r =
                __shfl_sync(kFullMask, idx, (__ffs(left) - 1) & (kWarp - 1));
            left &= left - 1;
            if (i0 + b + j < nd) {
#pragma unroll
              for (int ch = 0; ch < NC; ++ch) {
                const int c = c0 + ch * kWarp * E + lane * E;
                if (c < d) raw[j][ch] = load_raw<VB>(x + r * d + c);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < KB; ++j) {      // then the FMAs
            if (i0 + b + j >= nd) break;
#pragma unroll
            for (int ch = 0; ch < NC; ++ch) {
              const int c = c0 + ch * kWarp * E + lane * E;
              if (c >= d) continue;
              float v[E];
              widen_raw<T, VB>(raw[j][ch], v);
#pragma unroll
              for (int e = 0; e < E; ++e)
                part[b + j] = fmaf(gv[ch][e], v[e], part[b + j]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kDots; ++i) rest &= rest - 1;
      // the group's m dots reduced together, dot j landing on lane j * 32/P
      const int m = nd - i0 < kDots ? nd - i0 : kDots;
      float sum;
      int shift;
      if (m == 1) {
        sum = reduce_dots<1>(part, lane), shift = 5;
      } else if (m == 2) {
        sum = reduce_dots<2>(part, lane), shift = 4;
      } else {
        sum = reduce_dots<4>(part, lane), shift = 3;
      }
      const int src = (static_cast<unsigned>(lane - i0) << shift) % kWarp;
      const float got = __shfl_sync(kFullMask, sum, src);
      if (lane >= i0 && lane < i0 + kDots) dot = got;
    }
    // each slot takes its first occurrence's dot: one coalesced store
    const float out = __shfl_sync(
        kFullMask, dot, __popc(todo & ((1u << first) - 1)));
    if (in)
      gw[(int64_t)row * f + k0 + lane] =
          bad ? __int_as_float(0x7fc00000) : out;
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

// ---- the transpose above one block: the grid form -------------------------
//
// One cooperative launch: the one-block passes (count, scan, placement,
// ordering) run across a grid of resident blocks, separated by
// grid.sync(). Block b owns rows [b * per, (b + 1) * per): it zeroes and
// scans their counts (each thread a run of rows) and writes their row_ptr.
// The counts and the placed slots live in device-memory scratch, which the
// kernel zeroes itself and the 50 MB L2 holds; what another block wrote is
// read with __ldcg, from L2 past this SM's L1. The placement runs in any
// order; the ordering then ranks each row's placed slots with work per
// row, not per slot. The rows go to the warps in tiles of 32, dealt round
// the grid (a layout's heavy rows are contiguous, and contiguous ownership
// gave their blocks all the work): a row of at most kLaneSlots slots is
// ranked by one lane in registers, one of at most 32 by the lanes of its
// warp, and a longer row is listed and ranked later by a whole block
// (rank_long_row: a bitmap of its slots in shared memory, O(deg + slot
// range / 32)), the list dealt round the blocks, so a few heavy rows (the
// padding naming rows 0-3) cost their bitmaps, not deg^2. Counting and
// placement send one atomic per row and warp (__match_any_sync).

constexpr int kLaneSlots = 16;    // rows of at most this many: one lane
constexpr int kWindow = 8192;     // rank_long_row's bitmap words; the
                                  // block's shared memory is 2 x kWindow

// kSlotBatch slots' rows, slot j = j0 + k * step + threadIdx.x for batch
// entry k, into r: -1 past nf or out of range.
__device__ __forceinline__ void load_rows(const int32_t* __restrict__ adj,
                                          int64_t j0, int64_t step,
                                          int64_t nf, int s, int32_t* r) {
#pragma unroll
  for (int k = 0; k < kSlotBatch; ++k) {
    const int64_t j = j0 + k * step + threadIdx.x;
    const int32_t v = j < nf ? __ldg(adj + j) : -1;
    r[k] = v >= 0 && v < s ? v : -1;
  }
}

// Each lane's row r (-1: none) gets one more slot: lanes of the warp that
// name the same row add to count[r] once, through their leader, and each
// gets the old count plus its rank among them (lane order, which is slot
// order). Every lane of the warp calls it.
__device__ __forceinline__ int32_t add_slot(int32_t* count, int32_t r) {
  const unsigned peers = __match_any_sync(kFullMask, r);
  const int lane = threadIdx.x % kWarp, leader = __ffs(peers) - 1;
  int32_t base = 0;
  if (r >= 0 && lane == leader) base = atomicAdd(count + r, __popc(peers));
  base = __shfl_sync(kFullMask, base, leader);
  return base + __popc(peers & ((1u << lane) - 1));
}

// A row's placed slots, read k = 0, 1, ...: from the tile's copy in
// shared memory, or from the placed scratch.
struct SharedSeg {
  const int32_t* p;
  __device__ int32_t operator()(int k) const { return p[k]; }
};
struct PlacedSeg {
  const int32_t* p;
  __device__ int32_t operator()(int k) const { return __ldcg(p + k); }
};

// A row of 1 <= d <= kLaneSlots placed slots, sorted by one lane in
// registers (above 2 slots a bitonic network over kLaneSlots, INT32_MAX
// past d) and stored at out[0, d) (out may be the source).
template <class Seg>
__device__ __forceinline__ void lane_rank(Seg seg, int32_t* out, int d) {
  if (d <= 2) {                         // most sampled rows: no network
    const int32_t a = seg(0), z = d == 2 ? seg(1) : a;
    out[0] = min(a, z);
    if (d == 2) out[1] = max(a, z);
    return;
  }
  int32_t v[kLaneSlots];
#pragma unroll
  for (int k = 0; k < kLaneSlots; ++k) v[k] = k < d ? seg(k) : INT32_MAX;
#pragma unroll
  for (int k = 2; k <= kLaneSlots; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < kLaneSlots; ++i) {
        const int c = j == k >> 1 ? i ^ (k - 1) : i ^ j;
        if (c > i) {
          const int32_t a = min(v[i], v[c]), z = max(v[i], v[c]);
          v[i] = a;
          v[c] = z;
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kLaneSlots; ++k)
    if (k < d) out[k] = v[k];
}

// A row of d <= 32 placed slots, ranked by the lanes of one warp (every
// lane calls it with the same row): lane l holds slot l, its rank is the
// number of the row's slots below it. Every lane reads before any writes,
// so out may be the source.
template <class Seg>
__device__ __forceinline__ void warp_rank(Seg seg, int32_t* out, int d) {
  const int lane = threadIdx.x % kWarp;
  const int32_t v = lane < d ? seg(lane) : INT32_MAX;
  int rank = 0;
  for (int q = 0; q < d; ++q) rank += __shfl_sync(kFullMask, v, q) < v;
  if (lane < d) out[rank] = v;
}

// kSlotBatch of a row's placed slots seg[0, d), i = i0 + k * kScanThreads +
// threadIdx.x for batch entry k, into v: -1 past d.
__device__ __forceinline__ void load_seg(const int32_t* seg, int d, int i0,
                                         int32_t* v) {
#pragma unroll
  for (int k = 0; k < kSlotBatch; ++k) {
    const int i = i0 + k * kScanThreads + threadIdx.x;
    v[k] = i < d ? __ldcg(seg + i) : -1;
  }
}

// A long row's d placed slots seg[0, d), ranked by the block into
// slot[beg, beg + d): the slots' range [lo, hi] in windows of kWindow
// words x 32 bits; in each, a bit per slot (bits), the exclusive scan of
// the words' popcounts (pre), and a slot's rank is carry + pre[word] + the
// bits below it. The slots stay in registers where one batch holds them.
// Every thread of the block calls it.
__device__ void rank_long_row(const int32_t* seg, int32_t* __restrict__ slot,
                              int beg, int d, uint32_t* bits, int32_t* pre) {
  __shared__ int32_t lo_s, hi_s, total;
  constexpr int kStep = kScanThreads * kSlotBatch;
  const int t = threadIdx.x, lane = t % kWarp;
  const bool held = d <= kStep;
  if (t == 0) {
    lo_s = INT32_MAX;
    hi_s = -1;
  }
  int32_t v[kSlotBatch];
  int32_t lo = INT32_MAX, hi = -1;
  for (int i0 = 0; i0 < d; i0 += kStep) {
    load_seg(seg, d, i0, v);
#pragma unroll
    for (int k = 0; k < kSlotBatch; ++k) {
      if (v[k] < 0) continue;
      lo = min(lo, v[k]);
      hi = max(hi, v[k]);
    }
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) {
    lo = min(lo, __shfl_xor_sync(kFullMask, lo, off));
    hi = max(hi, __shfl_xor_sync(kFullMask, hi, off));
  }
  __syncthreads();
  if (lane == 0) {
    atomicMin(&lo_s, lo);
    atomicMax(&hi_s, hi);
  }
  __syncthreads();
  const int32_t first = lo_s, last = hi_s;
  int32_t carry = 0;
  for (int64_t base = first; base <= last; base += (int64_t)kWindow * 32) {
    const int64_t need = (last - base) / 32 + 1;
    const int words = static_cast<int>(need < kWindow ? need : kWindow);
    const int64_t top = base + (int64_t)words * 32;
    for (int w = t; w < words; w += kScanThreads) bits[w] = 0;
    __syncthreads();
    for (int i0 = 0; i0 < d; i0 += kStep) {
      if (!held) load_seg(seg, d, i0, v);
#pragma unroll
      for (int k = 0; k < kSlotBatch; ++k) {
        if (v[k] < base || v[k] >= top) continue;
        const int x = static_cast<int>(v[k] - base);
        atomicOr(bits + (x >> 5), 1u << (x & 31));
      }
    }
    __syncthreads();
    const int per = (words + kScanThreads - 1) / kScanThreads;
    const int w0 = min(t * per, words), w1 = min(w0 + per, words);
    int32_t sum = 0;
    for (int w = w0; w < w1; ++w) sum += __popc(bits[w]);
    int32_t run = carry + block_scan(sum, &total);
    for (int w = w0; w < w1; ++w) {
      pre[w] = run;
      run += __popc(bits[w]);
    }
    __syncthreads();
    for (int i0 = 0; i0 < d; i0 += kStep) {
      if (!held) load_seg(seg, d, i0, v);
#pragma unroll
      for (int k = 0; k < kSlotBatch; ++k) {
        if (v[k] < base || v[k] >= top) continue;
        const int x = static_cast<int>(v[k] - base);
        const uint32_t below = bits[x >> 5] & ((1u << (x & 31)) - 1);
        slot[beg + pre[x >> 5] + __popc(below)] = v[k];
      }
    }
    carry += total;
    __syncthreads();                  // bits and pre: the next window's
  }
}

// The grid form, launched cooperatively with every block resident.
// scratch: count [s], the blocks' totals [gridDim.x], n_long, the long
// rows (more than a warp's slots) [nf / 33], placed [nf]. buf: 2 x kWindow
// words of shared memory, for the scan's counts, the ordering's tiles (a
// share per warp) and rank_long_row's bitmap.
__global__ void __launch_bounds__(kScanThreads)
transpose_grid_kernel(const int32_t* __restrict__ adj, int s, int nf,
                      int32_t* __restrict__ row_ptr,
                      int32_t* __restrict__ slot,
                      int32_t* __restrict__ scratch) {
  extern __shared__ int32_t buf[];
  __shared__ int32_t total, offset_s, grand_s;
  cg::grid_group grid = cg::this_grid();
  const int t = threadIdx.x, lane = t % kWarp;
  const int b = static_cast<int>(blockIdx.x), nb = static_cast<int>(gridDim.x);
  int32_t* count = scratch;
  int32_t* totals = count + s;
  int32_t* n_long = totals + nb;
  int32_t* longs = n_long + 1;
  int32_t* placed = longs + nf / (kWarp + 1);
  const int64_t per = ((int64_t)s + nb - 1) / nb;
  const int lo = static_cast<int>(b * per < s ? b * per : s);
  const int own = static_cast<int>(lo + per < s ? lo + per : s) - lo;
  int32_t* own_count = count + lo;

  for (int i = t; i < own; i += kScanThreads) own_count[i] = 0;
  if (b == 0 && t == 0) *n_long = 0;
  grid.sync();

  // count, the slots' rows kept in registers where one batch holds them
  const int64_t step = (int64_t)nb * kScanThreads, chunk = step * kSlotBatch;
  const int64_t first = (int64_t)b * kScanThreads;
  const bool held = nf <= chunk;
  int32_t r[kSlotBatch];
  for (int64_t j0 = 0; j0 < nf; j0 += chunk) {
    load_rows(adj, j0 + first, step, nf, s, r);
#pragma unroll
    for (int k = 0; k < kSlotBatch; ++k) add_slot(count, r[k]);
  }
  grid.sync();

  // scan of the own rows: where the shared buffer holds them, read
  // coalesced into it, thread t scans a run of consecutive rows there, and
  // the prefixes wait there for the offset; else in tiles of kScanThreads
  const bool staged = own <= 2 * kWindow;
  int32_t carry = 0;
  if (staged) {
    for (int i0 = t; i0 < own; i0 += kScanThreads * kSlotBatch) {
      int32_t c[kSlotBatch];
#pragma unroll
      for (int k = 0; k < kSlotBatch; ++k) {
        const int i = i0 + k * kScanThreads;
        c[k] = i < own ? __ldcg(own_count + i) : 0;
      }
#pragma unroll
      for (int k = 0; k < kSlotBatch; ++k)
        if (i0 + k * kScanThreads < own) buf[i0 + k * kScanThreads] = c[k];
    }
    __syncthreads();
    const int per_t = ((own + kScanThreads - 1) / kScanThreads) | 1;
    const int i0 = min(t * per_t, own), i1 = min(i0 + per_t, own);
    int32_t sum = 0;
    for (int i = i0; i < i1; ++i) sum += buf[i];
    int32_t run = block_scan(sum, &total);
    for (int i = i0; i < i1; ++i) {
      const int32_t c = buf[i];
      buf[i] = run;
      run += c;
    }
    carry = total;
  } else {
    for (int i0 = 0; i0 < own; i0 += kScanThreads) {
      const int i = i0 + t;
      const int32_t c = i < own ? __ldcg(own_count + i) : 0;
      const int32_t excl = block_scan(c, &total);
      if (i < own) own_count[i] = carry + excl;
      carry += total;
    }
  }
  if (t == 0) totals[b] = carry;
  grid.sync();
  if (t < kWarp) {
    int32_t before = 0, all = 0;
    for (int q0 = lane; q0 < nb; q0 += kWarp * kSlotBatch) {
      int32_t v[kSlotBatch];
#pragma unroll
      for (int k = 0; k < kSlotBatch; ++k) {
        const int q = q0 + k * kWarp;
        v[k] = q < nb ? __ldcg(totals + q) : 0;
      }
#pragma unroll
      for (int k = 0; k < kSlotBatch; ++k) {
        all += v[k];
        before += q0 + k * kWarp < b ? v[k] : 0;
      }
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) {
      all += __shfl_xor_sync(kFullMask, all, off);
      before += __shfl_xor_sync(kFullMask, before, off);
    }
    if (lane == 0) {
      offset_s = before;
      grand_s = all;
    }
  }
  __syncthreads();
  const int32_t offset = offset_s, grand = grand_s;
  for (int i = t; i < own; i += kScanThreads) {
    const int32_t v = (staged ? buf[i] : __ldcg(own_count + i)) + offset;
    own_count[i] = v;
    row_ptr[lo + i] = v;
  }
  if (b == 0 && t == 0) row_ptr[s] = grand;
  grid.sync();

  // placement, any order: count[r] advances to row r's end
  for (int64_t j0 = 0; j0 < nf; j0 += chunk) {
    if (!held) load_rows(adj, j0 + first, step, nf, s, r);
#pragma unroll
    for (int k = 0; k < kSlotBatch; ++k) {
      const int32_t p = add_slot(count, r[k]);
      if (r[k] >= 0)
        placed[p] = static_cast<int32_t>(j0 + first + k * step + t);
    }
  }
  for (int64_t p = grand + first + t; p < nf; p += step) slot[p] = -1;
  grid.sync();

  // ordering: tiles of 32 rows dealt round the grid's warps, a lane per
  // row. A tile's slots are one range of placed; where the warp's share of
  // buf holds it, the warp copies it in coalesced, ranks its rows there
  // and copies it out coalesced to slot, else its rows read and write
  // their own slots. Rows of more than a warp's slots are listed.
  constexpr int kTileWords = 2 * kWindow / (kScanThreads / kWarp);
  int32_t* tile = buf + (t / kWarp) * kTileWords;
  // Round i gives warp w the tile i * warps + (w + i * shift) % warps:
  // each round deals one tile to every warp, shifted by ~0.618 of the
  // warps per round, so heavy tiles a multiple of the warps apart (RGAT's
  // relations) do not all fall to the same warps
  const int warps = nb * (kScanThreads / kWarp);
  const int w = b * (kScanThreads / kWarp) + t / kWarp;
  const int shift = static_cast<int>((int64_t)warps * 618 / 1000) | 1;
  for (int64_t i = 0; i * warps * kWarp < s; ++i) {
    const int64_t q = i * warps + (w + i * shift) % warps;
    const int64_t row = q * kWarp + lane;
    int beg = 0, d = 0;
    if (row < s) {
      beg = __ldcg(row_ptr + row);
      d = __ldcg(count + row) - beg;
    }
    if (__all_sync(kFullMask, row >= s)) continue;
    const int first_beg = __shfl_sync(kFullMask, beg, 0);
    int span = d ? beg + d - first_beg : 0;
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2)
      span = max(span, __shfl_xor_sync(kFullMask, span, off));
    const bool in_tile = span <= kTileWords;
    if (in_tile) {                        // its loads in flight together
      for (int i0 = lane; i0 < span; i0 += kWarp * kSlotBatch) {
        int32_t v[kSlotBatch];
#pragma unroll
        for (int k = 0; k < kSlotBatch; ++k) {
          const int i = i0 + k * kWarp;
          v[k] = i < span ? __ldcg(placed + first_beg + i) : 0;
        }
#pragma unroll
        for (int k = 0; k < kSlotBatch; ++k)
          if (i0 + k * kWarp < span) tile[i0 + k * kWarp] = v[k];
      }
      __syncwarp();
    }
    int32_t* seg = tile + (beg - first_beg);
    if (in_tile ? d > 1 && d <= kLaneSlots : d > 0 && d <= kLaneSlots) {
      if (in_tile) lane_rank(SharedSeg{seg}, seg, d);
      else lane_rank(PlacedSeg{placed + beg}, slot + beg, d);
    }
    unsigned mid = __ballot_sync(kFullMask, d > kLaneSlots && d <= kWarp);
    while (mid) {
      const int src = __ffs(mid) - 1;
      mid &= mid - 1;
      const int b_src = __shfl_sync(kFullMask, beg, src);
      const int d_src = __shfl_sync(kFullMask, d, src);
      int32_t* s_src = tile + (b_src - first_beg);
      if (in_tile) warp_rank(SharedSeg{s_src}, s_src, d_src);
      else warp_rank(PlacedSeg{placed + b_src}, slot + b_src, d_src);
    }
    if (in_tile) {
      __syncwarp();
      for (int i = lane; i < span; i += kWarp) slot[first_beg + i] = tile[i];
      __syncwarp();                       // the tile's copy: the next's
    }
    if (d > kWarp) longs[atomicAdd(n_long, 1)] = static_cast<int32_t>(row);
  }
  grid.sync();
  const int n = __ldcg(n_long);
  for (int q = b; q < n; q += nb) {       // the long rows, dealt round
    const int row = __ldcg(longs + q);
    const int beg = __ldcg(row_ptr + row);
    rank_long_row(placed + beg, slot, beg, __ldcg(count + row) - beg,
                  reinterpret_cast<uint32_t*>(buf), buf + kWindow);
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

// What the current device holds of the transpose, asked once per device.
// The first call also raises the kernels' dynamic shared memory limits
// (above 48 KB it must be asked for), so a launch pays for none of it.
struct TransposeLimits {
  int64_t one_block = 0;  // s + nf words of the one-block form, at most
                          // 2^16 (its placed entry packs a row and a slot
                          // in 16 bits each)
  int grid = 0;           // blocks of the grid form, all resident (0: the
                          // device has no cooperative launch)
};

constexpr int kGridBytes = 2 * kWindow * sizeof(int32_t);

const TransposeLimits* transpose_limits() {
  constexpr int kMaxDevices = 64;
  static TransposeLimits limits[kMaxDevices];
  static bool asked[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return nullptr;
  TransposeLimits& l = limits[dev];
  if (asked[dev]) return &l;
  int optin = 0, sms = 0, coop = 0, per_sm = 0;
  cudaFuncAttributes one;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev) !=
          cudaSuccess ||
      cudaFuncGetAttributes(&one, transpose_one_block_kernel) != cudaSuccess)
    return nullptr;
  const int one_bytes = optin - static_cast<int>(one.sharedSizeBytes);
  if (cudaFuncSetAttribute(transpose_one_block_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           one_bytes) != cudaSuccess ||
      cudaFuncSetAttribute(transpose_grid_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kGridBytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, transpose_grid_kernel, kScanThreads, kGridBytes) !=
          cudaSuccess)
    return nullptr;
  l.one_block = std::min(one_bytes / static_cast<int>(sizeof(int32_t)),
                         1 << 16);
  l.grid = coop ? per_sm * sms : 0;
  asked[dev] = true;
  return &l;
}

// Whether the transpose of nf slots over s rows takes the one-block form
// (else the grid form).
bool fits_one_block(const TransposeLimits& l, int64_t s, int64_t nf) {
  return s + nf <= l.one_block;
}

// int32 words of the long-row list: n_long and at most nf / 33 rows.
int64_t long_rows_words(int64_t nf) { return 1 + nf / (kWarp + 1); }

// The launch's own error, else whatever cudaGetLastError holds (cleared).
int launch_error(cudaError_t err) {
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// The error a failed query left, never cudaSuccess.
int failed_query() {
  const cudaError_t err = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : cudaErrorUnknown);
}

}  // namespace

extern "C" {

// int32 scratch words the transpose needs on the current device: 0 for
// the one-block form; for the grid form count [s], the blocks' totals, the
// long-row list and placed [nf]; -1 if the device cannot be asked.
int64_t gather_spmm_transpose_scratch(int64_t s, int64_t nf) {
  const TransposeLimits* l = transpose_limits();
  if (!l) return -1;
  return fits_one_block(*l, s, nf) ? 0 : s + l->grid + long_rows_words(nf) + nf;
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
// slot [nf] (each row's slots in slot order; -1 past row_ptr[s]), in one
// launch whatever the form. scratch is int32
// [gather_spmm_transpose_scratch(s, nf)], null where that is 0.
int gather_spmm_adj_transpose(const void* adj, void* row_ptr, void* slot,
                              void* scratch, int64_t s, int64_t nf,
                              void* stream_p) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream_p);
  const int32_t* a = static_cast<const int32_t*>(adj);
  int32_t* rp = static_cast<int32_t*>(row_ptr);
  int32_t* sl = static_cast<int32_t*>(slot);
  int32_t* scr = static_cast<int32_t*>(scratch);
  int si = static_cast<int>(s), nfi = static_cast<int>(nf);
  const TransposeLimits* l = transpose_limits();
  if (!l) return failed_query();
  if (fits_one_block(*l, s, nf)) {
    const int bytes = static_cast<int>((s + nf) * sizeof(int32_t));
    transpose_one_block_kernel<<<1, kScanThreads, bytes, st>>>(a, si, nfi,
                                                               rp, sl);
    return static_cast<int>(cudaGetLastError());
  }
  if (scr == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (l->grid == 0) return static_cast<int>(cudaErrorNotSupported);
  void* args[] = {&a, &si, &nfi, &rp, &sl, &scr};
  return launch_error(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(transpose_grid_kernel), dim3(l->grid),
      dim3(kScanThreads), args, kGridBytes, st));
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
