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
//   - gather_spmm_grad_w / gather_spmm_grad_x: the backward. Neither Pallas
//     kernel has one; the JAX GAT differentiates its XLA plane FMAs
//     (coala_gnn_tpu/models/layers.py:143), and these two kernels are the
//     Hopper form of that autodiff, because the port runs GAT's attention
//     combine through the forward kernel.
//
// Forward. What bounds it on this card: the bytes of the random row reads.
// On the training step's layer 0 (N = 6144 dst rows, F = 10 slots, D = 256
// f32) that is 61,440 slots x 1 KB = 63 MB per step, read at random from a
// 205 MB table; the arithmetic (one FMA per 4 bytes) is negligible. The
// design reads each slot's row exactly once, straight from the table, and
// reduces it in registers: the gathered [67,584 x 256] frontier (69 MB)
// that a gather-then-reduce would write and read back is never built. An
// int8 table moves a quarter of those bytes plus one 4-byte scale per slot.
//
// grad_w[n, k] = <g[n, :], x[adj[n, k], :]>. Bound by bytes: it reads the
// forward's rows again plus g (N x D x 4). One warp per dst row; each slot's
// partial dot products are reduced by warp shuffles and written by lane 0.
// It is computed for EVERY slot, w == 0 included: the forward may skip such
// a slot because it contributes nothing, but the derivative with respect to
// its weight is not zero.
//
// grad_x[adj[n, k], :] += w[n, k] * g[n, :] into a zeroed [S, D] f32 (the
// wrapper zeroes it). Bound by bytes: it writes S x D x 4 bytes (zeroing
// included) and reads g once. One warp per dst row reads its g row once
// into registers and scatters w * g to each slot's row with vector atomics
// (float4 atomicAdd, Hopper). On the contiguous layout every slot row is
// referenced by exactly one (n, k), so no two atomics meet: the result is
// deterministic and equal to the plain index_add_. With repeated indices the
// order of the sums varies from run to run.
//
// Layout: one warp per dst row, 8 rows per block. The vector width follows
// the row's byte alignment: each lane moves VB bytes per access, the largest
// of 16, 8, 4, 2, 1 that divides both D * sizeof(T) and the table's base
// address, so any D works (a bf16 row of width 100 starts only 8-byte
// aligned, and a 16-byte load there would fault). Slots are reduced in order
// k = 0..F-1 with f32 accumulation, the order of the plain version and of the
// JAX plane FMAs. A slot whose index lies outside [0, S) is not read: its
// forward dst row and its grad_w entry come out NaN, so a bad frontier shows
// instead of faulting; grad_x skips it. Row offsets are 64-bit: adj * D
// passes 2^31 at 10M x 1024.
//
// The kernels allocate nothing, launch on the caller's stream and do not
// synchronise. Each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;
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

// VB bytes of T at p (VB-aligned) -> VB / sizeof(T) floats.
template <typename T, int VB>
__device__ __forceinline__ void load_vec(const T* p, float* v) {
  using R = typename Raw<VB>::type;
  constexpr int E = VB / sizeof(T);
  const R r = __ldg(reinterpret_cast<const R*>(p));
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

// p[0..E) += v[0..E) atomically, one vector atomic per 4 floats.
template <int E>
__device__ __forceinline__ void atomic_add_f32(float* p, const float* v) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int j = 0; j < E; j += 4)
      atomicAdd(reinterpret_cast<float4*>(p + j),
                make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]));
  } else if constexpr (E == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    atomicAdd(p, v[0]);
  }
}

__device__ __forceinline__ bool out_of_range(int64_t idx, int64_t s) {
  return idx < 0 || idx >= s;
}

template <typename T, int VB>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
gather_spmm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   const int32_t* __restrict__ adj,
                   const float* __restrict__ w, float* __restrict__ out,
                   int64_t s, int n, int f, int d) {
  constexpr int E = VB / sizeof(T);
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= n) return;
  const int32_t* adj_row = adj + (int64_t)row * f;
  const float* w_row = w + (int64_t)row * f;
  float* out_row = out + (int64_t)row * d;

  bool bad = false;
  for (int k = 0; k < f; ++k) bad |= out_of_range(adj_row[k], s);

  for (int c = lane * E; c < d; c += kWarp * E) {
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
    for (int k = 0; k < f; ++k) {
      const float wk = w_row[k];
      const int64_t idx = adj_row[k];
      if (wk == 0.f || out_of_range(idx, s)) continue;
      float v[E];
      load_vec<T, VB>(x + idx * d + c, v);
      if constexpr (sizeof(T) == 1) {      // int8: dequantise, then the FMA
        const float sc = __ldg(scale + idx);
#pragma unroll
        for (int e = 0; e < E; ++e) v[e] = v[e] * sc;
      }
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(wk, v[e], acc[e]);
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
        load_vec<T, VB>(x + idx * d + c, v);
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

template <int VB>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
grad_x_kernel(const int32_t* __restrict__ adj, const float* __restrict__ w,
              const float* __restrict__ g, float* __restrict__ gx,
              int64_t s, int n, int f, int d) {
  constexpr int E = VB / 4;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= n) return;
  const int32_t* adj_row = adj + (int64_t)row * f;
  const float* w_row = w + (int64_t)row * f;
  const float* g_row = g + (int64_t)row * d;

  for (int c = lane * E; c < d; c += kWarp * E) {
    float gv[E];
    load_f32<E>(g_row + c, gv);
    for (int k = 0; k < f; ++k) {
      const float wk = w_row[k];
      const int64_t idx = adj_row[k];
      // w == 0 adds w * g = 0 (g finite): nothing to write
      if (wk == 0.f || out_of_range(idx, s)) continue;
      float v[E];
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = wk * gv[e];
      atomic_add_f32<E>(gx + idx * d + c, v);
    }
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

inline int blocks_for(int n) {
  return (n + kRowsPerBlock - 1) / kRowsPerBlock;
}

template <typename T, int VB>
void forward_vb(const void* x, const void* scale, const void* adj,
                const void* w, void* out, int64_t s, int n, int f, int d,
                cudaStream_t stream) {
  if constexpr (VB >= (int)sizeof(T)) {
    gather_spmm_kernel<T, VB><<<blocks_for(n), kWarp * kRowsPerBlock, 0,
                                stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(scale),
        static_cast<const int32_t*>(adj), static_cast<const float*>(w),
        static_cast<float*>(out), s, n, f, d);
  }
}

template <typename T>
int forward(const void* x, const void* scale, const void* adj, const void* w,
            void* out, int64_t s, int n, int f, int d, void* stream_p) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream_p);
  if (n > 0) {
    switch (vec_bytes<T>(d, x)) {
      case 16: forward_vb<T, 16>(x, scale, adj, w, out, s, n, f, d, st); break;
      case 8: forward_vb<T, 8>(x, scale, adj, w, out, s, n, f, d, st); break;
      case 4: forward_vb<T, 4>(x, scale, adj, w, out, s, n, f, d, st); break;
      case 2: forward_vb<T, 2>(x, scale, adj, w, out, s, n, f, d, st); break;
      default: forward_vb<T, 1>(x, scale, adj, w, out, s, n, f, d, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VB>
void grad_w_vb(const void* x, const void* adj, const void* g, void* gw,
               int64_t s, int n, int f, int d, cudaStream_t stream) {
  if constexpr (VB >= (int)sizeof(T)) {
    grad_w_kernel<T, VB><<<blocks_for(n), kWarp * kRowsPerBlock, 0,
                           stream>>>(
        static_cast<const T*>(x), static_cast<const int32_t*>(adj),
        static_cast<const float*>(g), static_cast<float*>(gw), s, n, f, d);
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
void grad_x_vb(const void* adj, const void* w, const void* g, void* gx,
               int64_t s, int n, int f, int d, cudaStream_t stream) {
  grad_x_kernel<VB><<<blocks_for(n), kWarp * kRowsPerBlock, 0, stream>>>(
      static_cast<const int32_t*>(adj), static_cast<const float*>(w),
      static_cast<const float*>(g), static_cast<float*>(gx), s, n, f, d);
}

}  // namespace

extern "C" {

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

// gx [s, d] f32, zeroed by the caller: gx[adj[i, k]] += w[i, k] * g[i].
int gather_spmm_grad_x(const void* adj, const void* w, const void* g,
                       void* gx, int64_t s, int n, int f, int d,
                       void* stream_p) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream_p);
  if (n > 0) {
    switch (vec_bytes<float>(d, g, gx)) {
      case 16: grad_x_vb<16>(adj, w, g, gx, s, n, f, d, st); break;
      case 8: grad_x_vb<8>(adj, w, g, gx, s, n, f, d, st); break;
      default: grad_x_vb<4>(adj, w, g, gx, s, n, f, d, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Name of a CUDA error code, for the wrapper's exception message.
const char* gather_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
