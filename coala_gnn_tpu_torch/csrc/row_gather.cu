// Whole-row random gather for bench_ops.py's rand peak: dst[i] = src[ids[i]]
// for rows of `words` 16-byte words. The rand class of utils/roofline.py
// counts the bytes of random rows as narrow as one int8 cache line (256
// bytes at dim 256); PyTorch's indexing kernel moves a fixed number of rows
// per second whatever their width, so it cannot measure that class's peak.
// Here consecutive threads copy consecutive 16-byte words of a row, and each
// thread issues kUnroll independent loads before its stores, so a narrow
// row's copy is bound by the memory system rather than by the rows' count.
//
// Built for sm_90a by utils/build.py; a plain C interface for ctypes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(kThreads)
    row_gather_kernel(const uint4* __restrict__ src,
                      const int64_t* __restrict__ ids,
                      uint4* __restrict__ dst, int64_t total, int64_t words) {
  const int64_t step = int64_t(kThreads) * kUnroll;
  for (int64_t base = int64_t(blockIdx.x) * step + threadIdx.x; base < total;
       base += int64_t(gridDim.x) * step) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t e = base + int64_t(u) * kThreads;
      if (e < total) {
        const int64_t row = e / words;
        v[u] = __ldg(src + __ldg(ids + row) * words + (e - row * words));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t e = base + int64_t(u) * kThreads;
      if (e < total) dst[e] = v[u];
    }
  }
}

}  // namespace

extern "C" {

// src [s, words] and dst [n, words] of 16-byte words (16-byte aligned),
// ids [n] int64 in [0, s): dst[i] = src[ids[i]]. Returns a cudaError_t.
int row_gather_16b(const void* src, const void* ids, void* dst, int64_t n,
                   int64_t words, void* stream_p) {
  const int64_t total = n * words;
  if (total > 0) {
    const int64_t step = int64_t(kThreads) * kUnroll;
    const int64_t blocks = (total + step - 1) / step;
    row_gather_kernel<<<dim3(static_cast<unsigned>(
                            blocks < (int64_t(1) << 30) ? blocks
                                                        : int64_t(1) << 30)),
                        kThreads, 0, static_cast<cudaStream_t>(stream_p)>>>(
        static_cast<const uint4*>(src), static_cast<const int64_t*>(ids),
        static_cast<uint4*>(dst), total, words);
  }
  return static_cast<int>(cudaGetLastError());
}

// Name of a CUDA error code, for the wrapper's exception message.
const char* row_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
