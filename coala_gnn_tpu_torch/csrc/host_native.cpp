// Host tier row functions of the port: the staged miss path's gather and
// transport encode, run on the host's cores with OpenMP.
//
// A copy of the five row functions of the JAX package's native library
// (coala_gnn_tpu/native/coala_native.cpp: cg_gather_rows_f32,
// cg_quantize_rows, cg_encode_bf16, cg_gather_rows_bf16,
// cg_gather_quantize_rows), with the same arithmetic, so both give the same
// bytes. Built with g++ at first use into coala_gnn_tpu_torch/_build/
// (utils/build.py) and called through ctypes (native/lib.py).
//
// ids < 0 are sentinels: zero rows (int8: scale 1). int8 is symmetric per
// row: scale = absmax / 127 (1 for an all-zero row), q = round(v / scale)
// clamped to +-127, divided (not multiplied by a reciprocal) so the ties
// round as numpy's and torch's division does. bf16 is f32 rounded to
// nearest even, NaN quieted, stored as its uint16 bits.

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

inline uint16_t f32_to_bf16(float f) {
  uint32_t x;
  std::memcpy(&x, &f, 4);
  if ((x & 0x7fffffffu) > 0x7f800000u) return (uint16_t)((x >> 16) | 0x0040u);
  x += 0x7fffu + ((x >> 16) & 1u);
  return (uint16_t)(x >> 16);
}

inline float row_scale(const float* r, int64_t dim) {
  float am = 0.0f;
  for (int64_t j = 0; j < dim; j++) {
    float a = std::fabs(r[j]);
    if (a > am) am = a;
  }
  return am > 0.0f ? am / 127.0f : 1.0f;
}

inline void quantize_row(const float* r, int64_t dim, float s, int8_t* o) {
  for (int64_t j = 0; j < dim; j++) {
    float v = std::nearbyintf(r[j] / s);
    if (v > 127.0f) v = 127.0f;
    if (v < -127.0f) v = -127.0f;
    o[j] = (int8_t)v;
  }
}

}  // namespace

extern "C" {

// out[i, :] = features[ids[i], :]
void cg_gather_rows_f32(const float* features, int64_t dim, const int64_t* ids,
                        int64_t n, float* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; i++) {
    if (ids[i] < 0)
      std::memset(out + i * dim, 0, sizeof(float) * dim);
    else
      std::memcpy(out + i * dim, features + ids[i] * dim, sizeof(float) * dim);
  }
}

// rows [n, dim] -> q [n, dim] int8, scale [n]
void cg_quantize_rows(const float* rows, int64_t n, int64_t dim, int8_t* q,
                      float* scale) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; i++) {
    const float* r = rows + i * dim;
    const float s = row_scale(r, dim);
    scale[i] = s;
    quantize_row(r, dim, s, q + i * dim);
  }
}

// n f32 -> n bf16 bit patterns
void cg_encode_bf16(const float* in, int64_t n, uint16_t* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; i++) out[i] = f32_to_bf16(in[i]);
}

// out[i, :] = bf16(features[ids[i], :]), one pass over each row
void cg_gather_rows_bf16(const float* features, int64_t dim,
                         const int64_t* ids, int64_t n, uint16_t* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; i++) {
    uint16_t* o = out + i * dim;
    if (ids[i] < 0) {
      std::memset(o, 0, sizeof(uint16_t) * dim);
      continue;
    }
    const float* r = features + ids[i] * dim;
    for (int64_t j = 0; j < dim; j++) o[j] = f32_to_bf16(r[j]);
  }
}

// the gather fused with cg_quantize_rows, while the row is in cache
void cg_gather_quantize_rows(const float* features, int64_t dim,
                             const int64_t* ids, int64_t n, int8_t* q,
                             float* scale) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; i++) {
    int8_t* o = q + i * dim;
    if (ids[i] < 0) {
      std::memset(o, 0, dim);
      scale[i] = 1.0f;
      continue;
    }
    const float* r = features + ids[i] * dim;
    const float s = row_scale(r, dim);
    scale[i] = s;
    quantize_row(r, dim, s, o);
  }
}

}  // extern "C"
