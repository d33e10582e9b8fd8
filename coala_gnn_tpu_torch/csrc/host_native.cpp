// Host functions of the port, run on the host's cores: the host sampler's
// layer draw, the affinity-aware greedy seed distribution, and the staged
// miss path's row gather and transport encode (OpenMP).
//
// A copy of these functions of the JAX package's native library
// (coala_gnn_tpu/native/coala_native.cpp: sample_layer_core,
// cg_sample_layer and cg_sample_layer_typed, cg_distribute_affinity, cg_gather_rows_f32,
// cg_quantize_rows, cg_encode_bf16, cg_gather_rows_bf16,
// cg_gather_quantize_rows), with the same arithmetic and the same random
// streams, so both give the same bytes. Built with g++ at first use into
// coala_gnn_tpu_torch/_build/ (utils/build.py) and called through ctypes
// (native/lib.py).
//
// ids < 0 are sentinels: zero rows (int8: scale 1). int8 is symmetric per
// row: scale = absmax / 127 (1 for an all-zero row), q = round(v / scale)
// clamped to +-127, divided (not multiplied by a reciprocal) so the ties
// round as numpy's and torch's division does. bf16 is f32 rounded to
// nearest even, NaN quieted, stored as its uint16 bits.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

namespace {

// indices[i] of an int32 or int64 index array
inline int64_t idx_at(const void* indices, int width, int64_t i) {
  return width == 4 ? (int64_t)((const int32_t*)indices)[i]
                    : ((const int64_t*)indices)[i];
}

// splitmix64 finalizer: the per-row stream seeds
inline uint64_t mix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}

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

// One layer of fanout sampling: for each dst, `fanout` slots of in-neighbour
// ids. deg == 0: every slot masked (holding the dst id); deg <= fanout:
// every neighbour once, in CSC order; deg > fanout: `fanout` draws without
// replacement (Floyd's algorithm) from row i's own mt19937_64 stream,
// seeded mix64(seed ^ mix64(i)), so the result does not depend on the
// thread count. The typed form also writes each chosen edge's relation id
// (rel_out, 0 on masked slots); both forms draw the same neighbours.
static void sample_layer_core(const int64_t* indptr, const void* indices,
                              int idx_width, const int32_t* edge_types,
                              const int64_t* dst_ids, int64_t n_dst,
                              int fanout, uint64_t seed, int64_t* nbr_out,
                              float* mask_out, int32_t* rel_out) {
#pragma omp parallel for schedule(dynamic, 256)
  for (int64_t i = 0; i < n_dst; i++) {
    const int64_t v = dst_ids[i];
    const int64_t start = indptr[v];
    const int64_t deg = indptr[v + 1] - start;
    int64_t* nbr = nbr_out + i * fanout;
    float* mask = mask_out + i * fanout;
    int32_t* rel = rel_out ? rel_out + i * fanout : nullptr;
    if (deg <= (int64_t)fanout) {
      int64_t k = 0;
      for (; k < deg; k++) {
        nbr[k] = idx_at(indices, idx_width, start + k);
        mask[k] = 1.0f;
        if (rel) rel[k] = edge_types[start + k];
      }
      for (; k < fanout; k++) {
        nbr[k] = v;
        mask[k] = 0.0f;
        if (rel) rel[k] = 0;
      }
    } else {
      std::mt19937_64 rng(mix64(seed ^ mix64((uint64_t)i)));
      static thread_local std::vector<int64_t> chosen;
      chosen.clear();
      for (int64_t j = deg - fanout; j < deg; j++) {
        int64_t t = (int64_t)(rng() % (uint64_t)(j + 1));
        bool dup = false;
        for (size_t c = 0; c < chosen.size(); c++)
          if (chosen[c] == t) { dup = true; break; }
        chosen.push_back(dup ? j : t);
      }
      for (int k = 0; k < fanout; k++) {
        nbr[k] = idx_at(indices, idx_width, start + chosen[k]);
        mask[k] = 1.0f;
        if (rel) rel[k] = edge_types[start + chosen[k]];
      }
    }
  }
}

void cg_sample_layer(const int64_t* indptr, const void* indices, int idx_width,
                     const int64_t* dst_ids, int64_t n_dst, int fanout,
                     uint64_t seed, int64_t* nbr_out, float* mask_out) {
  sample_layer_core(indptr, indices, idx_width, nullptr, dst_ids, n_dst,
                    fanout, seed, nbr_out, mask_out, nullptr);
}

void cg_sample_layer_typed(const int64_t* indptr, const void* indices,
                           int idx_width, const int32_t* edge_types,
                           const int64_t* dst_ids, int64_t n_dst, int fanout,
                           uint64_t seed, int64_t* nbr_out, float* mask_out,
                           int32_t* rel_out) {
  sample_layer_core(indptr, indices, idx_width, edge_types, dst_ids, n_dst,
                    fanout, seed, nbr_out, mask_out, rel_out);
}

// Greedy affinity-aware seed distribution, sequential (every part computes
// the same assignment). For each seed in order: score(part j) = sum over k
// of meta[j][topk[c][k]] * affinity[c][k] (colors 0 and empty counts
// skipped; an uncolored seed scores 0); a part at capacity scores -1; the
// first part with the highest score wins. meta int32 [num_parts,
// num_colors + 1] by 1-based color.
void cg_distribute_affinity(const int64_t* item, int64_t offset,
                            int64_t item_len, int num_parts, int64_t capacity,
                            const int64_t* color, const int64_t* topk_colors,
                            const double* affinity, int topk,
                            int64_t num_colors, const int32_t* meta,
                            int32_t* out_assign) {
  std::vector<int64_t> bucket_len(num_parts, 0);
  const int64_t meta_stride = num_colors + 1;
  for (int64_t i = 0; i < item_len; i++) {
    const int64_t c = color[item[offset + i]];
    int best = 0;
    double best_score = -1.0;
    for (int j = 0; j < num_parts; j++) {
      double score = 0.0;
      if (c != 0) {
        const int32_t* m = meta + (int64_t)j * meta_stride;
        const int64_t row = (c - 1) * topk;
        for (int k = 0; k < topk; k++) {
          const int64_t nc = topk_colors[row + k];
          if (nc == 0) continue;
          const int32_t cnt = m[nc];
          if (cnt == 0) continue;
          score += (double)cnt * affinity[row + k];
        }
      }
      if (bucket_len[j] >= capacity) score = -1.0;
      if (score > best_score) {
        best = j;
        best_score = score;
      }
    }
    out_assign[i] = best;
    bucket_len[best]++;
  }
}

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
