// Host functions of the port, run on the host's cores: the host sampler's
// layer draw, the offline BFS graph coloring and its color affinity, the
// affinity-aware greedy seed distribution, and the staged miss path's row
// gather and transport encode (OpenMP).
//
// A copy of these functions of the JAX package's native library
// (coala_gnn_tpu/native/coala_native.cpp: sample_layer_core,
// cg_sample_layer and cg_sample_layer_typed, color_graph_core,
// cg_color_graph, cg_color_graph_seeded, cg_color_affinity,
// cg_distribute_affinity, cg_gather_rows_f32,
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

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <unordered_map>
#include <utility>
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

// ---------------------------------------------------------------------------
// BFS graph coloring (train-node-aware variant).
// Behavior parity with cpu_color_graph_optimized (graph_coloring.cpp:108-160):
//   - seeds: uncolored train nodes sampled at rate
//     base_rate * min(20, num_nodes / num_train)         (:75-79)
//   - hop 0 pre-step: uncolored 1-hop train neighbors of each seed join the
//     seed's color frontier                               (:125-141)
//   - per-hop double-buffered frontier, LIFO order, first-color-wins (:143-156)
//   - hop_out[v] = hop+1 at coloring time; after max_hop hops the remaining
//     frontier is flushed (colored at hop max_hop+1). Unlike the reference,
//     the flush also records the hop (the reference leaves it uninitialized —
//     SURVEY.md "quirks", graph_coloring.cpp:159 uses cpu_flush_buffer<false>).
// Returns the number of colors (colors are 1..num_colors).
// cg_color_graph_seeded takes the seed-node list explicitly (seed i gets
// color i+1) instead of RNG-sampling it — the injection point that lets
// tests compare native vs oracle colorings EXACTLY.
// ---------------------------------------------------------------------------
static int64_t color_graph_core(const int64_t* indptr, const void* indices,
                                int idx_width, int64_t num_nodes,
                                const int64_t* train_ids, int64_t num_train,
                                const int64_t* seed_nodes, int64_t n_seeds,
                                int max_hop, int64_t* color_out,
                                int32_t* hop_out) {
  std::memset(color_out, 0, sizeof(int64_t) * num_nodes);
  std::memset(hop_out, 0, sizeof(int32_t) * num_nodes);

  std::vector<uint8_t> is_train(num_nodes, 0);
  for (int64_t t = 0; t < num_train; t++) is_train[train_ids[t]] = 1;

  typedef std::pair<int64_t, int64_t> NodeColor;
  std::vector<NodeColor> buf[2];
  for (int64_t s = 0; s < n_seeds; s++)
    buf[0].emplace_back(seed_nodes[s], s + 1);
  const int64_t color_counter = n_seeds + 1;

  // hop-0 pre-step: adopt uncolored train 1-hop neighbors into seed colors.
  const size_t n_initial = buf[0].size();
  for (size_t s = 0; s < n_initial; s++) {
    const int64_t v = buf[0][s].first;
    const int64_t c = buf[0][s].second;
    for (int64_t e = indptr[v]; e < indptr[v + 1]; e++) {
      const int64_t u = idx_at(indices, idx_width, e);
      if (is_train[u] && color_out[u] == 0) buf[0].emplace_back(u, c);
    }
  }

  int hop = 0;
  for (; hop < max_hop; hop++) {
    std::vector<NodeColor>& cur = buf[hop % 2];
    std::vector<NodeColor>& next = buf[(hop + 1) % 2];
    while (!cur.empty()) {
      const NodeColor nc = cur.back();
      cur.pop_back();
      if (color_out[nc.first] != 0) continue;
      color_out[nc.first] = nc.second;
      hop_out[nc.first] = hop + 1;
      for (int64_t e = indptr[nc.first]; e < indptr[nc.first + 1]; e++)
        next.emplace_back(idx_at(indices, idx_width, e), nc.second);
    }
  }
  // flush: color (but don't expand) whatever the last hop enqueued.
  std::vector<NodeColor>& last = buf[hop % 2];
  while (!last.empty()) {
    const NodeColor nc = last.back();
    last.pop_back();
    if (color_out[nc.first] == 0) {
      color_out[nc.first] = nc.second;
      hop_out[nc.first] = hop + 1;
    }
  }
  return color_counter - 1;
}

int64_t cg_color_graph(const int64_t* indptr, const void* indices,
                       int idx_width, int64_t num_nodes,
                       const int64_t* train_ids, int64_t num_train,
                       int max_hop, double base_rate, uint64_t seed,
                       int64_t* color_out, int32_t* hop_out) {
  const double frac =
      num_train > 0 ? std::min(20.0, (double) num_nodes / (double) num_train)
                    : 1.0;
  const double rate = base_rate * frac;

  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<double> uni(0.0, 1.0);
  std::vector<int64_t> seeds;
  for (int64_t t = 0; t < num_train; t++)
    if (uni(rng) <= rate) seeds.push_back(train_ids[t]);

  return color_graph_core(indptr, indices, idx_width, num_nodes, train_ids,
                          num_train, seeds.data(), (int64_t) seeds.size(),
                          max_hop, color_out, hop_out);
}

int64_t cg_color_graph_seeded(const int64_t* indptr, const void* indices,
                              int idx_width, int64_t num_nodes,
                              const int64_t* train_ids, int64_t num_train,
                              const int64_t* seed_nodes, int64_t n_seeds,
                              int max_hop, int64_t* color_out,
                              int32_t* hop_out) {
  return color_graph_core(indptr, indices, idx_width, num_nodes, train_ids,
                          num_train, seed_nodes, n_seeds, max_hop, color_out,
                          hop_out);
}

// ---------------------------------------------------------------------------
// Color affinity: for each color c, the top-k neighbor colors by
//   score(c, c') = sum over edges (u->v), color[v]=c, color[u]=c', c'!=c, c'!=0
//                  of exp(-0.5 * hop[u]),
// normalized by the total in-edge count of color-c nodes. Scoring function and
// normalization are identical to cpu_calculate_color_affinity
// (graph_coloring.cpp:250-252, 267-293); the reference's off-by-one color loop
// (it skips the last color and relies on empty map rows, SURVEY.md "quirks")
// is fixed: all colors 1..num_colors get a row at (c-1).
// topk_out: int64 [num_colors, topk]; score_out: double [num_colors, topk];
// unused slots are color 0 / score 0.
// ---------------------------------------------------------------------------
void cg_color_affinity(const int64_t* indptr, const void* indices,
                       int idx_width, int64_t num_nodes,
                       const int64_t* color, const int32_t* hop,
                       int64_t num_colors, int topk,
                       int64_t* topk_out, double* score_out) {
  std::memset(topk_out, 0, sizeof(int64_t) * num_colors * topk);
  std::memset(score_out, 0, sizeof(double) * num_colors * topk);

  // Bucket nodes by color (counting sort) so colors parallelize cleanly.
  std::vector<int64_t> count(num_colors + 2, 0);
  for (int64_t v = 0; v < num_nodes; v++) count[color[v] + 1]++;
  std::vector<int64_t> start(num_colors + 2);
  start[0] = 0;
  for (int64_t c = 0; c <= num_colors; c++) start[c + 1] = start[c] + count[c + 1];
  std::vector<int64_t> nodes_of(num_nodes);
  {
    std::vector<int64_t> cursor(start.begin(), start.end() - 1);
    for (int64_t v = 0; v < num_nodes; v++) nodes_of[cursor[color[v]]++] = v;
  }
  // nodes_of[start[c] .. start[c+1]) holds color-(c) nodes, c in 0..num_colors
  // where bucket 0 is the uncolored set (start[0]..start[1]).

#pragma omp parallel for schedule(dynamic, 16)
  for (int64_t c = 1; c <= num_colors; c++) {
    std::unordered_map<int64_t, double> acc;
    double neigh_count = 0.0;
    for (int64_t p = start[c]; p < start[c + 1]; p++) {
      const int64_t v = nodes_of[p];
      const int64_t lo = indptr[v], hi = indptr[v + 1];
      neigh_count += (double) (hi - lo);
      for (int64_t e = lo; e < hi; e++) {
        const int64_t u = idx_at(indices, idx_width, e);
        const int64_t cu = color[u];
        if (cu != 0 && cu != c) acc[cu] += std::exp(-0.5 * (double) hop[u]);
      }
    }
    std::vector<std::pair<int64_t, double>> v(acc.begin(), acc.end());
    std::sort(v.begin(), v.end(), [](const std::pair<int64_t, double>& a,
                                     const std::pair<int64_t, double>& b) {
      if (a.second != b.second) return a.second > b.second;
      return a.first < b.first;  // deterministic tie-break (reference: unstable)
    });
    const int k_out = std::min((int) v.size(), topk);
    for (int k = 0; k < k_out; k++) {
      topk_out[(c - 1) * topk + k] = v[k].first;
      if (neigh_count > 0)
        score_out[(c - 1) * topk + k] = v[k].second / neigh_count;
    }
  }
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
