"""Offline graph coloring and color-affinity metadata (port of
coala_gnn_tpu/coloring/coloring.py), run on the host.

  - BFS colors propagated from train seeds drawn at the rate
    ``base_rate * min(20, N / N_train)``, at most ``max_hop`` hops;
  - per color its top-k neighbour colors, scored by the sum of
    ``exp(-0.5 * hop)`` over cross-color edges and normalised by the
    color's total in-edge count;
  - the artifacts ``color.npy`` / ``topk.npy`` / ``score.npy`` (and
    ``hop.npy``) with the JAX package's names, shapes and dtypes, so
    either package reads what the other wrote.

The loops run in the port's native host library (``csrc/host_native.cpp``,
the JAX package's functions copied, ``std::mt19937_64`` seed draw
included), so ``color_graph(seed=s)`` gives the JAX package's native
coloring bit for bit. ``use_native=False`` takes the NumPy oracles, which
draw their seeds with numpy (other picks) and otherwise give the same
coloring (``color_graph_from_seeds``). Unlike the JAX module, a native
library that does not build is an error, not a silent switch to the
oracles.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np

from coala_gnn_tpu_torch.graph.csc import CSCGraph
from coala_gnn_tpu_torch.native import lib as native_lib

GLOBAL_MAX_HOP = 10
GLOBAL_SAMPLING_RATE = 0.005
DEFAULT_TOPK = 10


@dataclasses.dataclass
class ColorMetadata:
    """color : int64 [N]      1-based color per node, 0 = uncolored
    topk  : int64 [C, K]    top-k neighbour colors per color (0-padded)
    score : float64 [C, K]  normalised affinity per (color, top-k slot)
    hop   : int32 [N]       BFS hop at coloring time (optional)
    """

    color: np.ndarray
    topk: np.ndarray
    score: np.ndarray
    hop: Optional[np.ndarray] = None

    @property
    def num_colors(self) -> int:
        return int(self.topk.shape[0])

    @property
    def topk_k(self) -> int:
        return int(self.topk.shape[1])


def color_graph(graph: CSCGraph, train_ids: np.ndarray,
                max_hop: int = GLOBAL_MAX_HOP,
                base_rate: float = GLOBAL_SAMPLING_RATE,
                seed: int = 0, use_native: bool = True
                ) -> Tuple[int, np.ndarray, np.ndarray]:
    """BFS coloring -> (num_colors, color int64 [N], hop int32 [N])."""
    if use_native:
        return native_lib.color_graph(native_lib.get(), graph, train_ids,
                                      max_hop, base_rate, seed)
    train_ids = np.asarray(train_ids, dtype=np.int64)
    rng = np.random.default_rng(seed)
    frac = min(20.0, graph.num_nodes / max(len(train_ids), 1))
    picks = train_ids[rng.random(len(train_ids)) <= base_rate * frac]
    return _color_graph_py(graph, train_ids, picks, max_hop)


def color_graph_from_seeds(graph: CSCGraph, train_ids: np.ndarray,
                           seed_nodes: np.ndarray,
                           max_hop: int = GLOBAL_MAX_HOP,
                           use_native: bool = True
                           ) -> Tuple[int, np.ndarray, np.ndarray]:
    """BFS coloring from the given seed nodes (seed i gets color i + 1):
    the native library and the oracle give the same result."""
    if use_native:
        return native_lib.color_graph_seeded(native_lib.get(), graph,
                                             train_ids, seed_nodes, max_hop)
    return _color_graph_py(graph, train_ids,
                           np.asarray(seed_nodes, np.int64), max_hop)


def _color_graph_py(graph: CSCGraph, train_ids: np.ndarray,
                    picks: np.ndarray, max_hop: int
                    ) -> Tuple[int, np.ndarray, np.ndarray]:
    """The oracle of ``color_graph_core``: the seeds' train 1-hop
    neighbours join their colors, then per hop a LIFO frontier where the
    first color to reach a node wins; what the last hop queued is colored
    (hop max_hop + 1) without expanding."""
    n = graph.num_nodes
    indptr, indices = graph.indptr, graph.indices
    color = np.zeros(n, dtype=np.int64)
    hop_buf = np.zeros(n, dtype=np.int32)
    is_train = np.zeros(n, dtype=bool)
    is_train[np.asarray(train_ids, np.int64)] = True

    def in_neighbors(v: int) -> np.ndarray:
        return indices[indptr[v]:indptr[v + 1]]

    frontier = [(int(v), c + 1) for c, v in enumerate(picks)]
    num_colors = len(picks)
    extra = []
    for v, c in frontier:
        for u in in_neighbors(v):
            if is_train[u] and color[u] == 0:
                extra.append((int(u), c))
    frontier = frontier + extra

    for hop in range(max_hop):
        nxt = []
        while frontier:
            v, c = frontier.pop()
            if color[v] != 0:
                continue
            color[v] = c
            hop_buf[v] = hop + 1
            for u in in_neighbors(v):
                nxt.append((int(u), c))
        frontier = nxt
    while frontier:
        v, c = frontier.pop()
        if color[v] == 0:
            color[v] = c
            hop_buf[v] = max_hop + 1
    return num_colors, color, hop_buf


def color_affinity(graph: CSCGraph, color: np.ndarray, hop: np.ndarray,
                   num_colors: int, topk: int = DEFAULT_TOPK,
                   use_native: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Per color its top-k neighbour colors (int64 [C, K]) and their
    normalised affinity (float64 [C, K]); ties by the lower color."""
    if use_native:
        return native_lib.color_affinity(native_lib.get(), graph, color, hop,
                                         num_colors, topk)
    return _color_affinity_py(graph, color, hop, num_colors, topk)


def _color_affinity_py(graph: CSCGraph, color: np.ndarray, hop: np.ndarray,
                       num_colors: int, topk: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorised NumPy oracle of ``cg_color_affinity``."""
    deg = np.diff(graph.indptr)
    dst_color = np.repeat(color, deg)
    src = np.asarray(graph.indices)
    src_color = color[src]
    src_score = np.exp(-0.5 * hop[src].astype(np.float64))

    valid = (dst_color != 0) & (src_color != 0) & (dst_color != src_color)
    pair = dst_color[valid] * (num_colors + 1) + src_color[valid]
    pair_sum = np.bincount(pair, weights=src_score[valid],
                           minlength=(num_colors + 1) ** 2
                           ).reshape(num_colors + 1, num_colors + 1)
    neigh_count = np.bincount(color, weights=deg.astype(np.float64),
                              minlength=num_colors + 1)

    topk_out = np.zeros((num_colors, topk), dtype=np.int64)
    score_out = np.zeros((num_colors, topk), dtype=np.float64)
    for c in range(1, num_colors + 1):
        row = pair_sum[c]
        nz = np.flatnonzero(row)
        if nz.size == 0:
            continue
        order = nz[np.lexsort((nz, -row[nz]))][:topk]
        topk_out[c - 1, :order.size] = order
        if neigh_count[c] > 0:
            score_out[c - 1, :order.size] = row[order] / neigh_count[c]
    return topk_out, score_out


def generate_color_metadata(graph: CSCGraph, train_ids: np.ndarray,
                            max_hop: int = GLOBAL_MAX_HOP,
                            base_rate: float = GLOBAL_SAMPLING_RATE,
                            topk: int = DEFAULT_TOPK, seed: int = 0,
                            use_native: bool = True) -> ColorMetadata:
    """The offline pipeline: ``color_graph`` then ``color_affinity``."""
    num_colors, color, hop = color_graph(graph, train_ids, max_hop,
                                         base_rate, seed, use_native)
    tk, sc = color_affinity(graph, color, hop, num_colors, topk, use_native)
    return ColorMetadata(color=color, topk=tk, score=sc, hop=hop)


_COLOR, _TOPK, _SCORE, _HOP = "color.npy", "topk.npy", "score.npy", "hop.npy"


def save_color_metadata(meta: ColorMetadata, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    np.save(os.path.join(path, _COLOR), meta.color)
    np.save(os.path.join(path, _TOPK), meta.topk)
    np.save(os.path.join(path, _SCORE), meta.score)
    if meta.hop is not None:
        np.save(os.path.join(path, _HOP), meta.hop)


def load_color_metadata(path: str) -> ColorMetadata:
    """Reads a directory written by either package (a flat 1-D
    ``score.npy`` is reshaped to ``topk``'s shape)."""
    hop_path = os.path.join(path, _HOP)
    score = np.load(os.path.join(path, _SCORE))
    topk = np.load(os.path.join(path, _TOPK))
    if score.ndim == 1:
        score = score.reshape(topk.shape)
    return ColorMetadata(
        color=np.load(os.path.join(path, _COLOR)),
        topk=topk,
        score=score,
        hop=np.load(hop_path) if os.path.exists(hop_path) else None,
    )
