"""ctypes bindings of the port's native host library
(``csrc/host_native.cpp``), built with g++ at first use into
``coala_gnn_tpu_torch/_build/`` (``utils/build.py``).

Port of the functions of ``coala_gnn_tpu/native/lib.py`` that the port
calls: the host sampler's ``sample_layer`` and ``sample_layer_typed``, the
offline coloring's ``color_graph``, ``color_graph_seeded`` and
``color_affinity``, the greedy ``distribute_affinity``, and the five row
functions of the staged miss path. bf16 comes back as its uint16 bit
pattern (numpy has no bf16 type, and the card's machine has no
``ml_dtypes``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np

from coala_gnn_tpu_torch.utils.build import load_library

SOURCE = "host_native.cpp"

_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_u16p = np.ctypeslib.ndpointer(dtype=np.uint16, flags="C_CONTIGUOUS")
_i8p = np.ctypeslib.ndpointer(dtype=np.int8, flags="C_CONTIGUOUS")
_i64 = ctypes.c_int64
_int = ctypes.c_int


@functools.lru_cache(maxsize=None)
def get() -> ctypes.CDLL:
    """Build (at first use), load and type the library; raises
    ``RuntimeError`` (no g++, or it failed) or ``OSError`` (load)."""
    lib = load_library(SOURCE)
    lib.cg_sample_layer.argtypes = [_i64p, ctypes.c_void_p, _int, _i64p, _i64,
                                    _int, ctypes.c_uint64, _i64p, _f32p]
    lib.cg_sample_layer_typed.argtypes = [_i64p, ctypes.c_void_p, _int,
                                          _i32p, _i64p, _i64, _int,
                                          ctypes.c_uint64, _i64p, _f32p,
                                          _i32p]
    lib.cg_color_graph.argtypes = [_i64p, ctypes.c_void_p, _int, _i64,
                                   _i64p, _i64, _int, ctypes.c_double,
                                   ctypes.c_uint64, _i64p, _i32p]
    lib.cg_color_graph_seeded.argtypes = [_i64p, ctypes.c_void_p, _int, _i64,
                                          _i64p, _i64, _i64p, _i64, _int,
                                          _i64p, _i32p]
    lib.cg_color_affinity.argtypes = [_i64p, ctypes.c_void_p, _int, _i64,
                                      _i64p, _i32p, _i64, _int, _i64p, _f64p]
    lib.cg_color_graph.restype = _i64
    lib.cg_color_graph_seeded.restype = _i64
    lib.cg_distribute_affinity.argtypes = [_i64p, _i64, _i64, _int, _i64,
                                           _i64p, _i64p, _f64p, _int, _i64,
                                           _i32p, _i32p]
    lib.cg_gather_rows_f32.argtypes = [_f32p, _i64, _i64p, _i64, _f32p]
    lib.cg_quantize_rows.argtypes = [_f32p, _i64, _i64, _i8p, _f32p]
    lib.cg_encode_bf16.argtypes = [_f32p, _i64, _u16p]
    lib.cg_gather_rows_bf16.argtypes = [_f32p, _i64, _i64p, _i64, _u16p]
    lib.cg_gather_quantize_rows.argtypes = [_f32p, _i64, _i64p, _i64, _i8p,
                                            _f32p]
    for name in ("cg_sample_layer", "cg_sample_layer_typed",
                 "cg_color_affinity", "cg_distribute_affinity",
                 "cg_gather_rows_f32", "cg_quantize_rows", "cg_encode_bf16",
                 "cg_gather_rows_bf16", "cg_gather_quantize_rows"):
        getattr(lib, name).restype = None
    return lib


def _indices_arg(graph) -> Tuple[np.ndarray, ctypes.c_void_p, int]:
    """(indptr int64, indices pointer, index width) of a CSC graph whose
    ``indices`` are int32 or int64."""
    indices = graph.indices
    if indices.dtype not in (np.int32, np.int64):
        raise TypeError(f"indices dtype {indices.dtype} unsupported")
    return (np.ascontiguousarray(graph.indptr, dtype=np.int64),
            indices.ctypes.data_as(ctypes.c_void_p), indices.dtype.itemsize)


def _layer_args(graph, dst_ids: np.ndarray, fanout: int) -> tuple:
    """(indptr, indices pointer, index width, dst ids, nbr, mask) of one
    layer's draw; ``graph.indices`` int32 or int64."""
    dst_ids = np.ascontiguousarray(dst_ids, dtype=np.int64)
    n = dst_ids.shape[0]
    return (*_indices_arg(graph), dst_ids,
            np.empty((n, fanout), dtype=np.int64),
            np.empty((n, fanout), dtype=np.float32))


def sample_layer(lib: ctypes.CDLL, graph, dst_ids: np.ndarray, fanout: int,
                 seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(nbr int64 [n, fanout], mask f32 [n, fanout]) of one layer for the
    dst ids (see ``cg_sample_layer``)."""
    indptr, idx, width, dst_ids, nbr, mask = _layer_args(graph, dst_ids,
                                                         fanout)
    lib.cg_sample_layer(indptr, idx, width, dst_ids, dst_ids.shape[0],
                        fanout, seed & (2**64 - 1), nbr, mask)
    return nbr, mask


def sample_layer_typed(lib: ctypes.CDLL, graph, dst_ids: np.ndarray,
                       fanout: int, seed: int
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``sample_layer`` plus each slot's relation id (int32 [n, fanout], 0
    on masked slots) from ``graph.edge_types``: the same draws."""
    indptr, idx, width, dst_ids, nbr, mask = _layer_args(graph, dst_ids,
                                                         fanout)
    et = np.ascontiguousarray(graph.edge_types, dtype=np.int32)
    rel = np.empty(mask.shape, dtype=np.int32)
    lib.cg_sample_layer_typed(indptr, idx, width, et, dst_ids,
                              dst_ids.shape[0], fanout, seed & (2**64 - 1),
                              nbr, mask, rel)
    return nbr, mask, rel


def color_graph(lib: ctypes.CDLL, graph, train_ids: np.ndarray,
                max_hop: int = 10, base_rate: float = 0.005,
                seed: int = 0) -> Tuple[int, np.ndarray, np.ndarray]:
    """BFS coloring from train seeds drawn at ``base_rate`` (see
    ``cg_color_graph``) -> (num_colors, color int64 [N], hop int32 [N])."""
    train_ids = np.ascontiguousarray(train_ids, dtype=np.int64)
    n = graph.num_nodes
    color = np.empty(n, dtype=np.int64)
    hop = np.empty(n, dtype=np.int32)
    indptr, idx, width = _indices_arg(graph)
    num_colors = lib.cg_color_graph(indptr, idx, width, n, train_ids,
                                    train_ids.shape[0], max_hop, base_rate,
                                    seed & (2**64 - 1), color, hop)
    return int(num_colors), color, hop


def color_graph_seeded(lib: ctypes.CDLL, graph, train_ids: np.ndarray,
                       seed_nodes: np.ndarray, max_hop: int = 10
                       ) -> Tuple[int, np.ndarray, np.ndarray]:
    """``color_graph`` from the given seed nodes (seed i gets color i + 1)
    instead of a random draw."""
    train_ids = np.ascontiguousarray(train_ids, dtype=np.int64)
    seed_nodes = np.ascontiguousarray(seed_nodes, dtype=np.int64)
    n = graph.num_nodes
    color = np.empty(n, dtype=np.int64)
    hop = np.empty(n, dtype=np.int32)
    indptr, idx, width = _indices_arg(graph)
    num_colors = lib.cg_color_graph_seeded(
        indptr, idx, width, n, train_ids, train_ids.shape[0], seed_nodes,
        seed_nodes.shape[0], max_hop, color, hop)
    return int(num_colors), color, hop


def color_affinity(lib: ctypes.CDLL, graph, color: np.ndarray,
                   hop: np.ndarray, num_colors: int, topk: int = 10
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Per color its top-k neighbour colors and their normalised affinity
    (see ``cg_color_affinity``) -> (topk int64 [C, K], score f64 [C, K])."""
    color = np.ascontiguousarray(color, dtype=np.int64)
    hop = np.ascontiguousarray(hop, dtype=np.int32)
    topk_out = np.zeros((num_colors, topk), dtype=np.int64)
    score_out = np.zeros((num_colors, topk), dtype=np.float64)
    indptr, idx, width = _indices_arg(graph)
    lib.cg_color_affinity(indptr, idx, width, graph.num_nodes, color, hop,
                          num_colors, topk, topk_out, score_out)
    return topk_out, score_out


def distribute_affinity(lib: ctypes.CDLL, item: np.ndarray, offset: int,
                        item_len: int, num_parts: int, capacity: int,
                        color: np.ndarray, topk_colors: np.ndarray,
                        affinity: np.ndarray, meta: np.ndarray) -> np.ndarray:
    """Part of each of ``item[offset:offset + item_len]`` (int32
    [item_len]), see ``cg_distribute_affinity``; meta int32 [num_parts,
    num_colors + 1]."""
    item = np.ascontiguousarray(item, dtype=np.int64)
    if not 0 <= offset <= offset + item_len <= item.shape[0]:
        raise ValueError(f"items [{offset}, {offset + item_len}) out of "
                         f"range of {item.shape[0]}")
    color = np.ascontiguousarray(color, dtype=np.int64)
    topk_colors = np.ascontiguousarray(topk_colors, dtype=np.int64)
    affinity = np.ascontiguousarray(affinity, dtype=np.float64)
    meta = np.ascontiguousarray(meta, dtype=np.int32)
    num_colors, topk = topk_colors.shape
    if meta.shape != (num_parts, num_colors + 1):
        raise ValueError(f"meta shape {meta.shape} != "
                         f"({num_parts}, {num_colors + 1})")
    if affinity.shape != topk_colors.shape:
        raise ValueError("affinity and topk_colors differ in shape")
    out = np.empty(item_len, dtype=np.int32)
    lib.cg_distribute_affinity(item, offset, item_len, num_parts, capacity,
                               color, topk_colors.reshape(-1),
                               affinity.reshape(-1), topk, num_colors,
                               meta.reshape(-1), out)
    return out


def gather_rows(lib: ctypes.CDLL, features: np.ndarray, ids: np.ndarray,
                out: Optional[np.ndarray] = None) -> np.ndarray:
    """out[i] = features[ids[i]] f32; ids < 0 -> zero rows."""
    if features.dtype != np.float32 or features.ndim != 2:
        raise TypeError("features must be float32 [n, dim]")
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    if out is None:
        out = np.empty((ids.shape[0], features.shape[1]), dtype=np.float32)
    lib.cg_gather_rows_f32(features, features.shape[1], ids, ids.shape[0], out)
    return out


def quantize_rows(lib: ctypes.CDLL, rows: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """rows f32 [n, dim] -> (q int8 [n, dim], scale f32 [n])."""
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    n, dim = rows.shape
    q = np.empty((n, dim), np.int8)
    scale = np.empty(n, np.float32)
    lib.cg_quantize_rows(rows, n, dim, q, scale)
    return q, scale


def encode_bf16(lib: ctypes.CDLL, rows: np.ndarray,
                out: Optional[np.ndarray] = None) -> np.ndarray:
    """f32 rows -> their bf16 bit patterns (uint16, same shape)."""
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    if out is None:
        out = np.empty(rows.shape, np.uint16)
    lib.cg_encode_bf16(rows.reshape(-1), rows.size, out.reshape(-1))
    return out


def gather_rows_bf16(lib: ctypes.CDLL, features: np.ndarray,
                     ids: np.ndarray, out: Optional[np.ndarray] = None
                     ) -> np.ndarray:
    """out[i] = bf16 bits of features[ids[i]] (uint16); ids < 0 -> zero
    rows."""
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    if out is None:
        out = np.empty((ids.shape[0], features.shape[1]), np.uint16)
    lib.cg_gather_rows_bf16(features, features.shape[1], ids, ids.shape[0],
                            out)
    return out


def gather_quantize_rows(lib: ctypes.CDLL, features: np.ndarray,
                         ids: np.ndarray,
                         q_out: Optional[np.ndarray] = None,
                         scale_out: Optional[np.ndarray] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """The gather fused with ``quantize_rows`` -> (q int8 [n, dim], scale
    f32 [n]); ids < 0 -> zero rows with scale 1."""
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    n, dim = ids.shape[0], features.shape[1]
    if q_out is None:
        q_out = np.empty((n, dim), np.int8)
    if scale_out is None:
        scale_out = np.empty(n, np.float32)
    lib.cg_gather_quantize_rows(features, dim, ids, n, q_out, scale_out)
    return q_out, scale_out
