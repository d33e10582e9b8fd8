"""CSC graph container (port of ``coala_gnn_tpu/graph/csc.py``: the parts
the port uses). For destination node v its in-neighbours are
``indices[indptr[v]:indptr[v+1]]`` (edge direction src -> dst). A
heterogeneous graph carries one relation id per edge (``edge_types``),
in the same order as ``indices``."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class CSCGraph:
    """indptr int64 [num_nodes + 1], indices [num_edges] (source ids);
    edge_types int32 [num_edges] or None (a homogeneous graph)."""

    indptr: np.ndarray
    indices: np.ndarray
    edge_types: Optional[np.ndarray] = None
    num_edge_types: int = 1

    def __post_init__(self) -> None:
        self.indptr = np.ascontiguousarray(self.indptr, dtype=np.int64)
        self.indices = np.ascontiguousarray(self.indices)
        if self.indptr.ndim != 1 or self.indices.ndim != 1:
            raise ValueError("indptr/indices must be 1-D")
        if self.indptr[0] != 0 or self.indptr[-1] != self.indices.shape[0]:
            raise ValueError("indptr does not index indices")

    @property
    def num_nodes(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    def in_degrees(self, nodes: Optional[np.ndarray] = None) -> np.ndarray:
        deg = np.diff(self.indptr)
        return deg if nodes is None else deg[nodes]


def coo_to_csc(src: np.ndarray, dst: np.ndarray, num_nodes: int,
               edge_types: Optional[np.ndarray] = None) -> CSCGraph:
    """CSC from COO edge lists: a stable counting sort by destination.
    ``edge_types`` (int [E]) ride the same permutation, as int32;
    ``num_edge_types`` is then their max + 1."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    if src.shape != dst.shape:
        raise ValueError("src/dst shape mismatch")
    if edge_types is not None and np.asarray(edge_types).shape != src.shape:
        raise ValueError("edge_types/src shape mismatch")
    counts = np.bincount(dst, minlength=num_nodes).astype(np.int64)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    order = np.argsort(dst, kind="stable")
    ets, n_et = None, 1
    if edge_types is not None:
        ets = np.ascontiguousarray(np.asarray(edge_types)[order], np.int32)
        n_et = int(ets.max()) + 1 if ets.size else 1
    return CSCGraph(indptr=indptr, indices=src[order], edge_types=ets,
                    num_edge_types=n_et)
