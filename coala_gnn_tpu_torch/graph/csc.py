"""CSC graph container (port of ``coala_gnn_tpu/graph/csc.py``: the parts
the port uses). For destination node v its in-neighbours are
``indices[indptr[v]:indptr[v+1]]`` (edge direction src -> dst)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class CSCGraph:
    """indptr int64 [num_nodes + 1], indices [num_edges] (source ids)."""

    indptr: np.ndarray
    indices: np.ndarray

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


def coo_to_csc(src: np.ndarray, dst: np.ndarray, num_nodes: int) -> CSCGraph:
    """CSC from COO edge lists: a stable counting sort by destination."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    if src.shape != dst.shape:
        raise ValueError("src/dst shape mismatch")
    counts = np.bincount(dst, minlength=num_nodes).astype(np.int64)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    order = np.argsort(dst, kind="stable")
    return CSCGraph(indptr=indptr, indices=src[order])
