"""CSC graph container and its on-disk artifacts (port of
``coala_gnn_tpu/graph/csc.py``). For destination node v its in-neighbours
are ``indices[indptr[v]:indptr[v+1]]`` (edge direction src -> dst). A
heterogeneous graph carries one relation id per edge (``edge_types``),
in the same order as ``indices``.

``save_csc`` / ``load_csc`` write and read the reference's
``csc_indptr.npy`` / ``csc_indices.npy`` / ``csc_edge_ids.npy`` artifacts
(plus ``csc_edge_types.npy`` for a typed graph), the same files the JAX
package reads and writes. ``load_csc(mmap=True)`` keeps every array a
read-only memory map: a 10M-node graph's 1.2 GB ``indices`` is never
copied into RAM here."""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

# .npy artifact names of the reference's converter
_INDPTR = "csc_indptr.npy"
_INDICES = "csc_indices.npy"
_EDGE_IDS = "csc_edge_ids.npy"
_EDGE_TYPES = "csc_edge_types.npy"


@dataclasses.dataclass
class CSCGraph:
    """indptr int64 [num_nodes + 1], indices [num_edges] (source ids);
    edge_ids [num_edges] or None (the COO position of each edge, unused by
    compute paths); edge_types int32 [num_edges] or None (a homogeneous
    graph). Arrays that already have the right dtype and layout (a memory
    map among them) are kept as they are, not copied."""

    indptr: np.ndarray
    indices: np.ndarray
    edge_ids: Optional[np.ndarray] = None
    edge_types: Optional[np.ndarray] = None
    num_edge_types: int = 1

    def __post_init__(self) -> None:
        self.indptr = _as(self.indptr, np.int64)
        self.indices = _as(self.indices)
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

    def in_neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]

    def reverse(self) -> "CSCGraph":
        """CSC of the reversed graph (the CSR of this graph)."""
        dst = np.repeat(np.arange(self.num_nodes, dtype=self.indices.dtype),
                        np.diff(self.indptr))
        return coo_to_csc(self.indices, dst, self.num_nodes)


def _as(a, dtype=None) -> np.ndarray:
    """``a`` itself where it is a C-contiguous array of ``dtype`` (any
    dtype for None; a memory map stays one), else a contiguous copy."""
    if isinstance(a, np.ndarray) and a.flags["C_CONTIGUOUS"] and \
            (dtype is None or a.dtype == dtype):
        return a
    return np.ascontiguousarray(a, dtype=dtype)


def coo_to_csc(src: np.ndarray, dst: np.ndarray, num_nodes: int,
               edge_ids: Optional[np.ndarray] = None,
               edge_types: Optional[np.ndarray] = None) -> CSCGraph:
    """CSC from COO edge lists: a stable counting sort by destination.
    ``edge_ids`` ride the permutation (default: each edge's COO position,
    int64); ``edge_types`` (int [E]) too, as int32, ``num_edge_types``
    then being their max + 1."""
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
    indices = src[order]
    eids = None
    if edge_ids is not None:
        eids = np.asarray(edge_ids)[order]
    elif src.shape[0] > 0:
        eids = order.astype(np.int64)
    ets, n_et = None, 1
    if edge_types is not None:
        ets = np.ascontiguousarray(np.asarray(edge_types)[order], np.int32)
        n_et = int(ets.max()) + 1 if ets.size else 1
    return CSCGraph(indptr=indptr, indices=indices, edge_ids=eids,
                    edge_types=ets, num_edge_types=n_et)


def save_csc(graph: CSCGraph, path: str) -> None:
    """The graph's arrays as .npy artifacts in ``path`` (made if absent);
    edge ids and edge types only where the graph has them."""
    os.makedirs(path, exist_ok=True)
    np.save(os.path.join(path, _INDPTR), graph.indptr)
    np.save(os.path.join(path, _INDICES), graph.indices)
    if graph.edge_ids is not None:
        np.save(os.path.join(path, _EDGE_IDS), graph.edge_ids)
    if graph.edge_types is not None:
        np.save(os.path.join(path, _EDGE_TYPES), graph.edge_types)


def load_csc(path: str, mmap: bool = True) -> CSCGraph:
    """The artifacts of ``save_csc`` (or of the JAX package's); with
    ``mmap`` every array is a read-only memory map of its file."""
    mode = "r" if mmap else None

    def load(name):
        p = os.path.join(path, name)
        return np.load(p, mmap_mode=mode) if os.path.exists(p) else None

    ets = load(_EDGE_TYPES)
    return CSCGraph(indptr=load(_INDPTR), indices=load(_INDICES),
                    edge_ids=load(_EDGE_IDS), edge_types=ets,
                    num_edge_types=1 if ets is None else int(ets.max()) + 1)
