"""Fanout neighbour sampling on the host into static-shape padded blocks
(port of ``coala_gnn_tpu/sampling/neighbor.py``, bit for bit: the same
numpy calls and the same native draws, so the same seed gives the same
blocks as the JAX package).

Every layer's block is a dense ``adj`` int32 [cap_dst, fanout] of local
indices into that layer's source ids, plus a float mask; ragged
neighbourhoods are padded, and all capacities derive from ``batch x
prod(fanout_i + 1)`` (``block_capacities``). Destination nodes are a prefix
of the source ids, so a model takes ``h_dst = h[:num_dst]``.

For a destination with degree d and fanout f: d == 0 masks every slot;
0 < d <= f takes all d in-neighbours in CSC order; d > f draws f of them,
without replacement in the native sampler (Floyd's algorithm, one stream
per row), with replacement in the numpy sampler.

``contiguous=True`` gives the dedup-free slot-major layout of the device
sampler (slot (i, k) at input row cap_dst + k*cap_dst + i, invalid slots
holding the sentinel ``num_nodes``, ``adj=None``), whose request carries
ids and labels only (``data/packing.pack_request_contig``).

On a heterogeneous graph (``graph.edge_types`` set) every block also
carries ``rel``, each slot's relation id (0 on masked and padded slots),
drawn with the same neighbours (``cg_sample_layer_typed``); the
contiguous layout stays homogeneous and raises there, as JAX's does.

Unlike the JAX sampler, ``use_native=True`` raises where the native
library does not build (no silent numpy fallback): ``use_native=False``
is the explicit numpy choice.
"""

from __future__ import annotations

import dataclasses
from functools import reduce
from typing import List, Optional, Sequence, Tuple

import numpy as np

from coala_gnn_tpu_torch.native import lib as native_lib


@dataclasses.dataclass
class Block:
    """One message-passing layer: src features -> dst aggregates.

    src_ids : int64 [cap_src]   global node ids, dst ids the prefix; the
                                padded tail holds id 0 (never referenced by
                                a valid adj entry), or the sentinel in the
                                contiguous layout
    adj     : int32 [cap_dst, fanout] local index into src_ids per slot
              (masked slots point at the dst itself); None marks the
              contiguous slot-major layout
    mask    : float32 [cap_dst, fanout], 1.0 = a sampled edge
    num_dst : valid destination count (<= cap_dst)
    num_src : valid source count (<= cap_src)
    rel     : int32 [cap_dst, fanout] relation ids on a heterogeneous
              graph (0 on masked slots), else None
    """

    src_ids: np.ndarray
    adj: Optional[np.ndarray]
    mask: np.ndarray
    num_dst: int
    num_src: int
    rel: Optional[np.ndarray] = None

    @property
    def cap_dst(self) -> int:
        return self.mask.shape[0]

    @property
    def cap_src(self) -> int:
        return self.src_ids.shape[0]

    @property
    def fanout(self) -> int:
        return self.mask.shape[1]


@dataclasses.dataclass
class SampledBatch:
    """All layers of one minibatch; blocks[0] is the input-most layer."""

    blocks: List[Block]
    seeds: np.ndarray        # int64 [batch], the labelled destinations
    input_ids: np.ndarray    # == blocks[0].src_ids (the feature request)
    num_input: int           # valid prefix length of input_ids


def block_capacities(batch_size: int, fanouts: Sequence[int]
                     ) -> List[Tuple[int, int]]:
    """[(cap_dst, cap_src)] per layer, input-most first:
    cap_dst[l] = B * prod_{j>l}(f_j + 1), cap_src[l] = cap_dst[l] * (f_l + 1).
    The output layer has cap_dst = B."""
    caps = []
    cap_dst = batch_size
    for f in reversed(fanouts):  # output-most -> input-most
        caps.append((cap_dst, cap_dst * (f + 1)))
        cap_dst = cap_dst * (f + 1)
    return list(reversed(caps))


def max_sample_size(batch_size: int, fanouts: Sequence[int]) -> int:
    """batch x prod(fanout_i + 1): the size of every request and feature
    buffer."""
    return batch_size * reduce(lambda a, b: a * (b + 1), fanouts, 1)


def _sample_layer_numpy(graph, dst_ids: np.ndarray, fanout: int,
                        rng: np.random.Generator
                        ) -> Tuple[np.ndarray, np.ndarray,
                                   Optional[np.ndarray]]:
    """One layer, vectorised, draws with replacement -> (nbr int64 [n, f],
    mask bool [n, f], rel int32 [n, f] on a typed graph else None)."""
    n = dst_ids.shape[0]
    starts = graph.indptr[dst_ids]
    deg = graph.indptr[dst_ids + 1] - starts
    k = np.arange(fanout, dtype=np.int64)[None, :]
    mask = k < np.minimum(deg, fanout)[:, None]
    small = deg[:, None] <= fanout
    rand_off = (rng.random((n, fanout)) * np.maximum(deg, 1)[:, None]).astype(
        np.int64)
    offsets = np.where(small, np.minimum(k, np.maximum(deg[:, None] - 1, 0)),
                       rand_off)
    edge_pos = starts[:, None] + offsets
    nbr = graph.indices[edge_pos].astype(np.int64)
    rel = None
    if getattr(graph, "edge_types", None) is not None:
        rel = np.where(mask, graph.edge_types[edge_pos], 0).astype(np.int32)
    # masked slots point at the dst itself (a safe local index, weight 0)
    return np.where(mask, nbr, dst_ids[:, None]), mask, rel


class NeighborSampler:
    """Multi-layer fanout sampler. ``fanouts`` are input-most first;
    ``sample(seeds)`` walks from the output layer inwards, deduplicating
    each frontier (or, ``contiguous=True``, keeping every slot), and pads
    every array to the static capacities."""

    def __init__(self, graph, fanouts: Sequence[int], batch_size: int,
                 seed: int = 0, use_native: bool = True,
                 contiguous: bool = False):
        if contiguous and getattr(graph, "edge_types", None) is not None:
            raise NotImplementedError(
                "contiguous host sampling is homogeneous-only (hetero "
                "blocks need the rel plane; use the default layout)")
        self.graph = graph
        self.fanouts = list(fanouts)
        self.batch_size = batch_size
        self.caps = block_capacities(batch_size, fanouts)
        self.rng = np.random.default_rng(seed)
        self.contiguous = contiguous
        self._native = native_lib.get() if use_native else None

    def _sample_layer(self, dst_ids: np.ndarray, fanout: int):
        """-> (nbr, mask, rel or None), as ``_sample_layer_numpy``."""
        if self._native is not None:
            seed = int(self.rng.integers(0, 2**63 - 1))
            if getattr(self.graph, "edge_types", None) is None:
                return (*native_lib.sample_layer(self._native, self.graph,
                                                 dst_ids, fanout, seed), None)
            return native_lib.sample_layer_typed(self._native, self.graph,
                                                 dst_ids, fanout, seed)
        return _sample_layer_numpy(self.graph, dst_ids, fanout, self.rng)

    def sample(self, seeds: np.ndarray) -> SampledBatch:
        seeds = np.asarray(seeds, dtype=np.int64)
        if seeds.shape[0] != self.batch_size:
            raise ValueError(
                f"got {seeds.shape[0]} seeds, expected batch_size="
                f"{self.batch_size} (tail batches are dropped upstream)")
        if self.contiguous:
            return self._sample_contiguous(seeds)
        blocks: List[Block] = []
        dst_ids = seeds
        for layer in range(len(self.fanouts) - 1, -1, -1):
            cap_dst, cap_src = self.caps[layer]
            nbr, mask, rel = self._sample_layer(dst_ids,
                                                self.fanouts[layer])
            blocks.insert(0, _build_block(dst_ids, nbr, mask, cap_dst,
                                          cap_src, rel))
            dst_ids = blocks[0].src_ids[:blocks[0].num_src]
        b0 = blocks[0]
        return SampledBatch(blocks=blocks, seeds=seeds, input_ids=b0.src_ids,
                            num_input=b0.num_src)

    def _sample_contiguous(self, seeds: np.ndarray) -> SampledBatch:
        """Layer l's input ids are ``[dst | nbr.T.flat]``, so slot (i, k)
        sits at the static row cap_dst + k*cap_dst + i; invalid slots hold
        the sentinel ``num_nodes``, so masks follow from the ids alone."""
        sent = self.graph.num_nodes
        dst = seeds
        blocks: List[Block] = []
        for layer in range(len(self.fanouts) - 1, -1, -1):
            cap_dst = self.caps[layer][0]
            assert dst.shape[0] == cap_dst, "contiguous layer-size invariant"
            vdst = dst != sent
            nbr, mask, _ = self._sample_layer(np.where(vdst, dst, 0),
                                              self.fanouts[layer])
            mask = np.asarray(mask, np.float32) * vdst[:, None]
            nbr = np.where(mask > 0, nbr, sent)
            cat = np.concatenate([dst, nbr.T.reshape(-1)])
            blocks.insert(0, Block(src_ids=cat, adj=None, mask=mask,
                                   num_dst=int(vdst.sum()),
                                   num_src=int((cat != sent).sum())))
            dst = cat
        b0 = blocks[0]
        return SampledBatch(blocks=blocks, seeds=seeds, input_ids=b0.src_ids,
                            num_input=b0.num_src)


def _build_block(dst_ids: np.ndarray, nbr: np.ndarray, mask: np.ndarray,
                 cap_dst: int, cap_src: int,
                 rel: Optional[np.ndarray] = None) -> Block:
    """Dedup the sampled frontier into src ids in first-occurrence order
    (the dst ids stay the prefix), relabel adj into local indices, pad to
    capacity (``rel`` with 0)."""
    n_dst, fanout = nbr.shape
    cat = np.concatenate([dst_ids, nbr.reshape(-1)])
    uniq, first_idx, inv = np.unique(cat, return_index=True,
                                     return_inverse=True)
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.shape[0])
    src_ids = uniq[order]
    adj = rank[inv][n_dst:].reshape(n_dst, fanout).astype(np.int32)
    num_src = src_ids.shape[0]
    if num_src > cap_src or n_dst > cap_dst:
        raise AssertionError("capacity overflow; capacities are an invariant")
    src_pad = np.zeros(cap_src, dtype=np.int64)
    src_pad[:num_src] = src_ids
    adj_pad = np.zeros((cap_dst, fanout), dtype=np.int32)
    adj_pad[:n_dst] = adj
    mask_pad = np.zeros((cap_dst, fanout), dtype=np.float32)
    mask_pad[:n_dst] = mask
    rel_pad = None
    if rel is not None:
        rel_pad = np.zeros((cap_dst, fanout), dtype=np.int32)
        rel_pad[:n_dst] = rel
    return Block(src_ids=src_pad, adj=adj_pad, mask=mask_pad, num_dst=n_dst,
                 num_src=num_src, rel=rel_pad)
