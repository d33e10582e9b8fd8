"""On-device fanout neighbour sampling (port of
coala_gnn_tpu/sampling/device_sampler.py).

The CSC topology lives in device memory; sampling and block construction
are a few tensor ops per layer, and the only upload per training step is
the seed list. Shapes are static (``block_capacities``). Padded dst rows
carry the sentinel id ``num_nodes``, which reads degree 0 through the
padded ``indptr`` and so samples nothing.

Two layouts of the topology, as in JAX: CSR (``indptr`` / ``indices``),
and with ``to_device_graph(nbr_cap=P)`` also the padded neighbour table
[N + 1, P], one aligned row per dst (``_sample_layer`` reads it instead of
the CSR arrays). The table is built on the host exactly as JAX builds it,
so it is bitwise JAX's; sampling from it equals the CSR draw for every
dst with degree <= P and reads a seeded P-subset above.

Two block layouts: ``dedup=False`` (the trainers' windows) keeps every
sampled slot as a source row, slot-major (``adj is None``);
``dedup=True`` deduplicates each layer's [dst | slots] array in order of
first occurrence (``_dedup_first_occurrence``: one stable sort, two
``scatter_reduce`` minima and a second sort, plain torch ops as JAX leaves
them to XLA) and gives each block a local, dst-major ``adj``.

Differences from the JAX module, each recorded in ROADMAP.md section C:
  - offsets are int64, so there is no uint32 promotion and no edge limit
    beyond memory (``fits_device_graph``);
  - uniforms come from a ``torch.Generator`` (Philox on CUDA), not from
    threefry keys: the same seed gives other draws. ``_sample_layer`` and
    ``sample_blocks_device`` take the uniforms as an optional argument, so
    tests can feed in JAX's draws and get bitwise-equal blocks;
  - ``indices`` (and ``edge_types``) carry one trailing pad entry, so the
    degree-0 read at ``indptr[num_nodes]`` stays in bounds (JAX clamps the
    gather instead).
On a heterogeneous graph the blocks are ``DeviceHeteroBlock``s: each slot
also carries its edge's relation id, 0 on masked slots (from ``rel_table``
on the padded table).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from coala_gnn_tpu_torch.cache.feature_cache import assert_ids_fit_int32
from coala_gnn_tpu_torch.models.hetero import DeviceHeteroBlock
from coala_gnn_tpu_torch.models.layers import DeviceBlock
from coala_gnn_tpu_torch.sampling.neighbor import block_capacities


INT32_MAX = np.iinfo(np.int32).max


class DeviceGraph(NamedTuple):
    """CSC topology in device memory, and optionally the padded neighbour
    table (``to_device_graph(nbr_cap=P)``): row i holds node i's first
    min(deg, P) neighbours in CSR order (a seeded random P-subset when
    deg > P), repeated to fill P slots, plus a trailing sentinel row."""

    indptr: torch.Tensor    # int64 [num_nodes + 2] (sentinel reads degree 0)
    indices: torch.Tensor   # int32 [num_edges + 1] (one trailing pad entry)
    edge_types: Optional[torch.Tensor] = None   # int32 [num_edges + 1]
                                                # (hetero graphs), padded
                                                # like indices
    nbr_table: Optional[torch.Tensor] = None    # int32 [num_nodes + 1, P]
    nbr_deg: Optional[torch.Tensor] = None      # int32 [num_nodes + 1],
                                                # min(deg, P), sentinel 0
    rel_table: Optional[torch.Tensor] = None    # int32 [num_nodes + 1, P]
                                                # (hetero graphs)

    @property
    def num_nodes(self) -> int:
        return self.indptr.shape[0] - 2


def fits_device_graph(num_nodes: int, num_edges: int) -> bool:
    """Whether the device layout can hold the graph: node ids are int32.
    ``num_edges`` is not bounded (int64 offsets); the argument keeps the
    JAX function's signature."""
    return num_nodes <= np.iinfo(np.int32).max


def neighbor_table(graph, nbr_cap: int, nbr_seed: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """The padded neighbour table on the host, as JAX's ``to_device_graph``
    builds it: (table int32 [N + 1, P], effective degrees int32 [N + 1],
    relation table int32 [N + 1, P] or None). Slot j of row i holds
    neighbour ``j mod deg_i`` in CSR order; a row with deg > P holds the
    edges ``np.random.default_rng(nbr_seed).choice(deg, P, replace=False)``
    (drawn row by row in node order); a degree-0 row holds its own id and
    the sentinel row N holds N."""
    if nbr_cap < 1:
        raise ValueError("nbr_cap must be >= 1")
    indptr = np.asarray(graph.indptr, dtype=np.int64)
    et = getattr(graph, "edge_types", None)
    N, P = graph.num_nodes, int(nbr_cap)
    indices = np.asarray(graph.indices, dtype=np.int64)
    deg = np.diff(indptr)
    tbl = np.empty((N + 1, P), np.int32)
    deg_eff = np.minimum(deg, P).astype(np.int32)
    rel = None
    if indices.size:
        col = np.arange(P, dtype=np.int64)
        pos = indptr[:-1, None] + col[None, :] % np.maximum(deg, 1)[:, None]
        pos = np.where(deg[:, None] > 0, pos, 0)
        rng = np.random.default_rng(nbr_seed)
        for i in np.flatnonzero(deg > P):
            pos[i] = indptr[i] + rng.choice(deg[i], P, replace=False)
        tbl[:-1] = np.where(deg[:, None] > 0, indices[pos],
                            np.arange(N, dtype=np.int64)[:, None])
        if et is not None:
            rel = np.empty((N + 1, P), np.int32)
            rel[:-1] = np.where(deg[:, None] > 0,
                                np.asarray(et, np.int64)[pos], 0)
            rel[-1] = 0
    else:
        tbl[:-1] = np.arange(N, dtype=np.int32)[:, None]
    tbl[-1] = N
    return tbl, np.concatenate([deg_eff, np.zeros(1, np.int32)]), rel


def to_device_graph(graph, device, nbr_cap: Optional[int] = None,
                    nbr_seed: int = 0) -> DeviceGraph:
    """Host CSCGraph -> DeviceGraph on ``device``. ``nbr_cap=P`` also
    builds the padded neighbour table (``neighbor_table``, on the host,
    then moved): (N + 1) * P * 4 bytes, twice that on a typed graph."""
    assert_ids_fit_int32(graph.num_nodes)
    indptr = np.asarray(graph.indptr, dtype=np.int64)
    indptr = np.concatenate([indptr, indptr[-1:]])

    def padded(a) -> torch.Tensor:
        # one int32 host copy of a (maybe memory-mapped) array, plus a pad
        out = np.empty(len(a) + 1, np.int32)
        out[:-1] = a
        out[-1] = 0
        return torch.from_numpy(out).to(device)

    def put(a) -> Optional[torch.Tensor]:
        return None if a is None else torch.from_numpy(a).to(device)

    et = getattr(graph, "edge_types", None)
    tbl = deg = rel = None
    if nbr_cap is not None:
        tbl, deg, rel = neighbor_table(graph, nbr_cap, nbr_seed)
    return DeviceGraph(indptr=torch.from_numpy(indptr).to(device),
                       indices=padded(graph.indices),
                       edge_types=None if et is None else padded(et),
                       nbr_table=put(tbl), nbr_deg=put(deg),
                       rel_table=put(rel))


def _sample_layer(g: DeviceGraph, dst: torch.Tensor, fanout: int,
                  generator: Optional[torch.Generator] = None,
                  uniforms: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor,
                             Optional[torch.Tensor]]:
    """One layer: (nbr int32 [n, fanout], mask f32 [n, fanout], rel int32
    [n, fanout] or None). deg <= fanout takes every neighbour in order;
    deg > fanout draws uniformly with replacement (offset = int(u * deg),
    u in [0, 1) f32); masked slots point at dst (rel 0). ``uniforms`` f32
    [n, fanout] replaces the draw from ``generator``. With the padded
    table the same offsets index each dst's table row (one row gather and
    a ``torch.gather``), deg being the effective min(deg, P)."""
    n = dst.shape[0]
    if uniforms is None:
        uniforms = torch.rand(n, fanout, generator=generator,
                              device=dst.device)
    k = torch.arange(fanout, dtype=torch.int32, device=dst.device)[None, :]
    table = g.nbr_table is not None
    if table:
        deg = g.nbr_deg[dst][:, None]
    else:
        starts = g.indptr[dst]
        deg = (g.indptr[dst + 1] - starts).to(torch.int32)[:, None]
    mask = k < deg.clamp(max=fanout)
    rand_off = (uniforms * deg.clamp(min=1).float()).to(torch.int32)
    seq_off = torch.minimum(k, (deg - 1).clamp(min=0))
    offsets = torch.where(deg <= fanout, seq_off, rand_off)
    rel = None
    if table:
        offsets = offsets.long()
        nbr = torch.gather(g.nbr_table[dst], 1, offsets)
        if g.rel_table is not None:
            rel = torch.gather(g.rel_table[dst], 1, offsets)
    else:
        edge_pos = starts[:, None] + offsets
        nbr = g.indices[edge_pos]
        if g.edge_types is not None:
            rel = g.edge_types[edge_pos]
    nbr = torch.where(mask, nbr, dst[:, None])
    if rel is not None:
        rel = torch.where(mask, rel, torch.zeros_like(rel))
    return nbr, mask.float(), rel


def _dedup_first_occurrence(cat: torch.Tensor, sentinel: int
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Static-shape first-occurrence dedup of ``cat`` int32 [L] (may hold
    ``sentinel``), JAX's algorithm op for op. Returns
      uniq  int32 [L]: the distinct values in order of first occurrence,
                       the sentinel (if present) forced last, tail zeros;
      local int32 [L]: the uniq index of each element of cat;
      num   int32 []:  the number of distinct non-sentinel values.
    ``segment_min`` is ``scatter_reduce_("amin", include_self=False)``
    into INT32_MAX, which an empty run keeps, as JAX's fills it."""
    L = cat.shape[0]
    dev = cat.device
    pos = torch.arange(L, dtype=torch.int32, device=dev)
    order = torch.sort(cat, stable=True).indices
    s = cat[order]
    p = pos[order]
    new_run = torch.ones(L, dtype=torch.int32, device=dev)
    new_run[1:] = (s[1:] != s[:-1]).to(torch.int32)
    run_id = torch.cumsum(new_run, 0) - 1                  # int64 [L]
    n_runs = run_id[-1] + 1

    def segment_min(v: torch.Tensor) -> torch.Tensor:
        out = torch.full((L,), INT32_MAX, dtype=torch.int32, device=dev)
        return out.scatter_reduce_(0, run_id, v, "amin", include_self=False)

    first_pos = segment_min(p)
    run_val = segment_min(s)
    big = 2 * L + 2
    rank_key = torch.where(run_val == sentinel,
                           torch.full_like(first_pos, big),
                           first_pos.clamp(max=big))
    run_order = torch.sort(rank_key, stable=True).indices
    run_rank = torch.empty(L, dtype=torch.int32, device=dev)
    run_rank[run_order] = pos
    local_sorted = run_rank[run_id]
    local = torch.empty(L, dtype=torch.int32, device=dev)
    local[order] = local_sorted
    uniq = torch.zeros(L, dtype=torch.int32, device=dev)
    uniq[local_sorted.long()] = s
    num = (n_runs - (cat == sentinel).any().to(n_runs.dtype)).to(torch.int32)
    return uniq, local, num


def sample_blocks_device(g: DeviceGraph, seeds: torch.Tensor,
                         fanouts: Sequence[int], batch_size: int,
                         generator: Optional[torch.Generator] = None,
                         dedup: bool = False,
                         uniforms: Optional[Sequence[torch.Tensor]] = None
                         ) -> Tuple[List[DeviceBlock], torch.Tensor,
                                    torch.Tensor]:
    """Multi-layer sampling, output-most layer first (the JAX draw order).

    seeds int [batch]. Returns (blocks input-most first, input ids int32
    [cap_src0], number of valid input ids). ``dedup=False``: every block
    has the contiguous slot-major layout (``adj is None``): layer input
    row ``cap_dst + k*cap_dst + i`` holds slot (i, k), and input ids equal
    to ``g.num_nodes`` are padding. ``dedup=True``: each layer's input is
    the distinct ids of [dst | slots] in order of first occurrence, the
    dst rows first, ``adj`` int32 [cap_dst, fanout] indexes it, and the
    input ids are valid below the returned count. On a typed graph the
    blocks are ``DeviceHeteroBlock``s. ``uniforms[layer]`` f32 [cap_dst,
    fanout] replaces that layer's draw from ``generator``."""
    caps = block_capacities(batch_size, fanouts)
    sentinel = g.num_nodes
    blocks: List[DeviceBlock] = []
    dst = seeds.to(torch.int32)
    num = torch.tensor(batch_size, dtype=torch.int32, device=dst.device)
    for layer in range(len(fanouts) - 1, -1, -1):
        cap_dst, fanout = caps[layer][0], fanouts[layer]
        pad = cap_dst - dst.shape[0]
        if pad:
            dst = torch.cat([dst, torch.full((pad,), sentinel,
                                             dtype=torch.int32,
                                             device=dst.device)])
        if dedup:
            live = torch.arange(cap_dst, device=dst.device) < num
            dst = torch.where(live, dst, torch.full_like(dst, sentinel))
        nbr, mask, rel = _sample_layer(
            g, dst, fanout, generator,
            None if uniforms is None else uniforms[layer])
        if dedup:
            cat = torch.cat([dst, nbr.reshape(-1)])
            dst, local, num = _dedup_first_occurrence(cat, sentinel)
            adj = local[cap_dst:].view(cap_dst, fanout)
        else:
            dst = torch.cat([dst, nbr.T.reshape(-1)])
            adj = None
        blocks.insert(0, DeviceBlock(adj=adj, mask=mask) if rel is None
                      else DeviceHeteroBlock(adj=adj, mask=mask, rel=rel))
    if not dedup:
        num = (dst != sentinel).sum(dtype=torch.int32)
    return blocks, dst, num
