"""The CSC topology sharded over the ranks, sampled by routing the frontier
(port of coala_gnn_tpu/sampling/sharded_topology.py).

``to_device_graph`` copies ``indptr`` / ``indices`` onto every card: fine
up to a few hundred million edges, not for papers100M-class graphs (~3.2B
symmetrised edges) beside the feature cache. Here rank ``r`` keeps only
the adjacency lists of the nodes it owns (``id % world == r``, the sharded
cache's ownership rule), ~E/world edges a card.

A frontier layer then reads other ranks' lists, collectively:

  1. ``all_gather`` of the frontier ids (4 bytes a slot), so every rank
     sees every rank's frontier;
  2. each rank draws the fanout slots of the rows it owns from its own
     shard; the rows it does not own contribute exact zeros;
  3. one reduce-scatter (sum) of the ``[world * n, ...]`` contribution grid
     returns each rank its own frontier's neighbour ids, degrees and (on a
     typed graph) relations, packed in one int32 grid: every row has one
     owner and the others add zeros, so the sum is the owner's value.

The slots follow ``device_sampler._sample_layer`` (deg <= fanout in
order, deg > fanout uniform with replacement, masked slots -> dst, their
relation 0), so the blocks keep ``sample_blocks_device(dedup=False)``'s
contract and the models and caches do not see where the topology lives.
The uniforms of a layer are drawn over the gathered ``[world * n,
fanout]`` grid from the rank's own sampling stream and used by the owner
of each row (JAX folds the device index into the key); a caller may pass
them in (``uniforms``), as to ``sample_blocks_device``.

Differences from the JAX module (ROADMAP.md section C): a rank holds its
own shard only, ``indptr`` as int64 offsets (``to_device_graph``'s), so
there is no uint32 promotion, and ``indices`` with one trailing pad entry
(as ``to_device_graph`` pads its own); the three ``psum_scatter`` calls of
a layer are one reduce-scatter of a packed grid.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from coala_gnn_tpu_torch.cache.feature_cache import assert_ids_fit_int32
from coala_gnn_tpu_torch.models.hetero import DeviceHeteroBlock
from coala_gnn_tpu_torch.models.layers import DeviceBlock
from coala_gnn_tpu_torch.sampling.neighbor import block_capacities

#: the ledger phase of the sampler's collectives
PHASE = "topology"


class ShardedTopology(NamedTuple):
    """One rank's CSC shard on its card. Owned node ``id`` (``id % world
    == rank``) lives at local row ``id // world``; rows past the rank's
    owned count have degree 0. ``indices`` holds global neighbour ids,
    padded with 0 past the rank's edge count up to the largest rank's,
    and one trailing pad entry, so that a degree-0 row at the end reads in
    bounds (JAX clamps the gather instead); the pads are never used."""

    indptr: torch.Tensor                        # int64 [rows + 1]
    indices: torch.Tensor                       # int32 [max_e + 1]
    edge_types: Optional[torch.Tensor] = None   # int32 [max_e + 1]
    rank: int = 0
    world: int = 1
    num_nodes: int = 0


def _local_edge_counts(indptr: np.ndarray, N: int, n_dev: int,
                       chunk_rows: int) -> np.ndarray:
    """Owned-edge totals of every rank, O(chunk) transient memory."""
    totals = np.zeros(n_dev, np.int64)
    for d in range(n_dev):
        for lo in range(d, N, chunk_rows * n_dev):
            own = np.arange(lo, min(lo + chunk_rows * n_dev, N), n_dev,
                            dtype=np.int64)
            totals[d] += int((indptr[own + 1] - indptr[own]).sum())
    return totals


def shard_topology_arrays(graph, n_dev: int,
                          device_ids: Optional[Sequence[int]] = None,
                          chunk_rows: int = 1 << 20
                          ) -> Tuple[np.ndarray, np.ndarray,
                                     Optional[np.ndarray]]:
    """The host build, bitwise JAX's: a CSCGraph -> the stacked shards of
    ``device_ids`` (default: every rank): indptr [len(device_ids), rows +
    1] (int32, or uint32 past int32), indices int32 [.., max_e],
    edge_types or None. Owned rows stream in chunks of ``chunk_rows``, so
    transient memory is O(chunk * avg degree) whatever E is, and
    ``graph.indices`` / ``graph.edge_types`` may be memory maps (never read
    whole); ``max_e`` is the largest rank's, so every shard has one
    shape."""
    N = graph.num_nodes
    assert_ids_fit_int32(N)
    indptr = np.asarray(graph.indptr, dtype=np.int64)
    indices = graph.indices
    if isinstance(indices, (list, tuple)):
        indices = np.asarray(indices)
    et = getattr(graph, "edge_types", None)
    rows = -(-N // n_dev)
    device_ids = list(range(n_dev) if device_ids is None else device_ids)

    totals = _local_edge_counts(indptr, N, n_dev, chunk_rows)
    max_e = max(int(totals.max()), 1)
    n_out = len(device_ids)
    local_ptrs = np.zeros((n_out, rows + 1), np.int64)
    idx_out = np.zeros((n_out, max_e), np.int32)
    et_out = np.zeros((n_out, max_e), np.int32) if et is not None else None

    for i, d in enumerate(device_ids):
        own_total = -(-max(N - d, 0) // n_dev)   # owned rows of rank d
        csum = local_ptrs[i]
        filled = 0
        for lo in range(d, N, chunk_rows * n_dev):
            own = np.arange(lo, min(lo + chunk_rows * n_dev, N), n_dev,
                            dtype=np.int64)
            starts = indptr[own]
            deg = indptr[own + 1] - starts
            base = csum[filled]
            np.cumsum(deg, out=csum[filled + 1: filled + 1 + own.size])
            csum[filled + 1: filled + 1 + own.size] += base
            # each edge's position in the global indices array
            n_e = int(deg.sum())
            pos = (np.arange(n_e, dtype=np.int64)
                   - np.repeat(csum[filled: filled + own.size] - base, deg)
                   + np.repeat(starts, deg))
            idx_out[i, base: base + n_e] = np.asarray(indices[pos],
                                                      dtype=np.int32)
            if et is not None:
                et_out[i, base: base + n_e] = np.asarray(et[pos],
                                                         dtype=np.int32)
            filled += own.size
        csum[own_total + 1:] = csum[own_total]   # padded rows: degree 0

    ptr_dtype = (np.int32 if local_ptrs.max() <= np.iinfo(np.int32).max
                 else np.uint32)
    if local_ptrs.max() > np.iinfo(np.uint32).max:
        raise ValueError("per-device edge shard exceeds uint32 offsets; "
                         "increase the mesh size")
    return local_ptrs.astype(ptr_dtype), idx_out, et_out


def put_sharded_topology(graph, mesh,
                         chunk_rows: int = 1 << 20) -> ShardedTopology:
    """This rank's shard of ``graph`` on the mesh's card: built on the host
    for this rank alone (``max_e`` still the largest rank's), offsets
    int64, one pad entry after the edges."""
    ptrs, idx, et = shard_topology_arrays(graph, mesh.world, [mesh.rank],
                                          chunk_rows)
    dev = mesh.device

    def padded(a):
        return torch.from_numpy(np.concatenate([a[0], np.zeros(
            1, np.int32)])).to(dev)

    return ShardedTopology(
        indptr=torch.from_numpy(ptrs[0].astype(np.int64)).to(dev),
        indices=padded(idx), edge_types=None if et is None else padded(et),
        rank=mesh.rank, world=mesh.world, num_nodes=graph.num_nodes)


def _sample_layer_sharded(topo: ShardedTopology, mesh, dst: torch.Tensor,
                          fanout: int,
                          generator: Optional[torch.Generator] = None,
                          uniforms: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     Optional[torch.Tensor]]:
    """One frontier layer against the sharded topology: (nbr int32 [n,
    fanout], mask f32, rel int32 or None), ``_sample_layer``'s slots.
    Collective: an all-gather of ``dst``, then one reduce-scatter.
    ``uniforms`` f32 [world * n, fanout] replaces the draw from
    ``generator``."""
    n, w = dst.shape[0], topo.world
    flat = mesh.all_gather(dst, PHASE)                       # [w * n]
    if uniforms is None:
        uniforms = torch.rand(flat.shape[0], fanout, generator=generator,
                              device=dst.device)
    owned = (flat < topo.num_nodes) & (flat % w == topo.rank)
    row = torch.where(owned, flat // w, torch.zeros_like(flat)).long()
    starts = topo.indptr[row]
    deg = torch.where(owned, (topo.indptr[row + 1] - starts).to(torch.int32),
                      torch.zeros_like(flat))[:, None]
    k = torch.arange(fanout, dtype=torch.int32, device=dst.device)[None, :]
    rand_off = (uniforms * deg.clamp(min=1).float()).to(torch.int32)
    seq_off = torch.minimum(k, (deg - 1).clamp(min=0))
    edge_pos = starts[:, None] + torch.where(deg <= fanout, seq_off,
                                             rand_off)
    slot = k < deg.clamp(max=fanout)                         # owner's mask
    zero = torch.zeros((), dtype=torch.int32, device=dst.device)
    parts = [torch.where(slot, topo.indices[edge_pos], zero), deg]
    if topo.edge_types is not None:
        parts.append(torch.where(slot, topo.edge_types[edge_pos], zero))
    got = mesh.reduce_scatter(torch.cat(parts, 1), PHASE)    # [n, ...]
    nbr, deg_out = got[:, :fanout], got[:, fanout:fanout + 1]
    mask = k < deg_out.clamp(max=fanout)
    nbr = torch.where(mask, nbr, dst[:, None])
    rel = None
    if topo.edge_types is not None:
        rel = torch.where(mask, got[:, fanout + 1:], zero)
    return nbr, mask.float(), rel


def sample_blocks_sharded(topo: ShardedTopology, mesh, seeds: torch.Tensor,
                          fanouts: Sequence[int], batch_size: int,
                          generator: Optional[torch.Generator] = None,
                          uniforms: Optional[Sequence[torch.Tensor]] = None
                          ) -> Tuple[List[DeviceBlock], torch.Tensor,
                                     torch.Tensor]:
    """Multi-layer sampling against the sharded topology, collective over
    the mesh's ranks: ``sample_blocks_device(dedup=False)``'s contract
    (slot-major blocks, ``adj`` None, input ids padded with the sentinel
    ``num_nodes``; ``DeviceHeteroBlock``s on a typed graph). ``seeds``
    int [batch] are this rank's; ``uniforms[layer]`` f32 [world * cap_dst,
    fanout] replaces that layer's draw."""
    caps = block_capacities(batch_size, fanouts)
    sentinel = topo.num_nodes
    blocks: List[DeviceBlock] = []
    dst = seeds.to(torch.int32)
    for layer in range(len(fanouts) - 1, -1, -1):
        cap_dst, fanout = caps[layer][0], fanouts[layer]
        pad = cap_dst - dst.shape[0]
        if pad:
            dst = torch.cat([dst, torch.full((pad,), sentinel,
                                             dtype=torch.int32,
                                             device=dst.device)])
        nbr, mask, rel = _sample_layer_sharded(
            topo, mesh, dst, fanout, generator,
            None if uniforms is None else uniforms[layer])
        dst = torch.cat([dst, nbr.T.reshape(-1)])
        blocks.insert(0, DeviceBlock(adj=None, mask=mask) if rel is None
                      else DeviceHeteroBlock(adj=None, mask=mask, rel=rel))
    return blocks, dst, (dst != sentinel).sum(dtype=torch.int32)
