"""On-device fanout neighbour sampling (port of
coala_gnn_tpu/sampling/device_sampler.py, CSR layout, ``dedup=False``).

The CSC topology lives in device memory; sampling and block construction
are a few tensor ops per layer, and the only upload per training step is
the seed list. Shapes are static (``block_capacities``). Padded dst rows
carry the sentinel id ``num_nodes``, which reads degree 0 through the
padded ``indptr`` and so samples nothing.

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
also carries its edge's relation id, 0 on masked slots. The ``nbr_cap``
padded table (with its relation table) and ``dedup=True`` are queued in
ROADMAP.md.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from coala_gnn_tpu_torch.cache.feature_cache import assert_ids_fit_int32
from coala_gnn_tpu_torch.models.hetero import DeviceHeteroBlock
from coala_gnn_tpu_torch.models.layers import DeviceBlock
from coala_gnn_tpu_torch.sampling.neighbor import block_capacities


class DeviceGraph(NamedTuple):
    """CSC topology in device memory."""

    indptr: torch.Tensor    # int64 [num_nodes + 2] (sentinel reads degree 0)
    indices: torch.Tensor   # int32 [num_edges + 1] (one trailing pad entry)
    edge_types: Optional[torch.Tensor] = None   # int32 [num_edges + 1]
                                                # (hetero graphs), padded
                                                # like indices

    @property
    def num_nodes(self) -> int:
        return self.indptr.shape[0] - 2


def fits_device_graph(num_nodes: int, num_edges: int) -> bool:
    """Whether the device layout can hold the graph: node ids are int32.
    ``num_edges`` is not bounded (int64 offsets); the argument keeps the
    JAX function's signature."""
    return num_nodes <= np.iinfo(np.int32).max


def to_device_graph(graph, device) -> DeviceGraph:
    """Host CSCGraph -> DeviceGraph on ``device``."""
    assert_ids_fit_int32(graph.num_nodes)
    indptr = np.asarray(graph.indptr, dtype=np.int64)
    indptr = np.concatenate([indptr, indptr[-1:]])

    def padded(a) -> torch.Tensor:
        a = np.concatenate([np.asarray(a).astype(np.int32),
                            np.zeros(1, np.int32)])
        return torch.from_numpy(a).to(device)

    et = getattr(graph, "edge_types", None)
    return DeviceGraph(indptr=torch.from_numpy(indptr).to(device),
                       indices=padded(graph.indices),
                       edge_types=None if et is None else padded(et))


def _sample_layer(g: DeviceGraph, dst: torch.Tensor, fanout: int,
                  generator: Optional[torch.Generator] = None,
                  uniforms: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor,
                             Optional[torch.Tensor]]:
    """One layer: (nbr int32 [n, fanout], mask f32 [n, fanout], rel int32
    [n, fanout] or None). deg <= fanout takes every neighbour in order;
    deg > fanout draws uniformly with replacement (offset = int(u * deg),
    u in [0, 1) f32); masked slots point at dst (rel 0). ``uniforms`` f32
    [n, fanout] replaces the draw from ``generator``."""
    n = dst.shape[0]
    if uniforms is None:
        uniforms = torch.rand(n, fanout, generator=generator,
                              device=dst.device)
    k = torch.arange(fanout, dtype=torch.int32, device=dst.device)[None, :]
    starts = g.indptr[dst]
    deg = (g.indptr[dst + 1] - starts).to(torch.int32)[:, None]
    mask = k < deg.clamp(max=fanout)
    rand_off = (uniforms * deg.clamp(min=1).float()).to(torch.int32)
    seq_off = torch.minimum(k, (deg - 1).clamp(min=0))
    offsets = torch.where(deg <= fanout, seq_off, rand_off)
    edge_pos = starts[:, None] + offsets
    nbr = torch.where(mask, g.indices[edge_pos], dst[:, None])
    rel = None
    if g.edge_types is not None:
        rel = torch.where(mask, g.edge_types[edge_pos],
                          torch.zeros_like(nbr))
    return nbr, mask.float(), rel


def sample_blocks_device(g: DeviceGraph, seeds: torch.Tensor,
                         fanouts: Sequence[int], batch_size: int,
                         generator: Optional[torch.Generator] = None,
                         dedup: bool = False,
                         uniforms: Optional[Sequence[torch.Tensor]] = None
                         ) -> Tuple[List[DeviceBlock], torch.Tensor,
                                    torch.Tensor]:
    """Multi-layer sampling, output-most layer first (the JAX draw order).

    seeds int [batch]. Returns (blocks input-most first, input ids int32
    [cap_src0], number of non-sentinel input ids). Every block has the
    contiguous slot-major layout (``adj is None``): layer input row
    ``cap_dst + k*cap_dst + i`` holds slot (i, k), and input ids equal to
    ``g.num_nodes`` are padding. On a typed graph the blocks are
    ``DeviceHeteroBlock``s. ``uniforms[layer]`` f32 [cap_dst, fanout]
    replaces that layer's draw from ``generator``."""
    if dedup:
        raise NotImplementedError(
            "dedup=True sampling is not ported yet: ROADMAP.md queue A, "
            "\"dedup=True and nbr_cap sampling\"")
    caps = block_capacities(batch_size, fanouts)
    sentinel = g.num_nodes
    blocks: List[DeviceBlock] = []
    dst = seeds.to(torch.int32)
    for layer in range(len(fanouts) - 1, -1, -1):
        cap_dst = caps[layer][0]
        pad = cap_dst - dst.shape[0]
        if pad:
            dst = torch.cat([dst, torch.full((pad,), sentinel,
                                             dtype=torch.int32,
                                             device=dst.device)])
        nbr, mask, rel = _sample_layer(
            g, dst, fanouts[layer], generator,
            None if uniforms is None else uniforms[layer])
        dst = torch.cat([dst, nbr.T.reshape(-1)])
        blocks.insert(0, DeviceBlock(adj=None, mask=mask) if rel is None
                      else DeviceHeteroBlock(adj=None, mask=mask, rel=rel))
    return blocks, dst, (dst != sentinel).sum(dtype=torch.int32)
