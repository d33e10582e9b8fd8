"""Fanout neighbour sampling, plain: the blocks a training step trains on,
worked out again from the CSC arrays, the seeds and the step's stream.

A step's sampling stream is a ``torch.Generator`` seeded from
``numpy.random.SeedSequence(seed, spawn_key=(window, step, 0))`` (stream 0
is sampling, 1 dropout); the run keys a window by the step it starts at.
Layers are drawn output-most first, each from one ``torch.rand(cap_dst,
fanout)`` of that generator. For a destination of in-degree ``deg``: with
``deg <= fanout`` slot k takes neighbour k (a live slot while k < deg);
otherwise slot k takes neighbour ``int(u * deg)`` (``u`` and the product
in f32). A dead slot, and every slot of a padded destination (id
``num_nodes``), points at its destination. Layer l's input is its
destinations followed by its slots, slot-major (slot (i, k) at
``cap_dst + k * cap_dst + i``). On a typed graph each slot also carries
its edge's relation, ``edge_types`` at the edge's CSC position, and 0 on a
dead slot (the port's convention, ``models/hetero.py``). Where the data
types its nodes (``node_type_offsets`` int64 [T + 1]: type t holds the ids
``offsets[t] <= id < offsets[t + 1]``, the predict type first, as the
port's ``graph/datasets.py`` ``_flatten_hetero`` lays them out), each
layer's destinations also carry their type, and -1 on a padded one. None
of this draws from the stream.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

SAMPLE, DROPOUT = 0, 1


def stream_seed(seed: int, window: int, step: int, stream: int) -> int:
    """The 63-bit seed of one (window, step, stream) of the root seed."""
    ss = np.random.SeedSequence(seed, spawn_key=(window, step, stream))
    return int(ss.generate_state(1, np.uint64)[0] >> 1)


def stream(seed: int, window: int, step: int, kind: int,
           device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, window, step, kind))
    return g


def capacities(batch: int, fanouts: Sequence[int]) -> List[Tuple[int, int]]:
    """[(cap_dst, cap_src)] per layer, input-most first."""
    caps, cap_dst = [], batch
    for f in reversed(fanouts):
        caps.append((cap_dst, cap_dst * (f + 1)))
        cap_dst *= f + 1
    return caps[::-1]


def sample(indptr: torch.Tensor, indices: torch.Tensor, num_nodes: int,
           seeds: torch.Tensor, fanouts: Sequence[int], batch: int,
           gen: torch.Generator,
           edge_types: Optional[torch.Tensor] = None,
           node_type_offsets: Optional[torch.Tensor] = None) -> tuple:
    """(frontier ids int64 [cap_src of layer 0], masks f32 [cap_dst,
    fanout] per layer, rels per layer: int32 [cap_dst, fanout] where
    ``edge_types`` [E] is given, else None, destination types per layer:
    int32 [cap_dst] where ``node_type_offsets`` [T + 1] is given, else
    None), layers input-most first. ``indptr`` int64 [N + 1],
    ``indices``, ``edge_types`` and ``node_type_offsets`` on the
    generator's device."""
    caps = capacities(batch, fanouts)
    dst = seeds.long()
    masks: List[torch.Tensor] = []
    rels: List[Optional[torch.Tensor]] = []
    ntypes: List[Optional[torch.Tensor]] = []
    for layer in range(len(fanouts) - 1, -1, -1):
        cap_dst, f = caps[layer][0], fanouts[layer]
        if dst.numel() < cap_dst:
            dst = torch.cat([dst, dst.new_full((cap_dst - dst.numel(),),
                                               num_nodes)])
        u = torch.rand(cap_dst, f, generator=gen, device=dst.device)
        real = dst < num_nodes
        ntypes.insert(0, dst_types(dst, real, node_type_offsets))
        safe = torch.where(real, dst, torch.zeros_like(dst))
        start = indptr[safe]
        deg = torch.where(real, indptr[safe + 1] - start,
                          torch.zeros_like(start))
        k = torch.arange(f, device=dst.device)[None, :]
        take_all = (deg <= f)[:, None]
        drawn = (u * deg[:, None].clamp(min=1).float()).to(torch.int64)
        offset = torch.where(take_all, k, drawn)
        live = k < deg[:, None].clamp(max=f)
        pos = torch.where(live, start[:, None] + offset,
                          torch.zeros_like(offset))
        nbr = torch.where(live, indices[pos].long(), dst[:, None])
        masks.insert(0, live.float())
        rel = None
        if edge_types is not None:
            rel = edge_types[pos]
            rel = torch.where(live, rel, torch.zeros_like(rel))
        rels.insert(0, rel)
        dst = torch.cat([dst, nbr.T.reshape(-1)])
    return dst, masks, rels, ntypes


def dst_types(dst: torch.Tensor, real: torch.Tensor,
              offsets: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Each destination's node type (int32; -1 where not ``real``), or
    None without ``offsets``."""
    if offsets is None:
        return None
    t = torch.searchsorted(offsets, dst, right=True) - 1
    return torch.where(real, t, torch.full_like(t, -1)).to(torch.int32)
