"""Neighbourhood aggregation over padded dense blocks (port of
coala_gnn_tpu/ops/aggregate.py).

Two block layouts, as in the JAX package:
  - ``adj`` given: int32 [n_dst, fanout] local indices into the layer input;
    aggregation is ``fanout`` row gathers with f32 accumulation.
  - ``adj is None``: the device sampler's contiguous SLOT-major layout, where
    the neighbour in slot (i, k) sits at input row ``cap_dst + k*cap_dst + i``;
    aggregation is ``fanout`` multiply-adds over contiguous [cap_dst, dim]
    planes, with no gather at all.

bf16 inputs accumulate in f32 and round back to the input dtype at the end,
and slots are summed in order k = 0..F-1, exactly as the JAX functions do.
"""

from __future__ import annotations

from typing import Optional

import torch

from coala_gnn_tpu_torch.ops.gather_spmm import gather_spmm


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype == torch.bfloat16 else dtype


def padded_gather_sum(x_src: torch.Tensor, adj: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_k weights[i, k] * x_src[adj[i, k]] -> [n_dst, dim]."""
    acc_t = _acc_dtype(x_src.dtype)
    acc = torch.zeros(adj.shape[0], x_src.shape[1], dtype=acc_t,
                      device=x_src.device)
    for k in range(adj.shape[1]):
        acc = acc + x_src[adj[:, k]].to(acc_t) * weights[:, k, None].to(acc_t)
    return acc.to(x_src.dtype)


def padded_gather_sum_dense(x_src: torch.Tensor, adj: torch.Tensor,
                            weights: torch.Tensor) -> torch.Tensor:
    """Same contract as ``padded_gather_sum`` via one 3-D gather
    [n_dst, fanout, dim] and a weighted reduce."""
    nbr = x_src[adj]
    return torch.einsum("nfd,nf->nd", nbr, weights.to(x_src.dtype))


def padded_mean(x_src: torch.Tensor, adj: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Masked neighbourhood mean (zero for dst rows with no neighbour)."""
    count = mask.sum(dim=1).clamp_min(1.0)
    s = padded_gather_sum(x_src, adj, mask)
    return s / count[:, None].to(s.dtype)


def slot_planes(x_src: torch.Tensor, shape: tuple) -> torch.Tensor:
    """[fanout, cap_dst, *] slot-major neighbour planes of a contiguous
    block: a view of rows cap_dst .. cap_dst * (1 + fanout)."""
    cap_dst, fanout = shape
    sl = x_src[cap_dst:cap_dst + cap_dst * fanout]
    return sl.reshape(fanout, cap_dst, *x_src.shape[1:])


def neighbor_view(x_src: torch.Tensor, adj: Optional[torch.Tensor],
                  shape: tuple) -> torch.Tensor:
    """[n_dst, fanout, *] neighbour tensor of a block, shape = (cap_dst,
    fanout): a transposed view for the contiguous layout, else one gather."""
    if adj is None:
        return slot_planes(x_src, shape).transpose(0, 1)
    return x_src[adj]


def agg_sum(x_src: torch.Tensor, adj: Optional[torch.Tensor],
            weights: torch.Tensor) -> torch.Tensor:
    """Weighted neighbour sum; ``adj is None`` takes the plane path."""
    if adj is None:
        cap_dst, fanout = weights.shape
        acc_t = _acc_dtype(x_src.dtype)
        w = weights.to(acc_t)
        acc = torch.zeros(cap_dst, x_src.shape[1], dtype=acc_t,
                          device=x_src.device)
        for k in range(fanout):
            plane = x_src[cap_dst * (1 + k):cap_dst * (2 + k)]
            acc = acc + plane.to(acc_t) * w[:, k, None]
        return acc.to(x_src.dtype)
    return padded_gather_sum(x_src, adj, weights)


def agg_mean(x_src: torch.Tensor, adj: Optional[torch.Tensor],
             mask: torch.Tensor) -> torch.Tensor:
    """Masked neighbourhood mean with contiguous dispatch."""
    if adj is None:
        count = mask.sum(dim=1).clamp_min(1.0)
        s = agg_sum(x_src, None, mask)
        return s / count[:, None].to(s.dtype)
    return padded_mean(x_src, adj, mask)


def frontier_adj(ids: torch.Tensor, shape: tuple) -> torch.Tensor:
    """int32 [cap_dst, fanout] ids of a contiguous block's slots, shape =
    (cap_dst, fanout): slot (i, k) holds ``ids[cap_dst + k*cap_dst + i]``,
    so this is that slice viewed [fanout, cap_dst] and transposed."""
    cap_dst, fanout = shape
    adj = ids[cap_dst:cap_dst * (1 + fanout)].view(fanout, cap_dst).T
    return adj.to(torch.int32).contiguous()


def table_agg_sum(table: torch.Tensor, ids: torch.Tensor,
                  weights: torch.Tensor,
                  scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``agg_sum(rows, None, weights)`` of the frontier rows ``table[ids]``
    (widened to f32, or for an int8 table dequantised with ``scale``)
    without building them: the weighted sum runs in the gather-SpMM kernel
    straight off the table at the slots' ids (``frontier_adj``). GCN's
    layer 0, whose weights are the block mask times 1 / degree.
    -> f32 [cap_dst, dim]."""
    adj = frontier_adj(ids, tuple(weights.shape))
    return gather_spmm(table, adj, weights.contiguous(), scale)


def table_agg_mean(table: torch.Tensor, ids: torch.Tensor,
                   mask: torch.Tensor,
                   scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``agg_mean`` of the frontier rows ``table[ids]`` through
    ``table_agg_sum``: sum, then divide by the clamped count, the JAX
    order of operations. -> f32 [cap_dst, dim]."""
    count = mask.sum(dim=1).clamp_min(1.0)
    return table_agg_sum(table, ids, mask, scale) / count[:, None]
