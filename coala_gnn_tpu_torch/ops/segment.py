"""COO / segment-sum sparse ops (port of coala_gnn_tpu/ops/segment.py):
the exact message passing over a full graph's edge list, the oracle the
padded-block paths are validated against. No kernel: ``index_add_`` and
``scatter_reduce`` are the segment sums and maxima."""

from __future__ import annotations

from typing import Optional

import torch


def spmm_coo(x_src: torch.Tensor, edge_src: torch.Tensor,
             edge_dst: torch.Tensor, num_dst: int,
             edge_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[v] = sum over edges (u, v) of w_uv * x_src[u] -> [num_dst, *]."""
    msg = x_src[edge_src.long()]
    if edge_weight is not None:
        msg = msg * edge_weight[:, None].to(msg.dtype)
    out = torch.zeros((num_dst, *msg.shape[1:]), dtype=msg.dtype,
                      device=msg.device)
    return out.index_add_(0, edge_dst.long(), msg)


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Softmax of per-edge scores [E, *] within each destination segment,
    stabilised by the segment maximum (0 for an empty segment)."""
    ids = segment_ids.long()
    idx = ids.view(-1, *([1] * (scores.dim() - 1))).expand_as(scores)
    seg_max = torch.full((num_segments, *scores.shape[1:]), -torch.inf,
                         dtype=scores.dtype, device=scores.device)
    seg_max = seg_max.scatter_reduce(0, idx, scores, "amax")
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          torch.zeros_like(seg_max))
    e = torch.exp(scores - seg_max[ids])
    denom = torch.zeros_like(seg_max).index_add_(0, ids, e)
    return e / denom[ids].clamp_min(1e-16)
