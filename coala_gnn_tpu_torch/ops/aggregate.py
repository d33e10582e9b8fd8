"""Neighbourhood aggregation over padded dense blocks (port of
coala_gnn_tpu/ops/aggregate.py).

Two block layouts, as in the JAX package:
  - ``adj`` given (the host sampler's dedup layout): int32 [n_dst, fanout]
    local indices into the layer input; aggregation is ``fanout`` row
    gathers with f32 accumulation. On a CUDA tensor that is the
    gather-SpMM kernel's contract, so ``padded_gather_sum`` launches it
    (and through it ``padded_mean``, ``agg_sum`` and ``agg_mean`` with an
    adj); its backward is the kernel's ``grad_x`` over a transpose of adj
    built per call (adj changes every step). On a CPU tensor it is the
    slot-order loop, the kernel's plain version.
  - ``adj is None``: the device sampler's contiguous SLOT-major layout, where
    the neighbour in slot (i, k) sits at input row ``cap_dst + k*cap_dst + i``;
    aggregation is ``fanout`` multiply-adds over contiguous [cap_dst, dim]
    planes, with no gather at all (torch ops, as JAX leaves them to XLA).

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
    """out[i] = sum_k weights[i, k] * x_src[adj[i, k]] -> [n_dst, dim]:
    the gather-SpMM kernel on a CUDA tensor, the slot-order loop on the
    CPU."""
    if x_src.is_cuda:
        return gather_spmm(x_src.contiguous(), adj.to(torch.int32).contiguous(),
                           weights.to(torch.float32).contiguous()
                           ).to(x_src.dtype)
    acc_t = _acc_dtype(x_src.dtype)
    acc = torch.zeros(adj.shape[0], x_src.shape[1], dtype=acc_t,
                      device=x_src.device)
    for k in range(adj.shape[1]):
        acc = acc + x_src[adj[:, k]].to(acc_t) * weights[:, k, None].to(acc_t)
    return acc.to(x_src.dtype)


def live_or_own(adj: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """``adj`` [..., n_dst, fanout] with every slot that is not ``live``
    pointed at its own dst row i (the host sampler's convention for masked
    slots; the dst ids are the prefix of the source ids). A zero-weight
    slot adds nothing and is skipped by the kernel, but it still names its
    row in the transpose the backward builds: the padded dst rows' slots
    all name row 0, and stacked relations name every row R times, which
    serialises grad_x (and the transpose's ordering pass) on such rows."""
    own = torch.arange(adj.shape[-2], dtype=adj.dtype,
                       device=adj.device)[:, None]
    return torch.where(live, adj, own)


def relation_gather_sum(x_src: torch.Tensor, adj: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """The R relations' neighbour sums of one layer in one
    ``padded_gather_sum``: ``out[r, i] = sum_k weights[r, i, k] *
    x_src[adj[i, k]]`` -> [R, n_dst, dim] in x_src's dtype, for
    ``weights`` [R, n_dst, fanout] (a relation's mask, 0 on the other
    relations' slots). Row ``r * n_dst + i`` of the stacked launch is adj's
    row i with relation r's weights, its zero-weight slots pointed at row i
    (``live_or_own``), so on a CUDA tensor the kernel reads each sampled
    edge's row once (it skips the w == 0 slots, forward and grad_x) and
    its backward builds one transpose for all R, in which a row is named
    by its live slots; on the CPU it is the slot-order loop over the
    stacked rows, each row the sum a per-relation ``padded_gather_sum``
    gives."""
    n_rel, n_dst, fanout = weights.shape
    adj_s = live_or_own(adj[None], weights != 0)
    out = padded_gather_sum(x_src, adj_s.reshape(n_rel * n_dst, fanout),
                            weights.reshape(n_rel * n_dst, fanout))
    return out.view(n_rel, n_dst, x_src.shape[1])


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
                  scale: Optional[torch.Tensor] = None,
                  read_as: Optional[torch.dtype] = None,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``agg_sum(rows, None, weights)`` of the frontier rows ``table[ids]``
    (widened to f32, or for an int8 table dequantised with ``scale``;
    ``read_as=torch.bfloat16``: each element then rounded to bf16, the
    rows a bf16 model reads) without building them: the weighted sum runs
    in the gather-SpMM kernel straight off the table at the slots' ids
    (``frontier_adj``), in f32, and is rounded once to ``out_dtype``.
    GCN's layer 0, whose weights are the block mask times 1 / degree.
    -> [cap_dst, dim] ``out_dtype``."""
    adj = frontier_adj(ids, tuple(weights.shape))
    return gather_spmm(table, adj, weights.contiguous(), scale,
                       read_as=read_as).to(out_dtype)


def table_agg_mean(table: torch.Tensor, ids: torch.Tensor,
                   mask: torch.Tensor,
                   scale: Optional[torch.Tensor] = None,
                   read_as: Optional[torch.dtype] = None,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``agg_mean`` of the frontier rows ``table[ids]`` through
    ``table_agg_sum``: the sum in ``out_dtype``, then the division by the
    clamped count in ``out_dtype``, the JAX order of operations (a bf16
    model rounds the f32 sum, then divides in bf16).
    -> [cap_dst, dim] ``out_dtype``."""
    count = mask.sum(dim=1).clamp_min(1.0)
    s = table_agg_sum(table, ids, mask, scale, read_as, out_dtype)
    return s / count[:, None].to(s.dtype)
