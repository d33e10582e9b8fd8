"""Relational (heterogeneous) layers and model stacks: RSAGE, RGCN and RGAT
(port of coala_gnn_tpu/models/hetero.py).

A hetero block carries each slot's relation id, ``rel`` int32 [cap_dst,
fanout] (0 on masked slots). A relational layer aggregates once per
relation r with the mask restricted to it, ``mask * (rel == r)``, applies
relation r's weights and sums the relations in order r = 0..R-1, as the
JAX layers do.

On the host sampler's layout (``adj`` given) the R aggregations of a layer
are one gather-SpMM call with the relations stacked as rows:
  - RSAGE / RGCN share the layer input: stacked row ``r * cap_dst + i`` is
    adj's row i with relation r's weights (``ops.aggregate.
    relation_gather_sum``), -> [R, cap_dst, D];
  - RGAT's relations each have their own feat, computed by one batched
    matmul as [R, n_src, H, F] and viewed [R * n_src * H, F]; slot (i, k)
    of relation r, head h reads row ``r * n_src * H + adj[i, k] * H + h``
    with weight ``alpha_r[i, k, h]`` (``layers.head_stacked_adj`` with
    ``num_rels``), -> [R * cap_dst * H, F].
Each slot is live in one relation only, and the kernel skips w == 0 slots
in the forward and in grad_x, so the one launch reads each sampled edge's
row once; the dead slots of a relation point at their own dst row
(``ops.aggregate.live_or_own``), so the one transpose of the stacked adj
that the backward builds per layer and step names each row by its live
slots. On the contiguous layout (``adj is None``, the device sampler's)
RSAGE and RGCN run the relations' plane sums as plain torch ops, as JAX
leaves them to XLA; RGAT keeps the stacked kernel there too, over the slot
positions, with the stacked adj and its transpose built once per shape.

``dtype`` follows the JAX modules' rounding points: Dense layers cast input,
f32 weight and bias to ``dtype`` (``layers._dense``); the sums accumulate in
f32 and round once to the input's dtype; RGAT's attention params are
``dtype`` params and its scores and softmax run in ``dtype``, ``alpha *
mask`` in f32. On the ``adj`` layout JAX's RGAT adds bf16 ``feat`` rows
times the f32 ``alpha`` plane by plane, which promotes: its output is f32
there (bf16 on the contiguous layout, whose einsum casts ``alpha`` to
bf16 first). The port keeps both.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from coala_gnn_tpu_torch.models.gnn import _convs, _Stack
from coala_gnn_tpu_torch.models.layers import (_attention_param, _dense,
                                               _linear, head_stacked_adj)
from coala_gnn_tpu_torch.ops.aggregate import (agg_sum, live_or_own,
                                               neighbor_view,
                                               relation_gather_sum)
from coala_gnn_tpu_torch.ops.gather_spmm import adj_transpose, gather_spmm


class DeviceHeteroBlock(NamedTuple):
    """One sampled layer of a heterogeneous graph. ``adj is None`` marks
    the contiguous slot-major layout (slot (i, k) at input row cap_dst +
    k*cap_dst + i)."""

    adj: Optional[torch.Tensor]   # int32 [cap_dst, fanout], or None
    mask: torch.Tensor            # float32 [cap_dst, fanout]
    rel: torch.Tensor             # int32 [cap_dst, fanout]

    @property
    def cap_dst(self) -> int:
        return self.mask.shape[0]

    @property
    def fanout(self) -> int:
        return self.mask.shape[1]


def hetero_blocks_to_device(blocks: Sequence, device) -> list:
    """Host blocks (``sampling.neighbor.Block`` with ``rel``) ->
    DeviceHeteroBlocks on ``device``."""
    out = []
    for b in blocks:
        if b.rel is None:
            raise ValueError("block has no edge types; sample from a hetero "
                             "graph (CSCGraph.edge_types set)")
        out.append(DeviceHeteroBlock(
            adj=None if b.adj is None else torch.from_numpy(b.adj).to(device),
            mask=torch.from_numpy(b.mask).to(device),
            rel=torch.from_numpy(b.rel).to(device)))
    return out


def relation_masks(block: DeviceHeteroBlock, num_rels: int) -> torch.Tensor:
    """f32 [R, cap_dst, fanout]: ``mask * (rel == r)`` for each relation."""
    r = torch.arange(num_rels, device=block.rel.device)
    return block.mask[None] * (block.rel[None] == r[:, None, None])


def _relation_sums(x: torch.Tensor, block: DeviceHeteroBlock,
                   weights: torch.Tensor) -> torch.Tensor:
    """[R, cap_dst, D] neighbour sums with per-relation ``weights`` [R,
    cap_dst, fanout]: one stacked launch on the ``adj`` layout, the plane
    sums per relation on the contiguous one."""
    if block.adj is None:
        return torch.stack([agg_sum(x, None, w) for w in weights])
    return relation_gather_sum(x, block.adj, weights)


class RelSAGEConv(nn.Module):
    """Per-relation mean aggregation and neighbour weight, summed over the
    relations: fc_self(h_dst) + sum_r fc_neigh_r{r}(mean_r)."""

    def __init__(self, d_in: int, d_out: int, num_rels: int,
                 generator: torch.Generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_rels, self.dtype = num_rels, dtype
        self.fc_self = _linear(d_in, d_out, True, generator)
        for r in range(num_rels):
            setattr(self, f"fc_neigh_r{r}", _linear(d_in, d_out, False,
                                                    generator))

    def forward(self, block: DeviceHeteroBlock, x: torch.Tensor
                ) -> torch.Tensor:
        m = relation_masks(block, self.num_rels)
        sums = _relation_sums(x, block, m)
        count = m.sum(dim=2).clamp_min(1.0)
        out = _dense(self.fc_self, x[:block.cap_dst], self.dtype)
        for r in range(self.num_rels):
            h = sums[r] / count[r][:, None].to(sums.dtype)
            out = out + _dense(getattr(self, f"fc_neigh_r{r}"), h,
                               self.dtype)
        return out


class RelGraphConv(nn.Module):
    """RGCN layer: per-relation sums normalised by the relation's sampled
    in-degree (zero where it has none), each through its own fc_r{r} (with
    bias), summed over the relations."""

    def __init__(self, d_in: int, d_out: int, num_rels: int,
                 generator: torch.Generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_rels, self.dtype = num_rels, dtype
        for r in range(num_rels):
            setattr(self, f"fc_r{r}", _linear(d_in, d_out, True, generator))

    def forward(self, block: DeviceHeteroBlock, x: torch.Tensor
                ) -> torch.Tensor:
        m = relation_masks(block, self.num_rels)
        deg = m.sum(dim=2)
        norm = torch.where(deg > 0, 1.0 / deg, torch.zeros_like(deg))
        aggs = _relation_sums(x, block, m * norm[:, :, None])
        out = _dense(self.fc_r0, aggs[0], self.dtype)
        for r in range(1, self.num_rels):
            out = out + _dense(getattr(self, f"fc_r{r}"), aggs[r],
                               self.dtype)
        return out


class RelGATConv(nn.Module):
    """Per-relation masked attention, heads meaned inside the layer (so the
    width does not grow between layers), summed over the relations. Per
    relation r: feat_r = fc_r{r}(x) [n_src, H, F], scores from attn_l_r{r}
    / attn_r_r{r} (folded into fc's weight, as ``GATConv`` does), a leaky
    ReLU, a softmax over the relation's slots (the others at -1e9),
    ``alpha * mask_r``; all R combines in one stacked kernel call (module
    docstring)."""

    def __init__(self, d_in: int, features: int, num_rels: int,
                 num_heads: int, generator: torch.Generator,
                 negative_slope: float = 0.2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_rels, self.num_heads, self.features = (num_rels, num_heads,
                                                        features)
        self.negative_slope, self.dtype = negative_slope, dtype
        for r in range(num_rels):
            setattr(self, f"fc_r{r}", _linear(d_in, num_heads * features,
                                              False, generator))
            setattr(self, f"attn_l_r{r}", _attention_param(
                (num_heads, features), generator, dtype))
            setattr(self, f"attn_r_r{r}", _attention_param(
                (num_heads, features), generator, dtype))
        self._combines: dict = {}   # (n_src, shape, device) -> adj, adj_t

    def _stacked(self, prefix: str) -> torch.Tensor:
        return torch.stack([getattr(self, f"{prefix}{r}")
                            for r in range(self.num_rels)])

    def forward(self, block: DeviceHeteroBlock, x: torch.Tensor
                ) -> torch.Tensor:
        dt = self.dtype
        R, H, Fh = self.num_rels, self.num_heads, self.features
        x = x.to(dt)
        n_src, cap_dst, fanout = x.shape[0], block.cap_dst, block.fanout
        shape = (cap_dst, fanout)
        W = torch.stack([getattr(self, f"fc_r{r}").weight
                         for r in range(R)]).to(dt)       # [R, H * F, d_in]
        feat = torch.matmul(x, W.transpose(1, 2))         # [R, n_src, H * F]
        Wh = W.view(R, H, Fh, -1)
        fold_l = torch.einsum("rhfd,rhf->drh", Wh, self._stacked(
            "attn_l_r").to(dt)).reshape(-1, R * H)
        fold_r = torch.einsum("rhfd,rhf->drh", Wh, self._stacked(
            "attn_r_r").to(dt)).reshape(-1, R * H)
        el = x @ fold_l                                    # [n_src, R * H]
        er = x[:cap_dst] @ fold_r                          # [cap_dst, R * H]
        e = neighbor_view(el, block.adj, shape) + er[:, None, :]
        e = F.leaky_relu(e, self.negative_slope)
        m_rel = relation_masks(block, R)                   # [R, cap, F]
        m = m_rel.permute(1, 2, 0).repeat_interleave(H, dim=2)  # [cap, F, RH]
        e = torch.where(m > 0, e, torch.full_like(e, -1e9))
        alpha = torch.softmax(e, dim=1) * m
        if block.adj is None:      # JAX's einsum casts alpha to feat's dtype
            alpha = alpha.to(dt).float()
        w = alpha.view(cap_dst, fanout, R, H).permute(2, 0, 3, 1) \
            .reshape(R * cap_dst * H, fanout).contiguous()
        adj_s, adj_t = self._combine_adj(block, m_rel > 0, n_src, shape,
                                         x.device)
        out = gather_spmm(feat.reshape(R * n_src * H, Fh), adj_s, w,
                          adj_t=adj_t)
        if block.adj is None:
            out = out.to(dt)
        agg = out.view(R, cap_dst, H, Fh).mean(dim=2)
        h = agg[0]
        for r in range(1, R):
            h = h + agg[r]
        return h

    def _combine_adj(self, block: DeviceHeteroBlock, live: torch.Tensor,
                     n_src: int, shape: tuple, device) -> tuple:
        """(stacked adj, its transpose or None): a block's own adj is
        stacked per call, each relation's dead slots (``live`` [R, cap_dst,
        fanout] false) pointed at their own dst row (``live_or_own``), and
        its backward builds the transpose;
        the contiguous layout's depends only on the shapes and is kept,
        with its transpose."""
        R, H = self.num_rels, self.num_heads
        if block.adj is not None:
            return head_stacked_adj(live_or_own(block.adj[None], live),
                                    n_src, shape, H, device, R), None
        key = (n_src, shape, str(device))
        if key not in self._combines:
            adj_s = head_stacked_adj(None, n_src, shape, H, device, R)
            self._combines[key] = (adj_s, adj_transpose(adj_s,
                                                        R * n_src * H))
        return self._combines[key]


class _RelStack(_Stack):
    """Relational layers named ``layer_{i}``; ReLU and dropout between
    layers, logits in f32."""


def make_hetero_model(model_type: str, in_dim: int, hidden: int,
                      num_classes: int, num_rels: int, num_layers: int = 2,
                      num_heads: int = 2, dropout: float = 0.5,
                      seed: int = 0, dtype: torch.dtype = torch.float32
                      ) -> nn.Module:
    """rsage | rgcn | rgat, the JAX package's make_hetero_model; ``in_dim``
    as for ``make_model``."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"make_hetero_model: dtype must be float32 or "
                         f"bfloat16, got {dtype}")
    if model_type == "rsage":
        conv = lambda d, o, g, dt: RelSAGEConv(d, o, num_rels, g, dt)
    elif model_type == "rgcn":
        conv = lambda d, o, g, dt: RelGraphConv(d, o, num_rels, g, dt)
    elif model_type == "rgat":
        conv = lambda d, o, g, dt: RelGATConv(d, o, num_rels, num_heads, g,
                                              dtype=dt)
    else:
        raise ValueError(f"unknown hetero model {model_type!r}")
    return _RelStack(_convs(conv, in_dim, hidden, num_classes, num_layers,
                            seed, dtype), dropout, dtype)
