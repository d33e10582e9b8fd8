"""Graph convolution layers over padded dense blocks (port of
coala_gnn_tpu/models/layers.py).

Weights follow torch ``nn.Linear``: [d_out, d_in]. ``utils/convert.py``
maps the JAX package's flax params ([d_in, d_out] kernels) onto them, and
``lecun_normal_`` initialises them as flax's ``Dense`` does, so a loss
curve of the port is comparable with the JAX one.

A layer input is either a dense tensor [cap_src, d_in], or, for layer 0 of
the resident training step, a ``TableInput``: the flat feature table
(f32, bf16, or int8 with per-row scales) plus the frontier ids. SAGE and
GCN read the dst rows and the neighbour sum straight from the table
(``ops.aggregate.table_agg_mean`` / ``table_agg_sum``), so the gathered
[cap_src, d_in] input is never built. GAT's ``fc`` needs every source row,
so its layer 0 reads the frontier ``table[ids]`` first, as JAX's
``flat_lookup`` does.

GAT's attention combine runs through the gather-SpMM kernel with the
heads stacked as rows: ``feat`` [cap_src, H, F] is viewed as
[cap_src * H, F], slot (i, k) of head h reads row ``adj[i, k] * H + h``
with weight ``alpha[i, k, h]``, and one launch gives [cap_dst * H, F].
The slot order (k = 0..F-1, f32) is the JAX plane FMAs' order; the
backward (``grad_x`` into ``feat``, ``grad_w`` into ``alpha``) is the
kernel's own.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from coala_gnn_tpu_torch.cache.feature_cache import dequantize_rows
from coala_gnn_tpu_torch.ops.aggregate import (agg_mean, agg_sum,
                                               frontier_adj, neighbor_view,
                                               table_agg_mean, table_agg_sum)
from coala_gnn_tpu_torch.ops.gather_spmm import gather_spmm


class DeviceBlock(NamedTuple):
    """One sampled layer. ``adj is None`` marks the contiguous slot-major
    layout (slot (i, k) at input row cap_dst + k*cap_dst + i)."""

    adj: Optional[torch.Tensor]   # int32 [cap_dst, fanout], or None
    mask: torch.Tensor            # float32 [cap_dst, fanout]

    @property
    def cap_dst(self) -> int:
        return self.mask.shape[0]

    @property
    def fanout(self) -> int:
        return self.mask.shape[1]


class TableInput(NamedTuple):
    """Layer-0 input read straight from a constant feature table: the flat
    cache table with the frontier's node ids, or a window's frontier
    features [cap_src, dim] with their slot positions ``arange(cap_src)``.
    An int8 table comes with its per-row f32 ``scale``."""

    table: torch.Tensor   # [rows, dim] f32|bf16|int8, constant
    ids: torch.Tensor     # int32 [cap_src] rows of the frontier, invalid -> 0
    scale: Optional[torch.Tensor] = None   # f32 [rows] for an int8 table

    def rows(self, n: Optional[int] = None) -> torch.Tensor:
        """The first ``n`` (default all) frontier rows as f32 [n, dim]
        (int8 rows dequantised)."""
        ids = self.ids if n is None else self.ids[:n]
        if self.scale is None:
            return self.table[ids].float()
        return dequantize_rows(self.table[ids], self.scale[ids])


LayerInput = Union[torch.Tensor, TableInput]


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator
                  ) -> torch.Tensor:
    """flax's default kernel init (variance_scaling(1, "fan_in",
    "truncated_normal")): a normal truncated to +-2 std, with std
    sqrt(1/fan_in) / 0.8796... so that the truncated draw has variance
    1/fan_in. fan_in is d_in, the second dim of a torch weight."""
    std = math.sqrt(1.0 / weight.shape[1]) / .87962566103423978
    return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


def _linear(d_in: int, d_out: int, bias: bool,
            generator: torch.Generator) -> nn.Linear:
    lin = nn.utils.skip_init(nn.Linear, d_in, d_out, bias=bias)
    with torch.no_grad():
        lecun_normal_(lin.weight, generator)
        if bias:
            lin.bias.zero_()
    return lin


def glorot_uniform_(param: torch.Tensor, generator: torch.Generator
                    ) -> torch.Tensor:
    """flax's ``glorot_uniform`` on a 2-D param: uniform on +-sqrt(6 /
    (fan_in + fan_out)), fan_in = shape[0], fan_out = shape[1]."""
    limit = math.sqrt(6.0 / (param.shape[0] + param.shape[1]))
    return nn.init.uniform_(param, -limit, limit, generator=generator)


def head_stacked_adj(adj: Optional[torch.Tensor], n_src: int, shape: tuple,
                     heads: int, device) -> torch.Tensor:
    """int32 [cap_dst * heads, fanout] rows of the head-stacked combine,
    shape = (cap_dst, fanout): slot (i, k) of head h reads row
    ``adj[i, k] * heads + h`` of feat viewed [n_src * heads, F]. ``adj is
    None`` (the contiguous layout) takes the slot positions,
    ``frontier_adj(arange(n_src))``, so each row of feat is read by
    exactly one slot."""
    if n_src * heads > torch.iinfo(torch.int32).max:
        raise ValueError(f"{n_src} x {heads} head rows exceed int32")
    if adj is None:
        adj = frontier_adj(torch.arange(n_src, dtype=torch.int32,
                                        device=device), shape)
    h = torch.arange(heads, device=device)
    return (adj.long()[:, None, :] * heads + h[None, :, None]) \
        .reshape(shape[0] * heads, shape[1]).to(torch.int32)


def _needs_contiguous(block: "DeviceBlock") -> None:
    if block.adj is not None:
        raise ValueError("a TableInput needs the contiguous block layout "
                         "(adj is None)")


class SAGEConv(nn.Module):
    """GraphSAGE 'mean': fc_self(h_dst) + fc_neigh(mean of neighbours),
    fc_neigh without bias."""

    def __init__(self, d_in: int, d_out: int, generator: torch.Generator):
        super().__init__()
        self.fc_self = _linear(d_in, d_out, True, generator)
        self.fc_neigh = _linear(d_in, d_out, False, generator)

    def forward(self, block: DeviceBlock, x: LayerInput) -> torch.Tensor:
        if isinstance(x, TableInput):
            _needs_contiguous(block)
            h_dst = x.rows(block.cap_dst)
            h_neigh = table_agg_mean(x.table, x.ids, block.mask, x.scale)
        else:
            h_dst = x[:block.cap_dst]
            h_neigh = agg_mean(x, block.adj, block.mask)
        return self.fc_self(h_dst) + self.fc_neigh(h_neigh)


class GraphConv(nn.Module):
    """GCN layer with right (mean) normalisation over the block's sampled
    in-degrees: fc(sum_k mask[i, k] / deg_i * h[nbr]), zero for a dst row
    with no neighbour (the JAX module's deliberate divergence from DGL's
    norm='both'). Layer 0 with a ``TableInput`` sums straight off the
    table (``table_agg_sum``); layers above 0 use ``agg_sum``."""

    def __init__(self, d_in: int, d_out: int, generator: torch.Generator):
        super().__init__()
        self.fc = _linear(d_in, d_out, True, generator)

    def forward(self, block: DeviceBlock, x: LayerInput) -> torch.Tensor:
        deg = block.mask.sum(dim=1)
        norm = torch.where(deg > 0, 1.0 / deg, torch.zeros_like(deg))
        w = block.mask * norm[:, None]
        if isinstance(x, TableInput):
            _needs_contiguous(block)
            agg = table_agg_sum(x.table, x.ids, w, x.scale)
        else:
            agg = agg_sum(x, block.adj, w)
        return self.fc(agg)


class GATConv(nn.Module):
    """Multi-head graph attention over the padded block -> [cap_dst, H, F]:
    scores by the kernel fold ``el = x @ (W . attn_l)``, ``er = x[:cap_dst]
    @ (W . attn_r)``, a leaky ReLU, a softmax over the fanout axis with
    masked slots at -1e9, ``alpha * mask`` (all-masked rows -> 0), then the
    combine through the gather-SpMM kernel, heads stacked (module
    docstring)."""

    def __init__(self, d_in: int, features: int, num_heads: int,
                 generator: torch.Generator, negative_slope: float = 0.2):
        super().__init__()
        self.num_heads, self.features = num_heads, features
        self.negative_slope = negative_slope
        self.fc = _linear(d_in, num_heads * features, False, generator)
        self.attn_l = nn.Parameter(torch.empty(num_heads, features))
        self.attn_r = nn.Parameter(torch.empty(num_heads, features))
        with torch.no_grad():
            glorot_uniform_(self.attn_l, generator)
            glorot_uniform_(self.attn_r, generator)

    def forward(self, block: DeviceBlock, x: LayerInput) -> torch.Tensor:
        # the score fold x @ (W . attn) equals feat . attn only while fc has
        # no bias
        assert self.fc.bias is None, "GATConv's score fold needs fc " \
            "without bias"
        if isinstance(x, TableInput):
            x = x.rows()
        H, Fh = self.num_heads, self.features
        n_src, cap_dst, fanout = x.shape[0], block.cap_dst, block.fanout
        shape = (cap_dst, fanout)
        feat = self.fc(x)                                  # [n_src, H * F]
        W = self.fc.weight.T.reshape(-1, H, Fh)            # [d_in, H, F]
        el = x @ torch.einsum("dhf,hf->dh", W, self.attn_l)
        er = x[:cap_dst] @ torch.einsum("dhf,hf->dh", W, self.attn_r)
        e = neighbor_view(el, block.adj, shape) + er[:, None, :]
        e = F.leaky_relu(e, self.negative_slope)
        mask = block.mask[:, :, None]
        e = torch.where(mask > 0, e, torch.full_like(e, -1e9))
        alpha = torch.softmax(e, dim=1) * mask             # [cap_dst, F, H]
        adj_h = head_stacked_adj(block.adj, n_src, shape, H, x.device)
        w_h = alpha.permute(0, 2, 1).reshape(cap_dst * H, fanout).contiguous()
        out = gather_spmm(feat.reshape(n_src * H, Fh), adj_h, w_h)
        return out.view(cap_dst, H, Fh)
