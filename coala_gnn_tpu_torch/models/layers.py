"""Graph convolution layers over padded dense blocks (port of
coala_gnn_tpu/models/layers.py).

Weights follow torch ``nn.Linear``: [d_out, d_in]. ``utils/convert.py``
maps the JAX package's flax params ([d_in, d_out] kernels) onto them, and
``lecun_normal_`` initialises them as flax's ``Dense`` does, so a loss
curve of the port is comparable with the JAX one.

A layer input is either a dense tensor [cap_src, d_in], or, for layer 0 of
the resident training step, a ``TableInput``: the flat feature table plus
the frontier ids. The table form reads the dst rows and the neighbour sum
straight from the table (``ops.aggregate.table_agg_mean``), so the gathered
[cap_src, d_in] input is never built.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import torch
from torch import nn

from coala_gnn_tpu_torch.ops.aggregate import agg_mean, table_agg_mean


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
    features [cap_src, dim] with their slot positions ``arange(cap_src)``."""

    table: torch.Tensor   # [rows, dim] f32|bf16, constant
    ids: torch.Tensor     # int32 [cap_src] rows of the frontier, invalid -> 0


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


class SAGEConv(nn.Module):
    """GraphSAGE 'mean': fc_self(h_dst) + fc_neigh(mean of neighbours),
    fc_neigh without bias."""

    def __init__(self, d_in: int, d_out: int, generator: torch.Generator):
        super().__init__()
        self.fc_self = _linear(d_in, d_out, True, generator)
        self.fc_neigh = _linear(d_in, d_out, False, generator)

    def forward(self, block: DeviceBlock, x: LayerInput) -> torch.Tensor:
        if isinstance(x, TableInput):
            if block.adj is not None:
                raise ValueError("a TableInput needs the contiguous block "
                                 "layout (adj is None)")
            h_dst = x.table[x.ids[:block.cap_dst]].float()
            h_neigh = table_agg_mean(x.table, x.ids, block.mask)
        else:
            h_dst = x[:block.cap_dst]
            h_neigh = agg_mean(x, block.adj, block.mask)
        return self.fc_self(h_dst) + self.fc_neigh(h_neigh)
