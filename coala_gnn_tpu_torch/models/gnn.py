"""Model stacks over sampled blocks (port of coala_gnn_tpu/models/gnn.py).

Forward contract as in the JAX package: per layer ``h = conv(block, h)``
with ReLU + dropout between layers, logits in f32. GAT flattens its heads
between layers and takes their mean at the output. Models are f32; the
bf16 model dtype and the hetero models are queued in ROADMAP.md.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from coala_gnn_tpu_torch.models.layers import (DeviceBlock, GATConv,
                                               GraphConv, LayerInput,
                                               SAGEConv, TableInput)


def dropout(h: torch.Tensor, rate: float,
            generator: torch.Generator) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale kept
    values by 1 / (1 - rate). Draws from ``generator`` only."""
    if rate == 0.0:
        return h
    if rate == 1.0:
        return torch.zeros_like(h)
    keep_prob = 1.0 - rate
    keep = torch.rand(h.shape, generator=generator, device=h.device) \
        < keep_prob
    return torch.where(keep, h / keep_prob, torch.zeros_like(h))


class _Stack(nn.Module):
    """Layers named ``layer_{i}`` as in flax, so state_dict keys read
    ``layer_0.fc_self.weight`` etc. Weights are made on the CPU from
    ``seed`` (the same weights on every device); move the model with
    ``.to(device)``."""

    def __init__(self, convs: Sequence[nn.Module], dropout: float):
        super().__init__()
        self.num_layers = len(convs)
        self.dropout = dropout
        for i, conv in enumerate(convs):
            self.add_module(f"layer_{i}", conv)

    def _post(self, i: int, h: torch.Tensor, train: bool,
              generator: Optional[torch.Generator]) -> torch.Tensor:
        """ReLU + dropout between layers."""
        if i == self.num_layers - 1:
            return h
        h = torch.relu(h)
        return dropout(h, self.dropout, generator) if train else h

    def forward(self, blocks: Sequence[DeviceBlock], x: LayerInput,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if train and self.dropout > 0 and generator is None:
            raise ValueError("training with dropout needs a generator")
        h = x if isinstance(x, TableInput) else x.float()
        for i, block in enumerate(blocks):
            h = self._post(i, getattr(self, f"layer_{i}")(block, h), train,
                           generator)
        return h.float()


def _convs(make_conv, in_dim: int, hidden: int, num_classes: int,
           num_layers: int, seed: int, widen: int = 1) -> list:
    """``make_conv(d_in, d_out, generator)`` per layer, drawn in layer
    order from one generator seeded with ``seed``; a layer's input is the
    previous output times ``widen`` (GAT's flattened heads)."""
    gen = torch.Generator().manual_seed(seed)
    outs = [num_classes if i == num_layers - 1 else hidden
            for i in range(num_layers)]
    ins = [in_dim] + [o * widen for o in outs[:-1]]
    return [make_conv(d, o, gen) for d, o in zip(ins, outs)]


class SAGE(_Stack):
    """GraphSAGE (mean)."""

    def __init__(self, in_dim: int, hidden: int, num_classes: int,
                 num_layers: int = 2, dropout: float = 0.5, seed: int = 0):
        super().__init__(_convs(SAGEConv, in_dim, hidden, num_classes,
                                num_layers, seed), dropout)


class GCN(_Stack):
    """GCN (GraphConv, right-normalised)."""

    def __init__(self, in_dim: int, hidden: int, num_classes: int,
                 num_layers: int = 2, dropout: float = 0.5, seed: int = 0):
        super().__init__(_convs(GraphConv, in_dim, hidden, num_classes,
                                num_layers, seed), dropout)


class GAT(_Stack):
    """Multi-head GAT: ``hidden`` features per head; heads flattened
    between layers and meaned at the output."""

    def __init__(self, in_dim: int, hidden: int, num_classes: int,
                 num_layers: int = 2, num_heads: int = 4,
                 dropout: float = 0.5, seed: int = 0):
        super().__init__(_convs(
            lambda d, o, gen: GATConv(d, o, num_heads, gen), in_dim, hidden,
            num_classes, num_layers, seed, widen=num_heads), dropout)

    def _post(self, i, h, train, generator):
        if i == self.num_layers - 1:
            return h.mean(dim=1)                       # [n, H, F] -> [n, F]
        return super()._post(i, h.reshape(h.shape[0], -1), train, generator)


def make_model(model_type: str, in_dim: int, hidden: int, num_classes: int,
               num_layers: int, num_heads: int = 4, dropout: float = 0.5,
               seed: int = 0) -> nn.Module:
    """Model switch, the JAX package's make_model (sage | gcn | gat); flax
    infers ``in_dim`` at init, torch needs it here. f32 only so far."""
    if model_type in ("sage", "distsage"):
        return SAGE(in_dim, hidden, num_classes, num_layers=num_layers,
                    dropout=dropout, seed=seed)
    if model_type == "gcn":
        return GCN(in_dim, hidden, num_classes, num_layers=num_layers,
                   dropout=dropout, seed=seed)
    if model_type == "gat":
        return GAT(in_dim, hidden, num_classes, num_layers=num_layers,
                   num_heads=num_heads, dropout=dropout, seed=seed)
    raise ValueError(f"unknown model_type {model_type!r}")
