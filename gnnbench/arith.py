"""The benchmark's yardstick arithmetic, frozen here so that a change to the
program cannot move it.

- ``busy_s``: the union of device event intervals, a copy of
  ``chip_profile.py`` ``busy_us`` at commit ecc7861 (seconds in, seconds
  out).
- ``forward_work``, ``grad_w_work``, ``grad_x_work``, ``transpose_work``,
  ``bound``: the bytes and operations a gather-SpMM launch needs on its
  own arguments, each distinct live input row read once and each output
  written once, and the least time the card could take for them; copies
  of ``chip_smoke.py``'s functions of the same names at commit ecc7861,
  taking tensors (not the torch module) and returning seconds.
- ``layer_dims``, ``step_flops``: the dense-transform FLOPs of a training
  step, after ``coala_gnn_tpu_torch/utils/roofline.py`` ``step_cost`` at
  commit ecc7861, corrected to count each layer over the distinct nodes
  its block holds (where ``step_cost`` counts block capacities, so
  padding and repeated slots counted as work), and to leave out the input
  gradient of layer 0, whose input (the features) takes none.

Peaks are NVIDIA's published ones for the H100 SXM at 700 W, never a
measured rate, so no share can pass 100% by a measured peak being low.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12     # H100 SXM f32 outside the tensor cores
#: published dense peak of a configuration's dtype (TF32 off for f32)
DENSE_PEAK = {"float32": F32_FLOPS_PER_S, "bfloat16": 989e12}


def busy_s(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def forward_work(rows_total: int, d: int, elem_bytes: int, scaled: bool,
                 adj: torch.Tensor, w: torch.Tensor) -> Tuple[int, int]:
    """(bytes, operations) the forward needs on these inputs: each distinct
    live row (w != 0, index in range) of the [rows_total, d] table read
    once, with its scale for int8, adj and w read, the f32 output written;
    one multiply-add per live element (and the dequantising multiply for
    int8)."""
    live = (w != 0) & (adj >= 0) & (adj < rows_total)
    rows = int(torch.unique(adj[live]).numel())
    nbytes = (rows * (d * elem_bytes + (4 if scaled else 0))
              + adj.numel() * 8 + adj.shape[0] * d * 4)
    return nbytes, int(live.sum()) * d * (3 if scaled else 2)


def grad_w_work(d: int, elem_bytes: int, adj: torch.Tensor,
                g_numel: int) -> Tuple[int, int]:
    """grad_w reads every in-range slot's row (w == 0 included) once per
    distinct row, g and adj, and writes [N, F]."""
    rows = int(torch.unique(adj).numel())
    return (rows * d * elem_bytes + g_numel * 4 + adj.numel() * 8,
            2 * adj.numel() * d)


def grad_x_work(adj: torch.Tensor, w: torch.Tensor, d: int,
                s: int) -> Tuple[int, int]:
    """grad_x over a transpose handed in: row_ptr, slot and w read, the g
    rows of live slots read once, every [S, D] row written once."""
    g_rows = int((w != 0).any(dim=1).sum())
    nbytes = (s + 1) * 4 + adj.numel() * 8 + g_rows * d * 4 + s * d * 4
    return nbytes, 2 * int((w != 0).sum()) * d


def transpose_work(adj: torch.Tensor, s: int) -> Tuple[int, int]:
    """The transpose reads adj and writes row_ptr and slot."""
    return adj.numel() * 8 + (s + 1) * 4, 0


def bound(nbytes: int, ops: int) -> float:
    """The least seconds the card could take: the larger of bytes over the
    HBM rate and operations over the f32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S)


def layer_dims(model: str, dim: int, hidden: int, num_classes: int,
               num_layers: int, heads: int = 1) -> List[Tuple[int, int]]:
    """[(d_in, d_out)] of each layer's dense transform, input-most first.
    GAT's ``hidden`` is per head and its heads flatten between layers, so
    its transforms are ``heads`` times wider than SAGE's."""
    widen = heads if model == "gat" else 1
    dims, d_in = [], dim
    for layer in range(num_layers):
        d_out = widen * (num_classes if layer == num_layers - 1 else hidden)
        dims.append((d_in, d_out))
        d_in = d_out
    return dims


def step_flops(model: str, dims: Sequence[Tuple[int, int]],
               rows: Sequence[int]) -> int:
    """Dense-transform FLOPs of one training step. ``rows[l]``: the distinct
    nodes layer l's transform runs on: SAGE's two fcs (fc_self, fc_neigh)
    on the block's dst nodes, GAT's fc on its src nodes. Each transform
    counts its forward and its weight gradient, and its input gradient
    only above layer 0."""
    fcs = 1 if model == "gat" else 2
    total = 0
    for layer, ((d_in, d_out), n) in enumerate(zip(dims, rows)):
        passes = 2 if layer == 0 else 3
        total += fcs * passes * 2 * int(n) * d_in * d_out
    return total


def distinct(ids: torch.Tensor, sentinel: int,
             n: Optional[int] = None) -> int:
    """How many distinct ids below ``sentinel`` the first ``n`` entries of
    ``ids`` hold (all of them where ``n`` is None)."""
    ids = ids if n is None else ids[:n]
    return int(torch.unique(ids[ids < sentinel]).numel())
