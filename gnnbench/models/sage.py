"""GraphSAGE (mean), plain (Hamilton et al., 2017, the mean aggregator).

Layer l: ``layer_{l}.fc_self.weight`` [d_out, d_in],
``layer_{l}.fc_self.bias`` [d_out], ``layer_{l}.fc_neigh.weight``;
``fc_self(h_dst) + fc_neigh(mean of the live slots' rows)``. The logits are
the last layer's output.
"""

from typing import Dict, List

import torch

from gnnbench import arith
from gnnbench.reference import model as M

#: both fcs run on a block's destinations
TRANSFORM_ROWS = "dst"


def param_shapes(cfg: dict) -> Dict[str, tuple]:
    shapes = {}
    for layer, (d_in, d_out) in enumerate(M.dims(cfg)):
        p = f"layer_{layer}."
        shapes[p + "fc_self.weight"] = (d_out, d_in)
        shapes[p + "fc_self.bias"] = (d_out,)
        shapes[p + "fc_neigh.weight"] = (d_out, d_in)
    return shapes


def layer(p: dict, pre: str, h: torch.Tensor, block: M.Block,
          precision: str) -> torch.Tensor:
    mask = block.mask
    cap_dst, f = mask.shape
    nbr = M.planes(h, cap_dst, f)
    s = (nbr * mask.T[:, :, None]).sum(0)
    mean = s / mask.sum(1).clamp(min=1.0)[:, None]
    return (M.matmul(h[:cap_dst], p[pre + "fc_self.weight"].T, precision)
            + p[pre + "fc_self.bias"]
            + M.matmul(mean, p[pre + "fc_neigh.weight"].T, precision))


def readout(p: dict, h: torch.Tensor) -> torch.Tensor:
    return h


def flags(cfg: dict) -> List[str]:
    return []


def step_flops(cfg: dict, rows) -> int:
    dims = arith.layer_dims("sage", int(cfg["feature_dim"]),
                            int(cfg["hidden_channels"]),
                            int(cfg["num_classes"]), int(cfg["num_layers"]))
    return arith.step_flops("sage", dims, rows)
