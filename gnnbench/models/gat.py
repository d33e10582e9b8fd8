"""GAT, plain (Velickovic et al., 2018).

Layer l: ``layer_{l}.fc.weight`` [heads * d_out, d_in] (no bias),
``layer_{l}.attn_l``, ``layer_{l}.attn_r`` [heads, d_out]; per head,
``e = leaky_relu(<feat_src, attn_l> + <feat_dst, attn_r>, 0.2)`` over a
destination's live slots, softmax over them, the slots' features summed
with those weights, no self edge; heads flattened between layers and
averaged at the output.
"""

from typing import Dict, List

import torch

from gnnbench import arith
from gnnbench.reference import model as M

#: fc runs on every row of a block's input
TRANSFORM_ROWS = "src"


def _heads(cfg: dict) -> int:
    """The configuration's heads, or the CLI's default of 4."""
    return int(cfg.get("num_heads", 4))


def param_shapes(cfg: dict) -> Dict[str, tuple]:
    shapes = {}
    heads = _heads(cfg)
    for layer, (d_in, d_out) in enumerate(M.dims(cfg, widen=heads)):
        p = f"layer_{layer}."
        shapes[p + "fc.weight"] = (heads * d_out, d_in)
        shapes[p + "attn_l"] = (heads, d_out)
        shapes[p + "attn_r"] = (heads, d_out)
    return shapes


def layer(p: dict, pre: str, h: torch.Tensor, block: M.Block,
          precision: str) -> torch.Tensor:
    mask = block.mask
    cap_dst, f = mask.shape
    heads, d_out = p[pre + "attn_l"].shape
    feat = M.matmul(h, p[pre + "fc.weight"].T, precision).view(
        h.shape[0], heads, d_out)
    el = (feat * p[pre + "attn_l"]).sum(-1)
    er = (feat[:cap_dst] * p[pre + "attn_r"]).sum(-1)
    e = torch.nn.functional.leaky_relu(
        M.planes(el, cap_dst, f).permute(1, 0, 2) + er[:, None, :], 0.2)
    m = mask[:, :, None]
    e = torch.where(m > 0, e, torch.full_like(e, -1e9))
    alpha = torch.softmax(e, dim=1) * m                 # [cap_dst, f, H]
    nbr = M.planes(feat, cap_dst, f)                    # [f, cap_dst, H, F]
    return (alpha.permute(1, 0, 2)[..., None] * nbr).sum(0)


def readout(p: dict, h: torch.Tensor) -> torch.Tensor:
    return h.mean(1)


def flags(cfg: dict) -> List[str]:
    return ["--num_heads", str(_heads(cfg))]


def step_flops(cfg: dict, rows) -> int:
    dims = arith.layer_dims("gat", int(cfg["feature_dim"]),
                            int(cfg["hidden_channels"]),
                            int(cfg["num_classes"]), int(cfg["num_layers"]),
                            _heads(cfg))
    return arith.step_flops("gat", dims, rows)
