"""flax parameter trees <-> torch state_dicts.

flax ``Dense`` keeps a kernel [d_in, d_out] and a bias [d_out]; torch
``nn.Linear`` a weight [d_out, d_in] and a bias. The port names its
modules as flax does (``layer_0/fc_self`` -> ``layer_0.fc_self``), so the
map is the path joined with dots, ``kernel`` -> ``weight`` transposed,
``bias`` unchanged, and GAT's attention params ``attn_l`` / ``attn_r``
([heads, features], the same layout in both) unchanged. Works on nested
dicts of numpy arrays and imports no flax: a tree from the JAX package
goes through ``jax.device_get`` (or ``np.asarray`` per leaf) first.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping

import numpy as np
import torch

#: leaves that keep their name and layout in both frameworks
_AS_IS = ("bias", "attn_l", "attn_r")


def params_from_flax(tree: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """``{"params": {"layer_0": {"fc_self": {"kernel", "bias"}, ...}}}``
    (the outer "params" level is optional) -> torch state_dict."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def walk(node: Mapping, path: tuple) -> None:
        for name in sorted(node):
            leaf = node[name]
            if isinstance(leaf, Mapping):
                walk(leaf, path + (name,))
            elif name == "kernel":
                arr = np.asarray(leaf, np.float32)
                out[".".join(path + ("weight",))] = \
                    torch.from_numpy(np.ascontiguousarray(arr.T))
            elif name in _AS_IS:
                out[".".join(path + (name,))] = \
                    torch.from_numpy(np.array(leaf, np.float32))
            else:
                raise ValueError(f"unexpected flax leaf "
                                 f"{'/'.join(path + (name,))}")

    walk(tree, ())
    return out


def params_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """Inverse of ``params_from_flax``: -> ``{"params": {...}}`` of numpy
    f32 arrays."""
    tree: Dict = {}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        arr = value.detach().cpu().float().numpy()
        if leaf == "weight":
            leaf, arr = "kernel", np.ascontiguousarray(arr.T)
        elif leaf not in _AS_IS:
            raise ValueError(f"unexpected state_dict entry {key}")
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = arr
    return {"params": tree}
