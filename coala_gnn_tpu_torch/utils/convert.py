"""flax parameter trees <-> torch state_dicts.

flax ``Dense`` keeps a kernel [d_in, d_out] and a bias [d_out]; torch
``nn.Linear`` a weight [d_out, d_in] and a bias. The port names its
modules as flax does (``layer_0/fc_self`` -> ``layer_0.fc_self``), so the
map is the path joined with dots, ``kernel`` -> ``weight`` transposed,
``bias`` unchanged, and the attention params ``attn_l`` / ``attn_r`` of
GAT and ``attn_l_r{r}`` / ``attn_r_r{r}`` of the relational RGAT
([heads, features], the same layout in both) unchanged. Works on nested
dicts of numpy arrays and imports no flax: a tree from the JAX package
goes through ``jax.device_get`` (or ``np.asarray`` per leaf) first.

Each leaf keeps its dtype: f32 stays f32, and a bf16 leaf (a bf16 model's
``attn_l`` / ``attn_r``; its Dense params stay f32, flax's ``param_dtype``)
becomes a ``torch.bfloat16`` tensor. numpy has no bf16 of its own (JAX
hands out ``ml_dtypes.bfloat16`` arrays, which the port does not import),
so a bf16 leaf is recognised by its dtype's name and crosses through f32,
which holds every bf16 value exactly.

``adam_state_from_optax`` carries an optax Adam / AdamW state across:
``mu`` -> ``exp_avg``, ``nu`` -> ``exp_avg_sq`` (mapped as the params
are), ``count`` -> ``step``, into a ``torch.optim.Adam`` / ``AdamW`` over
the converted model, so both frameworks can take their next step from one
state.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, Mapping, Optional

import numpy as np
import torch

#: leaves that keep their name and layout in both frameworks: biases and
#: the attention params, relation-indexed (``attn_l_r0``) or not
_AS_IS = re.compile(r"bias|attn_[lr](_r\d+)?")


def _is_bf16(arr: np.ndarray) -> bool:
    return np.asarray(arr).dtype.name == "bfloat16"


def _leaf(arr, transpose: bool) -> torch.Tensor:
    """A flax leaf -> torch tensor of the same dtype (f32 or bf16)."""
    f32 = np.array(arr, np.float32)            # a copy torch may write
    t = torch.from_numpy(np.ascontiguousarray(f32.T if transpose else f32))
    return t.to(torch.bfloat16) if _is_bf16(arr) else t


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
                out[".".join(path + ("weight",))] = _leaf(leaf, True)
            elif _AS_IS.fullmatch(name):
                out[".".join(path + (name,))] = _leaf(leaf, False)
            else:
                raise ValueError(f"unexpected flax leaf "
                                 f"{'/'.join(path + (name,))}")

    walk(tree, ())
    return out


def params_to_flax(state_dict: Mapping[str, torch.Tensor],
                   bf16_as: Optional[np.dtype] = None) -> Dict:
    """Inverse of ``params_from_flax``: -> ``{"params": {...}}`` of numpy
    arrays, f32 leaves as f32. A bf16 leaf needs ``bf16_as``: a 2-byte
    numpy bfloat16 type (``ml_dtypes.bfloat16``, the caller's), which gets
    the tensor's bits unchanged, or ``np.float32``, which widens it
    exactly; without it a bf16 leaf raises ``ValueError``."""
    tree: Dict = {}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        t = value.detach().cpu()
        if t.dtype == torch.bfloat16:
            if bf16_as is None:
                raise ValueError(f"{key} is bfloat16: pass bf16_as (a numpy "
                                 "bfloat16 type, or np.float32 to widen)")
            if np.dtype(bf16_as) == np.float32:
                arr = t.float().numpy()
            else:
                arr = t.view(torch.int16).numpy().view(bf16_as)
        else:
            arr = t.float().numpy()
        if leaf == "weight":
            leaf, arr = "kernel", np.ascontiguousarray(arr.T)
        elif not _AS_IS.fullmatch(leaf):
            raise ValueError(f"unexpected state_dict entry {key}")
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = arr
    return {"params": tree}


def _adam_part(opt_state):
    """The part of an optax state (a tuple of transform states, possibly
    nested) that has ``count``, ``mu`` and ``nu``."""
    if all(hasattr(opt_state, a) for a in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for part in opt_state:
            found = _adam_part(part)
            if found is not None:
                return found
    return None


def adam_state_from_optax(opt_state, model: torch.nn.Module,
                          optimizer: torch.optim.Optimizer) -> None:
    """Load an optax ``adam`` / ``adamw`` state (``jax.device_get`` of it,
    or numpy leaves) into ``optimizer``, a ``torch.optim.Adam`` or
    ``AdamW`` over ``model`` whose params came from the same flax tree
    (``params_from_flax``). Each param gets ``step`` = ``count`` (f32 on
    the host, as torch keeps it), ``exp_avg`` = ``mu`` and ``exp_avg_sq``
    = ``nu``, on the param's device and in its dtype."""
    adam = _adam_part(opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the optax state")
    if any(g.get("amsgrad") for g in optimizer.param_groups):
        raise ValueError("amsgrad keeps a state optax's adam does not have")
    mu, nu = params_from_flax(adam.mu), params_from_flax(adam.nu)
    step = float(np.asarray(adam.count))
    names = dict(model.named_parameters())
    if set(names) != set(mu):
        raise ValueError(f"params {sorted(names)} != optax state "
                         f"{sorted(mu)}")
    for name, p in names.items():
        optimizer.state[p] = {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": mu[name].to(p.device, p.dtype),
            "exp_avg_sq": nu[name].to(p.device, p.dtype)}
