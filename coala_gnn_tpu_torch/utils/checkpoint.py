"""Checkpoint save / restore (port of coala_gnn_tpu/utils/checkpoint.py).

A checkpoint is the directory ``<path>/step_<n>`` (the JAX package's
naming) holding one ``torch.save`` file, ``state.pt``: the model's
``state_dict``, the optimizer's ``state_dict`` and the step. Restoring
loads it with ``weights_only=True`` onto the model's device, so the state
lands on the card the run uses. Orbax checkpoints of the JAX package are
not read: the port carries no JAX.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

FILE = "state.pt"


def save(path: str, model: torch.nn.Module,
         optimizer: torch.optim.Optimizer, step: int) -> str:
    """Write the model's and optimizer's state and ``step`` to
    ``<path>/step_<step>`` (replacing one that exists); returns that
    directory. The file is written under a temporary name and renamed."""
    out = os.path.join(os.path.abspath(path), f"step_{step}")
    os.makedirs(out, exist_ok=True)
    tmp = os.path.join(out, f"{FILE}.{os.getpid()}.tmp")
    torch.save({"model": model.state_dict(),
                "optimizer": optimizer.state_dict(), "step": int(step)}, tmp)
    os.replace(tmp, os.path.join(out, FILE))
    return out


def latest_step(path: str) -> Optional[int]:
    """The largest n of the ``step_<n>`` directories under ``path``, or
    None."""
    if not os.path.isdir(path):
        return None
    steps = [int(d.split("_", 1)[1]) for d in os.listdir(path)
             if d.startswith("step_") and d.split("_", 1)[1].isdigit()]
    return max(steps) if steps else None


def restore(path: str, model: torch.nn.Module,
            optimizer: torch.optim.Optimizer,
            step: Optional[int] = None) -> Optional[int]:
    """Load checkpoint ``step`` (default: the latest) into ``model`` and
    ``optimizer`` in place; returns its step, or None if there is none.
    Tensors are mapped onto the device of the model's first parameter."""
    step = step if step is not None else latest_step(path)
    if step is None:
        return None
    device = next(model.parameters()).device
    state = torch.load(os.path.join(os.path.abspath(path), f"step_{step}",
                                    FILE),
                       map_location=device, weights_only=True)
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    # an optimizer that is neither capturable nor fused keeps its step
    # counts on the host, as a fresh one creates them (no sync per step)
    for group in optimizer.param_groups:
        if group.get("capturable") or group.get("fused"):
            continue
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if torch.is_tensor(st.get("step")):
                st["step"] = st["step"].cpu()
    return int(state["step"])
