"""Checkpoint save / restore (port of coala_gnn_tpu/utils/checkpoint.py).

A checkpoint is the directory ``<path>/step_<n>`` (the JAX package's
naming) holding one ``torch.save`` file, ``state.pt``: the model's
``state_dict``, the optimizer's ``state_dict`` and the step. Restoring
loads it with ``weights_only=True`` onto the model's device, so the state
lands on the card the run uses. Orbax checkpoints of the JAX package are
not read: the port carries no JAX.
"""

from __future__ import annotations

import glob
import os
import shutil
from typing import Optional

import torch

FILE = "state.pt"


def save(path: str, model: torch.nn.Module,
         optimizer: torch.optim.Optimizer, step: int) -> str:
    """Write the model's and optimizer's state and ``step`` to
    ``<path>/step_<step>`` (replacing one that exists); returns that
    directory. The file is written into the sibling directory
    ``step_<step>.tmp-<pid>``, which is renamed to ``step_<step>`` once the
    file is complete, as orbax renames its temporary directory: a save cut
    short leaves no ``step_<n>`` that ``latest_step`` would pick. An
    existing ``step_<step>`` is first renamed to ``step_<step>.old-<pid>``
    and removed after; a run killed between the two renames leaves no
    ``step_<step>``, so a resume takes the step before it. Each save first
    removes the ``.tmp-*`` and ``.old-*`` siblings of its step that runs
    cut short left behind."""
    root = os.path.abspath(path)
    out = os.path.join(root, f"step_{step}")
    for stale in (glob.glob(glob.escape(out) + ".tmp-*") +
                  glob.glob(glob.escape(out) + ".old-*")):
        shutil.rmtree(stale, ignore_errors=True)
    tmp = f"{out}.tmp-{os.getpid()}"
    os.makedirs(tmp)
    torch.save({"model": model.state_dict(),
                "optimizer": optimizer.state_dict(), "step": int(step)},
               os.path.join(tmp, FILE))
    old = f"{out}.old-{os.getpid()}"
    if os.path.exists(out):
        os.replace(out, old)
    os.replace(tmp, out)
    shutil.rmtree(old, ignore_errors=True)
    return out


def latest_step(path: str) -> Optional[int]:
    """The largest n of the complete checkpoints under ``path`` (the
    directories ``step_<n>``, n all digits, that hold ``state.pt``), or
    None."""
    if not os.path.isdir(path):
        return None
    steps = [int(d.split("_", 1)[1]) for d in os.listdir(path)
             if d.startswith("step_") and d.split("_", 1)[1].isdigit()
             and os.path.isfile(os.path.join(path, d, FILE))]
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
