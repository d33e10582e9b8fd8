"""The reference's first window and the comparison that decides ``correct``.

``follow`` works out again, from the benchmark's data, seed and weights
alone, what the program's first window of K steps (the traffic's
``window``, keys (0, k) for k < K: the window the timed path runs, at its
size) should have produced: each step's sampled frontier, masks and, on a
typed graph, relations (``reference/sampler.py``), a digest of the
layer-0 rows (each valid row's dot with the digest vector, in f64;
padding rows zero), the edges, the valid slots, the losses, the first
gradient and the parameters' change over the first ``CHANGE_STEPS`` steps
(``reference/model.py`` with the configuration's model module). It reads
the features from the host array with numpy, one step at a time. Where
the data types its nodes (``node_type_offsets``, ``relation_dst_type``),
the model's layers get each destination's type and each relation's
destination type in their ``Block``: nothing of the program's is read for
them, since they follow from the frontier ids, which ``blocks`` compares.

``compare`` sets the program's record beside the reference's and gives
each number with its limit (``gnnbench/limits/<cell>.json``):

- ``blocks``: sampled frontier ids, mask entries and relation entries
  (a typed graph's) that differ, over the window's K steps (limit 0);
- ``rows``: valid layer-0 rows whose digest differs (limit 0);
- ``edges``: the gap of the steps' valid edges (limit 0);
- ``counters``: hits + misses against the valid slots, plus the misses
  where the cache holds every node (limit 0);
- ``loss_first``: the relative gap of the first step's loss;
- ``grad_median``: the first gradient (Adam's first moment after one
  step over 1 - beta1) by the median leaf: each leaf's gap of norms over
  the larger of its reference norm and the median leaf's;
- ``update``: the parameters' change over the first ``CHANGE_STEPS``
  steps by the worst leaf, the same gap, leaving out leaves whose
  reference first gradient is under a thousandth of the median leaf's
  (they move by round-off alone).
"""

from __future__ import annotations

import statistics
from typing import Dict, Optional

import numpy as np
import torch

from gnnbench.reference import model as M
from gnnbench.reference import sampler as S

#: the parameters' change is compared after this many steps
CHANGE_STEPS = 3
EXACT = ("blocks", "rows", "edges", "counters")


def first_keys(traffic: dict) -> list:
    """The (window, step in window) stream keys of the first window."""
    return [(0, k) for k in range(int(traffic["window"]))]


def rows_of(features: np.ndarray, ids: torch.Tensor, num_nodes: int,
            device) -> torch.Tensor:
    """features[ids] as f32 [len(ids), dim] on ``device``, padding ids
    (num_nodes) zero rows; gathered on the host by numpy."""
    ids_np = ids.cpu().numpy()
    real = ids_np < num_nodes
    rows = features[np.where(real, ids_np, 0)]
    rows[~real] = 0
    return torch.from_numpy(rows).to(device)


def follow(cell, data: dict, seed: int, vec: torch.Tensor, device,
           precision: str = "float32", half_batch: bool = False) -> dict:
    """The reference's record of ``cell``'s first window (see the module
    docstring). ``precision="tf32"``: the matmuls in TF32 (the control);
    ``half_batch``: the loss over the first half of the seeds (a fault)."""
    cfg, traffic, model = cell.cfg, cell.traffic, cell.model
    B, fanouts = int(traffic["batch"]), list(traffic["fanout"])
    N = int(cfg["num_nodes"])
    order = data["order"]
    indptr = torch.from_numpy(data["indptr"]).to(device)
    indices = torch.from_numpy(data["indices"]).to(device)
    edge_types = data.get("edge_types")
    if edge_types is not None:
        edge_types = torch.from_numpy(edge_types).to(device)
    offsets, rel_dst = node_types(data, N, device)
    labels = torch.from_numpy(data["labels"]).long().to(device)
    p = M.init_params(model, cfg, seed, device)
    p0 = {k: v.clone() for k, v in p.items()}
    opt = M.Adam(p, float(cfg["learning_rate"]))
    out = {"ids": [], "masks": [], "rels": [], "digest": [], "edges": [],
           "valid": [], "loss": []}
    keys = first_keys(traffic)
    change_at = min(CHANGE_STEPS, len(keys))
    for step, (w, k) in enumerate(keys):
        seeds = torch.from_numpy(
            order[np.arange(step * B, (step + 1) * B) % order.size]).to(device)
        ids, masks, rels, ntypes = S.sample(
            indptr, indices, N, seeds, fanouts, B,
            S.stream(seed, w, k, S.SAMPLE, device), edge_types, offsets)
        x0 = rows_of(data["features"], ids, N, device)
        out["ids"].append(ids.cpu())
        out["masks"].append([m.cpu() for m in masks])
        out["rels"].append([_cpu(r) for r in rels])
        out["digest"].append((x0.double() @ vec).cpu())
        out["edges"].append(int(sum(m.sum() for m in masks)))
        out["valid"].append(int((ids < N).sum()))
        leaves = {n: v.detach().requires_grad_(True) for n, v in p.items()}
        with M.precision_mode(precision):
            logits = M.forward(model, cfg, leaves, x0,
                               [M.Block(m, r, t, rel_dst) for m, r, t
                                in zip(masks, rels, ntypes)],
                               S.stream(seed, w, k, S.DROPOUT, device), B,
                               precision)
            loss = M.loss_fn(logits, labels[seeds.long()],
                             rows=B // 2 if half_batch else None)
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
        out["loss"].append(float(loss.detach()))
        if step == 0:
            out["grad"] = {n: float(g.double().norm())
                           for n, g in grads.items()}
        del x0, logits, leaves
        opt.step(p, {n: g.detach() for n, g in grads.items()})
        if step + 1 == change_at:
            out["update"] = {n: float((p[n] - p0[n]).double().norm())
                             for n in p}
    return out


def node_types(data: dict, num_nodes: int, device) -> tuple:
    """(``node_type_offsets`` int64 [T + 1], ``relation_dst_type`` int32
    [R]) of the data on ``device``; (None, None) where the data has
    neither. ValueError unless the data gives both, the offsets rising
    from 0 to ``num_nodes`` and one destination type below T for each of
    the ``num_edge_types`` relations."""
    offsets, rel_dst = (data.get(k) for k in ("node_type_offsets",
                                              "relation_dst_type"))
    if offsets is None and rel_dst is None:
        return None, None
    o = np.asarray([] if offsets is None else offsets, np.int64)
    r = np.asarray([] if rel_dst is None else rel_dst, np.int32)
    if not (o.ndim == 1 and o.size >= 2 and o[0] == 0
            and o[-1] == num_nodes and (np.diff(o) >= 0).all()
            and r.shape == (int(data.get("num_edge_types", -1)),)
            and r.min() >= 0 and r.max() < o.size - 1):
        raise ValueError(
            f"node_type_offsets {o.tolist()} must rise from 0 to num_nodes "
            f"{num_nodes}, and relation_dst_type {r.tolist()} give a type "
            f"below {max(o.size - 1, 0)} for each of the num_edge_types "
            "relations; a graph module gives both keys or neither")
    return torch.from_numpy(o).to(device), torch.from_numpy(r).to(device)


def _cpu(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.cpu()


def rel_gaps(prog: list, ref: list) -> int:
    """Relation entries of one step's layers that differ (each layer's
    int32 [cap_dst, fanout], or None on an untyped graph; every entry of a
    layer that has relations on one side only, or another shape)."""
    n = 0
    for pr, rr in zip(prog, ref):
        if pr is None and rr is None:
            continue
        if pr is None or rr is None or pr.shape != rr.shape:
            n += max(t.numel() for t in (pr, rr) if t is not None)
            continue
        n += int((pr.long() != rr.long()).sum())
    return n


def as_program(rec: dict) -> dict:
    """A reference record in the program's place: its counters those of a
    cache that served every valid slot."""
    return {**rec, "hits": sum(rec["valid"]), "misses": 0}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Optional[set] = None) -> Dict[str, float]:
    """Each leaf's gap of norms over the larger of the reference leaf's
    norm and the median leaf's (the leaves in ``keep``, or all)."""
    names = [n for n in ref if keep is None or n in keep]
    if not names:
        return {}
    med = statistics.median(ref[n] for n in names)
    return {n: abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], med, 1e-30)
            for n in names}


def moved(ref: dict) -> set:
    """The leaves whose reference first gradient is at least a thousandth
    of the median leaf's."""
    med = statistics.median(ref["grad"].values())
    return {n for n, v in ref["grad"].items() if v >= 1e-3 * med}


def numbers(prog: dict, ref: dict, num_nodes: int,
            full_coverage: bool) -> Dict[str, float]:
    """The numbers of a program record against a reference record (both
    of ``follow``'s form; the program's with ``hits`` and ``misses``):
    the compared ones of the module docstring, and ``loss`` (the largest
    of the window's loss gaps) and ``grad`` (the first gradient by the
    worst leaf), which are reported but not compared (PERF.md, section
    2). ``compare`` judges the exact ones and those the cell's limits
    name."""
    steps = len(ref["ids"])
    blocks = rows = 0
    if len(prog["ids"]) != steps or len(prog["digest"]) != steps:
        blocks = rows = -1            # a step was not seen: never equal
    else:
        for s in range(steps):
            pi, ri = prog["ids"][s], ref["ids"][s]
            if pi.shape != ri.shape:
                blocks += max(pi.numel(), ri.numel())
                continue
            blocks += int((pi != ri).sum())
            for pm, rm in zip(prog["masks"][s], ref["masks"][s]):
                blocks += int((pm.float() != rm.float()).sum())
            blocks += rel_gaps(prog["rels"][s], ref["rels"][s])
            valid = ri < num_nodes
            dp, dr = prog["digest"][s][valid], ref["digest"][s][valid]
            rows += int(((dp - dr).abs() > 1e-6 * (1 + dr.abs())).sum())
    if blocks < 0:
        blocks = rows = float("inf")
    edges = sum(abs(a - b) for a, b in zip(prog["edges"], ref["edges"])) \
        + abs(len(prog["edges"]) - len(ref["edges"]))
    counters = abs(prog["hits"] + prog["misses"] - sum(ref["valid"]))
    if full_coverage:
        counters += prog["misses"]
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                   ref["loss"])]
    if len(prog["loss"]) != len(ref["loss"]):
        losses = [float("inf")]
    keep = moved(ref)
    grad = leaf_gaps(prog["grad"], ref["grad"])
    update = leaf_gaps(prog["update"], ref["update"], keep)
    return {"blocks": float(blocks), "rows": float(rows),
            "edges": float(edges), "counters": float(counters),
            "loss": max(losses), "loss_first": losses[0],
            "grad": max(grad.values()),
            "grad_median": statistics.median(grad.values()),
            "update": max(update.values(), default=0.0)}


def compare(nums: Dict[str, float], limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): the exact numbers (limit 0) and
    every number that ``limits`` names, each within its limit."""
    rows, ok = [], True
    for name in (*EXACT, *(n for n in limits if n not in EXACT)):
        value = nums.get(name, float("inf"))
        limit = 0.0 if name in EXACT else limits[name].get("limit")
        good = limit is not None and np.isfinite(value) and value <= limit
        ok &= bool(good)
        rows.append((name, value, limit))
    return ok, rows
