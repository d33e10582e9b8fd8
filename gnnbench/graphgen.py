"""The benchmark's graph, features, labels, split and seed order, made from
one seed on the device.

Derived from ``coala_gnn_tpu_torch/reference_scale.py`` ``generate`` at
commit ecc7861 (contiguous communities, a ``p_intra`` share of edges kept
inside a community, features a class embedding plus unit noise, labels the
community modulo the classes) and frozen here, so that a change to the
program cannot move the data a cell trains on. What differs from it:

- it runs in torch on the device, in a few large calls, from a
  ``torch.Generator`` seeded with the run's seed;
- node popularity is heavy-tailed: the nodes hold the weights
  ``w = (1 - q) ** (-1 / alpha)`` at the Pareto quantiles ``q = (i + 1/2)
  / N`` (tail index ``alpha``) in an order drawn from the seed, so every
  seed has the same set of weights, hubs included; an edge's destination is drawn in proportion to ``w`` over all nodes, and
  its source in proportion to ``w`` inside the destination's community
  (share ``p_intra``) or over all nodes. In- and out-degrees then both
  have the tail ``P(deg >= k) ~ k ** -alpha``;
- the split is the reference's contiguous 60/20/20 ranges
  (``graph/datasets.range_splits``), and the seeds are trained in an
  order drawn from the seed.

A configuration that states ``graph.structure_seed`` draws the topology
from it, so every run trains on the same graph and the run's seed changes
the features, the weights, the seed order and the sampling: the work of a
window then depends on the seed only through the order in which it
visits the graph.

The CSC arrays, features and labels come back as host numpy arrays, since
the host tier serves the features from host memory; the device copies are
freed before the program is built.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

#: generator streams of one seed
GRAPH, FEATURES, SPLIT, WEIGHTS, DIGEST = range(5)


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` for one stream of the run's
    seed (any whole number; reduced to 63 bits, then spread by
    ``numpy.random.SeedSequence``)."""
    ss = np.random.SeedSequence(int(seed) % (1 << 63), spawn_key=(stream,))
    g = torch.Generator(device=device)
    g.manual_seed(int(ss.generate_state(1, np.uint64)[0] >> 1))
    return g


def _pick(cum: torch.Tensor, target: torch.Tensor, lo: torch.Tensor,
          hi: torch.Tensor) -> torch.Tensor:
    """The node whose weight interval [cum0[i], cum0[i + 1]) holds
    ``target``, clamped into [lo, hi)."""
    i = torch.searchsorted(cum, target, right=True)
    return torch.minimum(torch.maximum(i, lo), hi - 1)


def make_graph(cfg: dict, seed: int, device) -> Dict[str, np.ndarray]:
    """indptr int64 [N + 1] and indices int32 [E] of the CSC (in-edges
    of each destination, sources in ascending order), from the
    configuration's ``num_nodes``, ``num_edges`` and ``graph`` group,
    drawn from its ``structure_seed`` where it states one (every run then
    trains on the same graph), else from the run's seed."""
    g = cfg["graph"]
    n, e = int(cfg["num_nodes"]), int(cfg["num_edges"])
    size, p_intra = int(g["community_size"]), float(g["p_intra"])
    alpha = float(g["degree_tail_index"])
    gen = generator(int(g.get("structure_seed", seed)), GRAPH, device)
    # the same weights for every seed, at the Pareto quantiles
    # (i + 1/2) / n, in an order drawn from the seed
    q = (torch.arange(n, device=device, dtype=torch.float64) + 0.5) / n
    w = (1.0 - q).pow(-1.0 / alpha)[torch.randperm(n, generator=gen,
                                                   device=device)]
    cum = torch.cumsum(w, 0)
    del q, w
    cum0 = torch.cat([torch.zeros(1, dtype=torch.float64, device=device),
                      cum])
    total = cum0[-1]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    dst = _pick(cum, torch.rand(e, generator=gen, device=device,
                                dtype=torch.float64) * total,
                zero, torch.full((), n, device=device))
    first = (dst // size) * size
    last = torch.clamp(first + size, max=n)
    intra = torch.rand(e, generator=gen, device=device) < p_intra
    u = torch.rand(e, generator=gen, device=device, dtype=torch.float64)
    lo = torch.where(intra, cum0[first], torch.zeros_like(u))
    hi = torch.where(intra, cum0[last], total.expand_as(u))
    src = _pick(cum, lo + u * (hi - lo), torch.where(intra, first, zero),
                torch.where(intra, last, torch.full_like(last, n)))
    del cum, cum0, lo, hi, u, intra, first, last
    key = torch.sort(dst * n + src).values
    del dst, src
    counts = torch.bincount(key // n, minlength=n)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(counts, 0, out=indptr[1:])
    indices = (key % n).to(torch.int32)
    return {"indptr": indptr.cpu().numpy(), "indices": indices.cpu().numpy()}


def make_features(cfg: dict, seed: int, device,
                  chunk_rows: int = 1 << 17) -> Dict[str, np.ndarray]:
    """features f32 [N, dim] (class embedding plus unit noise), labels
    int32 [N] (community modulo the classes), drawn on the device in
    chunks of ``chunk_rows`` and copied into one host array."""
    n, size = int(cfg["num_nodes"]), int(cfg["graph"]["community_size"])
    dim, num_classes = int(cfg["feature_dim"]), int(cfg["num_classes"])
    gen = generator(seed, FEATURES, device)
    emb = torch.randn(num_classes, dim, generator=gen, device=device)
    labels = ((torch.arange(n, device=device) // size) % num_classes).to(
        torch.int32)
    feats = np.empty((n, dim), np.float32)
    host = torch.from_numpy(feats)
    for lo in range(0, n, chunk_rows):
        hi = min(lo + chunk_rows, n)
        rows = emb[labels[lo:hi].long()] + torch.randn(
            hi - lo, dim, generator=gen, device=device)
        host[lo:hi].copy_(rows)
    return {"features": feats, "labels": labels.cpu().numpy()}


def make_split(cfg: dict, seed: int, device) -> Dict[str, np.ndarray]:
    """train / val / test ids (the contiguous ``train_fraction`` /
    ``val_fraction`` / rest ranges) and ``order``, the training ids in the
    order the run trains them (int32)."""
    g, n = cfg["graph"], int(cfg["num_nodes"])
    n_train = int(n * float(g["train_fraction"]))
    n_val = int(n * float(g["val_fraction"]))
    ids = np.arange(n, dtype=np.int64)
    gen = generator(seed, SPLIT, device)
    order = torch.randperm(n_train, generator=gen, device=device)
    return {"train_idx": ids[:n_train], "val_idx": ids[n_train:n_train + n_val],
            "test_idx": ids[n_train + n_val:],
            "order": order.to(torch.int32).cpu().numpy()}


def make_dataset(cfg: dict, seed: int, device) -> Dict[str, np.ndarray]:
    """Everything a cell trains on, as host arrays (see the module
    docstring)."""
    out = make_graph(cfg, seed, device)
    out.update(make_features(cfg, seed, device))
    out.update(make_split(cfg, seed, device))
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out
