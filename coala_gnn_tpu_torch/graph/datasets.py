"""Dataset container and the synthetic graph (port of
``coala_gnn_tpu/graph/datasets.py``: ``Dataset`` and ``synthetic_graph``,
numpy-identical for the same seed). The loaders of real datasets are
queued in ROADMAP.md."""

from __future__ import annotations

import dataclasses

import numpy as np

from coala_gnn_tpu_torch.graph.csc import CSCGraph, coo_to_csc


@dataclasses.dataclass
class Dataset:
    graph: CSCGraph
    features: np.ndarray          # [num_nodes, dim] float32 (may be mmap)
    labels: np.ndarray            # [num_nodes] int32
    train_idx: np.ndarray         # int64 node ids
    val_idx: np.ndarray
    test_idx: np.ndarray
    num_classes: int
    name: str = "dataset"

    @property
    def feature_dim(self) -> int:
        return int(self.features.shape[1])


def synthetic_graph(num_nodes: int = 10_000,
                    avg_degree: int = 15,
                    feature_dim: int = 128,
                    num_classes: int = 16,
                    seed: int = 0,
                    power_law: bool = True) -> Dataset:
    """Random graph with community structure, so that a GNN beats chance:
    each node has a latent class, 80% of edges join same-class endpoints,
    features are a noisy class embedding. Source degrees are heavy-tailed
    (Pareto) with ``power_law``. Splits 60/20/20 of a random permutation."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=num_nodes).astype(np.int32)
    num_edges = num_nodes * avg_degree

    if power_law:
        w = rng.pareto(1.5, size=num_nodes) + 1.0
        p = w / w.sum()
        src = rng.choice(num_nodes, size=num_edges, p=p).astype(np.int64)
    else:
        src = rng.integers(0, num_nodes, size=num_edges).astype(np.int64)

    by_class = [np.flatnonzero(labels == c) for c in range(num_classes)]
    dst = rng.integers(0, num_nodes, size=num_edges).astype(np.int64)
    homo = rng.random(num_edges) < 0.8
    for c in range(num_classes):
        m = homo & (labels[src] == c)
        pool = by_class[c]
        if pool.size and m.any():
            dst[m] = rng.choice(pool, size=int(m.sum()))

    graph = coo_to_csc(src, dst, num_nodes)

    class_emb = rng.normal(0, 1, size=(num_classes, feature_dim)).astype(
        np.float32)
    features = class_emb[labels] + rng.normal(
        0, 1.0, size=(num_nodes, feature_dim)).astype(np.float32)

    perm = rng.permutation(num_nodes).astype(np.int64)
    n_tr, n_va = int(0.6 * num_nodes), int(0.2 * num_nodes)
    return Dataset(
        graph=graph,
        features=features,
        labels=labels,
        train_idx=perm[:n_tr],
        val_idx=perm[n_tr:n_tr + n_va],
        test_idx=perm[n_tr + n_va:],
        num_classes=num_classes,
        name=f"synthetic-{num_nodes}",
    )
