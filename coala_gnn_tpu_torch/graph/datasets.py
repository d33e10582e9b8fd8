"""Dataset container, the synthetic graph and the loaders of the
reference's on-disk layouts (port of ``coala_gnn_tpu/graph/datasets.py``,
numpy-identical for the same seed and the same files):

- ``load_igb_npy``: IGB's raw .npy directory (``<path>/<size>/processed/``
  ``paper/node_feat.npy``, ``node_label_19.npy`` or ``node_label_2K.npy``,
  ``paper__cites__paper/edge_index.npy`` [E, 2]);
- ``load_igb_hetero`` / ``load_ogb_mag_hetero``: the typed layouts of
  IGB-hetero and OGB-MAG, flattened into one id space with a relation id
  per edge (``_flatten_hetero``), each relation with a reversed twin by
  default;
- ``load_preprocessed``: the ``csc_*.npy`` artifacts with
  ``features.npy`` / ``labels.npy`` (and optional split files), as
  ``python -m coala_gnn_tpu_torch.create_csc_graph`` and
  ``coala_gnn_tpu_torch.reference_scale`` write them;
- ``load_dataset``: dispatch by name.

With ``mmap`` (the default) the features stay a read-only memory map of
their file, C-contiguous float32 as ``cache/host_tier.py``'s native
gather needs, and ``load_preprocessed`` keeps the topology memory-mapped
too. The hetero loaders build their flattened feature table in RAM, as
the JAX package does. The OGB node-property datasets (``ogbn-*``) need the
``ogb`` package and a download and are not ported (ROADMAP.md)."""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import numpy as np

from coala_gnn_tpu_torch.graph.csc import CSCGraph, coo_to_csc, load_csc

#: the ROADMAP.md title that ``load_dataset("ogbn-*")`` quotes
_NOT_PORTED = ("ROADMAP.md queue A, \"Not ported: code the system does not "
               "need on a GPU\"")


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


def range_splits(num_nodes: int,
                 fractions: Tuple[float, float] = (0.6, 0.2)
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Contiguous index-range splits: [0, 0.6 N) train, [0.6 N, 0.8 N)
    val, the rest test (the reference's IGB splits)."""
    n_train = int(num_nodes * fractions[0])
    n_val = int(num_nodes * fractions[1])
    ids = np.arange(num_nodes, dtype=np.int64)
    return ids[:n_train], ids[n_train:n_train + n_val], ids[n_train + n_val:]


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


def clustered_graph(num_nodes: int = 30_000,
                    num_communities: int = 64,
                    avg_degree: int = 10,
                    p_intra: float = 0.95,
                    feature_dim: int = 64,
                    num_classes: int = 16,
                    seed: int = 0) -> Dataset:
    """Strongly community-structured graph (stochastic block model
    flavour), the locality that node_color distribution exploits: an edge
    stays inside its source's community with probability ``p_intra``, so
    BFS colors track communities and each part's cache can specialise.
    Labels are ``community % num_classes``; splits 60/20/20."""
    rng = np.random.default_rng(seed)
    community = rng.integers(0, num_communities,
                             size=num_nodes).astype(np.int32)
    members = [np.flatnonzero(community == c) for c in range(num_communities)]
    num_edges = num_nodes * avg_degree
    src = rng.integers(0, num_nodes, size=num_edges).astype(np.int64)
    dst = np.empty(num_edges, dtype=np.int64)
    intra = rng.random(num_edges) < p_intra
    dst[~intra] = rng.integers(0, num_nodes, size=int((~intra).sum()))
    for c in range(num_communities):
        m = intra & (community[src] == c)
        pool = members[c]
        if pool.size and m.any():
            dst[m] = rng.choice(pool, size=int(m.sum()))
    graph = coo_to_csc(src, dst, num_nodes)

    labels = (community % num_classes).astype(np.int32)
    class_emb = rng.normal(0, 1, size=(num_classes, feature_dim)).astype(
        np.float32)
    features = class_emb[labels] + rng.normal(
        0, 1.0, size=(num_nodes, feature_dim)).astype(np.float32)
    perm = rng.permutation(num_nodes).astype(np.int64)
    n_tr, n_va = int(0.6 * num_nodes), int(0.2 * num_nodes)
    return Dataset(graph=graph, features=features, labels=labels,
                   train_idx=perm[:n_tr], val_idx=perm[n_tr:n_tr + n_va],
                   test_idx=perm[n_tr + n_va:], num_classes=num_classes,
                   name=f"clustered-{num_nodes}x{num_communities}")


def _label_file(num_classes: int) -> str:
    return "node_label_19.npy" if num_classes == 19 else "node_label_2K.npy"


def load_igb_npy(path: str, dataset_size: str = "tiny",
                 num_classes: int = 19, mmap: bool = True) -> Dataset:
    """IGB's homogeneous raw .npy layout under ``<path>/<dataset_size>/
    processed/``; labels (stored float32) become int32, the splits are
    ``range_splits`` over the papers."""
    base = os.path.join(path, dataset_size, "processed")
    mode = "r" if mmap else None
    feat = np.load(os.path.join(base, "paper", "node_feat.npy"),
                   mmap_mode=mode)
    labels = np.load(os.path.join(base, "paper", _label_file(num_classes))
                     ).astype(np.int32).reshape(-1)
    edge_index = np.load(os.path.join(base, "paper__cites__paper",
                                      "edge_index.npy"), mmap_mode=mode)
    num_nodes = feat.shape[0]
    graph = coo_to_csc(np.asarray(edge_index[:, 0]),
                       np.asarray(edge_index[:, 1]), num_nodes)
    train_idx, val_idx, test_idx = range_splits(num_nodes)
    return Dataset(graph=graph, features=feat, labels=labels,
                   train_idx=train_idx, val_idx=val_idx, test_idx=test_idx,
                   num_classes=num_classes, name=f"igb-{dataset_size}")


def _flatten_hetero(edges, node_counts, predict_type: str,
                    feats_by_type, labels_predict: np.ndarray,
                    num_classes: int, add_reverse: bool,
                    name: str) -> Dataset:
    """A typed-node graph in one node-id space, one relation id per edge.

    ``edges``: (src_type, rel_name, dst_type, src_ids, dst_ids) per
    relation, the relation id being its position; with ``add_reverse``
    relation r also gets a reversed twin, id ``len(edges) + r``, so the
    other types' features reach the predict type through in-edges.
    ``node_counts``: {type: count}; the predict type sits at offset 0, so
    its ids, labels and splits carry over. ``feats_by_type``: {type:
    [count, dim]} for the types that have features (all of one dim); the
    others get zero rows. Other nodes' labels are -1."""
    types = [predict_type] + [t for t in node_counts if t != predict_type]
    offsets = {}
    off = 0
    for t in types:
        offsets[t] = off
        off += int(node_counts[t])
    total_nodes = off

    dims = {int(f.shape[1]) for f in feats_by_type.values()}
    if len(dims) != 1:
        raise ValueError(f"hetero node-feature dims differ: {sorted(dims)}; "
                         "the flattened feature table needs one dim")
    dim = dims.pop()

    srcs, dsts, rels = [], [], []
    for rel_id, (st, _rn, dt, s, d) in enumerate(edges):
        s = np.asarray(s, np.int64) + offsets[st]
        d = np.asarray(d, np.int64) + offsets[dt]
        srcs.append(s)
        dsts.append(d)
        rels.append(np.full(len(s), rel_id, np.int32))
        if add_reverse:
            srcs.append(d)
            dsts.append(s)
            rels.append(np.full(len(s), len(edges) + rel_id, np.int32))
    graph = coo_to_csc(np.concatenate(srcs), np.concatenate(dsts),
                       total_nodes, edge_types=np.concatenate(rels))
    graph.num_edge_types = len(edges) * (2 if add_reverse else 1)

    features = np.zeros((total_nodes, dim), np.float32)
    for t, f in feats_by_type.items():
        features[offsets[t]:offsets[t] + int(node_counts[t])] = f

    labels = np.full(total_nodes, -1, np.int32)
    n_pred = int(node_counts[predict_type])
    labels[:n_pred] = np.asarray(labels_predict, np.int32).reshape(-1)[:n_pred]
    train_idx, val_idx, test_idx = range_splits(n_pred)
    return Dataset(graph=graph, features=features, labels=labels,
                   train_idx=train_idx, val_idx=val_idx, test_idx=test_idx,
                   num_classes=num_classes, name=name)


def load_igb_hetero(path: str, dataset_size: str = "tiny",
                    num_classes: int = 19, mmap: bool = True,
                    add_reverse: bool = True) -> Dataset:
    """IGB-hetero's raw layout under ``<path>/<dataset_size>/processed/``,
    flattened: node types paper, author, institute and fos (each
    ``<type>/node_feat.npy``, one dim), the edge directories
    ``paper__cites__paper``, ``paper__written_by__author``,
    ``author__affiliated_to__institute`` and ``paper__topic__fos`` (each
    ``edge_index.npy`` [E, 2]), paper labels; 8 relations with the
    reverses. Splits: ``range_splits`` over the papers."""
    base = os.path.join(path, dataset_size, "processed")
    mode = "r" if mmap else None

    def _edges(d):
        e = np.load(os.path.join(base, d, "edge_index.npy"), mmap_mode=mode)
        return np.asarray(e[:, 0]), np.asarray(e[:, 1])

    feats = {t: np.load(os.path.join(base, t, "node_feat.npy"),
                        mmap_mode=mode)
             for t in ("paper", "author", "institute", "fos")}
    labels = np.load(os.path.join(base, "paper", _label_file(num_classes)))
    edges = [("paper", "cites", "paper", *_edges("paper__cites__paper")),
             ("paper", "written_by", "author",
              *_edges("paper__written_by__author")),
             ("author", "affiliated_to", "institute",
              *_edges("author__affiliated_to__institute")),
             ("paper", "topic", "fos", *_edges("paper__topic__fos"))]
    counts = {t: int(f.shape[0]) for t, f in feats.items()}
    return _flatten_hetero(edges, counts, "paper", feats, labels,
                           num_classes, add_reverse,
                           name=f"igb-hetero-{dataset_size}"
                                + ("+rev" if add_reverse else ""))


def load_ogb_mag_hetero(path: str, num_classes: int = 349,
                        mmap: bool = True,
                        add_reverse: bool = True) -> Dataset:
    """OGB-MAG's layout under ``<path>/processed/``, flattened: the edge
    directories ``paper___cites___paper``, ``author___writes___paper`` and
    ``author___affiliated_with___institution`` (``edge_index.npy`` [2, E],
    transposed against IGB's), paper features and labels (negative labels
    clamp to 0); authors and institutions get zero features."""
    base = os.path.join(path, "processed")
    mode = "r" if mmap else None

    def _edges(d):
        e = np.load(os.path.join(base, d, "edge_index.npy"), mmap_mode=mode)
        return np.asarray(e[0, :]), np.asarray(e[1, :])

    pp = _edges("paper___cites___paper")
    ap = _edges("author___writes___paper")
    ai = _edges("author___affiliated_with___institution")
    feat = np.load(os.path.join(base, "paper", "node_feat.npy"),
                   mmap_mode=mode)
    labels = np.asarray(
        np.load(os.path.join(base, "paper", "node_label.npy"),
                mmap_mode=mode)).reshape(-1).astype(np.int32)
    labels[labels < 0] = 0

    n_paper = int(feat.shape[0])
    n_author = int(max(ap[0].max(), ai[0].max())) + 1
    n_inst = int(ai[1].max()) + 1
    edges = [("paper", "cites", "paper", *pp),
             ("author", "writes", "paper", *ap),
             ("author", "affiliated_to", "institute", *ai)]
    counts = {"paper": n_paper, "author": n_author, "institute": n_inst}
    return _flatten_hetero(edges, counts, "paper", {"paper": feat}, labels,
                           num_classes, add_reverse,
                           name="ogb-mag-hetero"
                                + ("+rev" if add_reverse else ""))


def load_preprocessed(path: str, num_classes: int, mmap: bool = True,
                      name: str = "preprocessed") -> Dataset:
    """A directory of ``csc_*.npy`` + ``features.npy`` + ``labels.npy``;
    ``train_idx.npy`` / ``val_idx.npy`` / ``test_idx.npy`` where present
    replace the ``range_splits`` of the graph's nodes. With ``mmap`` the
    topology and the features stay memory maps."""
    graph = load_csc(path, mmap=mmap)
    mode = "r" if mmap else None
    feat = np.load(os.path.join(path, "features.npy"), mmap_mode=mode)
    labels = np.load(os.path.join(path, "labels.npy")).astype(np.int32)
    splits = list(range_splits(graph.num_nodes))
    for i, split in enumerate(("train_idx", "val_idx", "test_idx")):
        p = os.path.join(path, f"{split}.npy")
        if os.path.exists(p):
            splits[i] = np.load(p).astype(np.int64)
    return Dataset(graph=graph, features=feat, labels=labels,
                   train_idx=splits[0], val_idx=splits[1],
                   test_idx=splits[2], num_classes=num_classes, name=name)


def load_dataset(name: str, **kwargs) -> Dataset:
    """Dispatch by name, as the JAX package's ``load_dataset``:
    ``synthetic*``, ``igb-hetero`` / ``igbh``, ``ogb-mag-hetero`` /
    ``mag`` (``dataset_size`` dropped), ``igb*`` and ``preprocessed``
    (``path`` and ``num_classes``). ``ogbn-*`` raises
    ``NotImplementedError``: it needs the ``ogb`` package and a download."""
    if name.startswith("synthetic"):
        return synthetic_graph(**kwargs)
    if name.startswith("ogbn"):
        raise NotImplementedError(
            f"{name} loads through the ogb package and a download, which the "
            f"port does not do: {_NOT_PORTED}")
    if name in ("igb-hetero", "igbh"):
        return load_igb_hetero(**kwargs)
    if name in ("ogb-mag-hetero", "mag"):
        kwargs.pop("dataset_size", None)
        return load_ogb_mag_hetero(**kwargs)
    if name.startswith("igb"):
        return load_igb_npy(**kwargs)
    if name == "preprocessed":
        return load_preprocessed(kwargs["path"],
                                 num_classes=kwargs["num_classes"],
                                 mmap=kwargs.get("mmap", True))
    raise ValueError(f"unknown dataset {name!r}")
