"""The port's dataset loaders, CSC artifacts and COO -> CSC converter held
bit for bit against the JAX package's on the same files: IGB's
homogeneous layout (and its ``csc=True`` preprocessed layout) and
IGB-hetero's, both written by ``examples/make_igb_fixture.py``, and the
OGB-MAG layout of tests/test_hetero_data.py. ``save_csc`` / ``load_csc``
read what the other package wrote; ``load_csc(mmap=True)`` and
``load_preprocessed`` keep ``indices`` and the features memory maps; the
port's ``python -m coala_gnn_tpu_torch.create_csc_graph`` writes the files
of ``examples/create_csc_graph.py``; ``load_dataset("ogbn-*")`` raises
naming its ROADMAP.md title. Exact equality throughout: the copies run the
same numpy calls in the same order."""

import os
import sys

import numpy as np
import pytest

from coala_gnn_tpu.graph import csc as jcsc
from coala_gnn_tpu.graph import datasets as jds
from coala_gnn_tpu_torch import create_csc_graph
from coala_gnn_tpu_torch.graph import csc, datasets

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))

import create_csc_graph as jax_create_csc_graph  # noqa: E402
from make_igb_fixture import (write_igb_fixture,  # noqa: E402
                              write_igb_hetero_fixture)

FIELDS = ("features", "labels", "train_idx", "val_idx", "test_idx")


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _same_graph(ours, ref):
    for name in ("indptr", "indices", "edge_ids", "edge_types"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if a is not None:
            _equal(a, b)
    assert ours.num_edge_types == ref.num_edge_types
    assert (ours.num_nodes, ours.num_edges) == (ref.num_nodes, ref.num_edges)


def _same_dataset(ours, ref):
    _same_graph(ours.graph, ref.graph)
    for name in FIELDS:
        _equal(getattr(ours, name), getattr(ref, name))
    assert (ours.num_classes, ours.name, ours.feature_dim) == \
        (ref.num_classes, ref.name, ref.feature_dim)


def _is_map(a) -> bool:
    """``a`` is a memory map or a view of one (no copy in RAM)."""
    while a is not None:
        if isinstance(a, np.memmap):
            return True
        a = a.base
    return False


@pytest.fixture(scope="module")
def igb_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("igb"))
    write_igb_fixture(root, num_nodes=1500, dim=24, avg_degree=8, seed=3,
                      csc=True)
    return root


@pytest.fixture(scope="module")
def hetero_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("igbh"))
    write_igb_hetero_fixture(root, num_paper=800, dim=16, avg_degree=6,
                             seed=1)
    return root


@pytest.fixture(scope="module")
def mag_root(tmp_path_factory):
    """tests/test_hetero_data.py's OGB-MAG layout ([2, E] edges, paper
    features and labels only, some labels negative)."""
    root = str(tmp_path_factory.mktemp("mag"))
    rng = np.random.default_rng(3)
    base = os.path.join(root, "processed")
    n_paper, n_author, n_inst = 300, 150, 20
    for d, (ns, nd) in {
        "paper___cites___paper": (n_paper, n_paper),
        "author___writes___paper": (n_author, n_paper),
        "author___affiliated_with___institution": (n_author, n_inst),
    }.items():
        os.makedirs(os.path.join(base, d), exist_ok=True)
        e = np.stack([rng.integers(0, ns, 100), rng.integers(0, nd, 100)])
        e[0, 0], e[1, 0] = ns - 1, nd - 1
        np.save(os.path.join(base, d, "edge_index.npy"), e.astype(np.int64))
    os.makedirs(os.path.join(base, "paper"), exist_ok=True)
    np.save(os.path.join(base, "paper", "node_feat.npy"),
            rng.normal(size=(n_paper, 16)).astype(np.float32))
    np.save(os.path.join(base, "paper", "node_label.npy"),
            rng.integers(-1, 10, n_paper).astype(np.int64))
    return root


@pytest.mark.parametrize("mmap", [True, False])
@pytest.mark.parametrize("name", ["igb", "igb-tiny"])
def test_load_igb_npy_bitwise_jax(igb_root, name, mmap):
    kw = dict(path=igb_root, dataset_size="tiny", num_classes=19,
              mmap=mmap)
    ours, ref = datasets.load_dataset(name, **kw), jds.load_dataset(name,
                                                                    **kw)
    _same_dataset(ours, ref)
    assert _is_map(ours.features) == mmap
    assert ours.features.flags["C_CONTIGUOUS"]


@pytest.mark.parametrize("add_reverse", [True, False])
@pytest.mark.parametrize("mmap", [True, False])
def test_load_igb_hetero_bitwise_jax(hetero_root, add_reverse, mmap):
    kw = dict(dataset_size="tiny", num_classes=19, mmap=mmap,
              add_reverse=add_reverse)
    ours = datasets.load_igb_hetero(hetero_root, **kw)
    _same_dataset(ours, jds.load_igb_hetero(hetero_root, **kw))
    assert ours.graph.num_edge_types == (8 if add_reverse else 4)
    _same_dataset(datasets.load_dataset("igbh", path=hetero_root, **kw),
                  jds.load_dataset("igbh", path=hetero_root, **kw))


@pytest.mark.parametrize("add_reverse", [True, False])
def test_load_ogb_mag_hetero_bitwise_jax(mag_root, add_reverse):
    ours = datasets.load_ogb_mag_hetero(mag_root, num_classes=10,
                                        add_reverse=add_reverse)
    _same_dataset(ours, jds.load_ogb_mag_hetero(mag_root, num_classes=10,
                                                add_reverse=add_reverse))
    assert ours.labels.min() == -1 and ours.labels[:300].min() >= 0
    kw = dict(path=mag_root, dataset_size="ignored", num_classes=10)
    _same_dataset(datasets.load_dataset("mag", **kw),
                  jds.load_dataset("mag", **kw))


@pytest.mark.parametrize("mmap", [True, False])
def test_load_preprocessed_bitwise_jax(igb_root, mmap):
    pre = os.path.join(igb_root, "preprocessed")
    ours = datasets.load_preprocessed(pre, num_classes=19, mmap=mmap)
    _same_dataset(ours, jds.load_preprocessed(pre, num_classes=19,
                                              mmap=mmap))
    _same_dataset(datasets.load_dataset("preprocessed", path=pre,
                                        num_classes=19),
                  jds.load_dataset("preprocessed", path=pre,
                                   num_classes=19))
    # the fixture's train_idx.npy replaces the range split
    _equal(ours.train_idx, np.load(os.path.join(pre, "train_idx.npy")))
    for a in (ours.graph.indptr, ours.graph.indices, ours.graph.edge_ids,
              ours.features):
        assert _is_map(a) == mmap


def test_range_splits_and_synthetic_dispatch_equal_jax():
    for n in (0, 1, 7, 1000, 12345):
        for ours, ref in zip(datasets.range_splits(n), jds.range_splits(n)):
            _equal(ours, ref)
    for ours, ref in zip(datasets.range_splits(100, (0.5, 0.3)),
                         jds.range_splits(100, (0.5, 0.3))):
        _equal(ours, ref)
    kw = dict(num_nodes=300, avg_degree=4, feature_dim=8, num_classes=4)
    _same_dataset(datasets.load_dataset("synthetic", **kw),
                  jds.load_dataset("synthetic", **kw))
    with pytest.raises(ValueError, match="unknown dataset"):
        datasets.load_dataset("cora")


def test_ogbn_raises_naming_the_roadmap_title():
    with pytest.raises(NotImplementedError,
                       match="Not ported: code the system does not need on "
                             "a GPU"):
        datasets.load_dataset("ogbn-arxiv", path="", dataset_size="tiny",
                              num_classes=40)


@pytest.mark.parametrize("typed", [False, True])
def test_save_csc_load_csc_across_packages(tmp_path, typed):
    rng = np.random.default_rng(0)
    n, e = 60, 500
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    ets = rng.integers(0, 4, e) if typed else None
    ours = csc.coo_to_csc(src, dst, n, edge_types=ets)
    ref = jcsc.coo_to_csc(src, dst, n, edge_types=ets)
    _same_graph(ours, ref)
    csc.save_csc(ours, str(tmp_path / "port"))
    jcsc.save_csc(ref, str(tmp_path / "jax"))
    for name in sorted(os.listdir(tmp_path / "jax")):
        with open(tmp_path / "port" / name, "rb") as a, \
                open(tmp_path / "jax" / name, "rb") as b:
            assert a.read() == b.read(), name
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax"))
    for mmap in (True, False):
        _same_graph(csc.load_csc(str(tmp_path / "jax"), mmap=mmap),
                    jcsc.load_csc(str(tmp_path / "port"), mmap=mmap))
        g = csc.load_csc(str(tmp_path / "jax"), mmap=mmap)
        assert _is_map(g.indices) == mmap
        assert _is_map(g.edge_types) == (mmap and typed)


def test_in_neighbors_and_reverse_equal_jax():
    rng = np.random.default_rng(4)
    n, e = 40, 300
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    ours, ref = csc.coo_to_csc(src, dst, n), jcsc.coo_to_csc(src, dst, n)
    for v in (0, 7, n - 1):
        _equal(ours.in_neighbors(v), ref.in_neighbors(v))
    _same_graph(ours.reverse(), ref.reverse())
    # the reverse of the reverse has the same in-neighbour sets
    back = ours.reverse().reverse()
    for v in range(n):
        _equal(np.sort(back.in_neighbors(v)), np.sort(ours.in_neighbors(v)))


def test_csc_graph_keeps_a_memory_map(tmp_path):
    """The constructor copies neither a memory-mapped ``indices`` nor an
    int64 ``indptr``: a 10M-node graph's topology stays on its file."""
    idx = np.lib.format.open_memmap(str(tmp_path / "i.npy"), mode="w+",
                                    dtype=np.int64, shape=(5,))
    idx[:] = [1, 0, 2, 2, 0]
    ptr = np.load(_saved(tmp_path, "p.npy", np.array([0, 2, 5, 5])),
                  mmap_mode="r")
    g = csc.CSCGraph(indptr=ptr, indices=idx)
    assert g.indices is idx and g.indptr is ptr
    g2 = csc.CSCGraph(indptr=[0, 1], indices=[3])
    assert g2.indptr.dtype == np.int64 and g2.indices.shape == (1,)


def _saved(tmp_path, name, arr):
    path = str(tmp_path / name)
    np.save(path, arr)
    return path


@pytest.mark.parametrize("flags", [
    [],
    ["--symmetrize"],
    ["--num_nodes", "2000"],
    ["two_files"],
    ["two_files", "--symmetrize"],
    ["edge_types", "--symmetrize"],
])
def test_create_csc_graph_writes_jax_files(igb_root, tmp_path, flags,
                                           capsys):
    """The port's converter against examples/create_csc_graph.py on the
    fixture's [E, 2] edges (and a [2, E] file): the same files, byte for
    byte, and the same printed lines but for the times."""
    ei = os.path.join(igb_root, "tiny", "processed", "paper__cites__paper",
                      "edge_index.npy")
    edges = np.load(ei)
    argv = ["--edge_index", ei]
    if "two_files" in flags:
        argv.append(_saved(tmp_path, "t.npy", edges[:400].T.copy()))
        flags = [f for f in flags if f != "two_files"]
    if "edge_types" in flags:
        argv += ["--edge_types", _saved(
            tmp_path, "et.npy",
            np.random.default_rng(0).integers(0, 3, len(edges)))]
        flags = [f for f in flags if f != "edge_types"]
    argv += flags
    create_csc_graph.main(argv + ["--out", str(tmp_path / "port")])
    ours = capsys.readouterr().out
    jax_create_csc_graph.main(argv + ["--out", str(tmp_path / "jax")])
    theirs = capsys.readouterr().out
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    for name in names:
        with open(tmp_path / "port" / name, "rb") as a, \
                open(tmp_path / "jax" / name, "rb") as b:
            assert a.read() == b.read(), name

    def strip(out, out_dir):
        return [line.split(" in ")[0].replace(out_dir, "OUT")
                for line in out.splitlines()
                if not line.startswith("CSC build")]
    assert strip(ours, str(tmp_path / "port")) == \
        strip(theirs, str(tmp_path / "jax"))


def test_create_csc_graph_refuses_what_jax_refuses(igb_root, tmp_path):
    ei = os.path.join(igb_root, "tiny", "processed", "paper__cites__paper",
                      "edge_index.npy")
    et = _saved(tmp_path, "et.npy", np.zeros(3, np.int32))
    for argv in (["--edge_index", ei, ei, "--edge_types", et],
                 ["--edge_index", ei, "--edge_types", et]):
        with pytest.raises(SystemExit):
            create_csc_graph.main(argv + ["--out", str(tmp_path / "x")])
