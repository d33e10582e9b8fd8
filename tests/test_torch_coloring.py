"""coala_gnn_tpu_torch/coloring/ against coala_gnn_tpu/coloring/, mirroring
the seven tests of tests/test_coloring.py: the port's native coloring (its
own copy of the JAX package's C++ functions, built into
``coala_gnn_tpu_torch/_build/``) bit for bit against JAX's native at the
same seed, the oracles against the native library, the affinity, the
metadata files read across packages, and the port's ``generate_colors``
against ``examples/generate_colors.py``."""

import importlib.util
import os

import numpy as np
import pytest

from coala_gnn_tpu.coloring import coloring as jc
from coala_gnn_tpu_torch.coloring import coloring as tc
from coala_gnn_tpu_torch.graph.csc import CSCGraph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def graphs(small_dataset):
    """(JAX dataset, the port's CSCGraph of the same arrays)."""
    g = small_dataset.graph
    return small_dataset, CSCGraph(g.indptr, g.indices)


@pytest.mark.parametrize("seed,max_hop,base_rate", [(0, 10, 0.02),
                                                    (1, 3, 0.02),
                                                    (5, 10, 0.005)])
def test_native_coloring_bitwise_jax(graphs, seed, max_hop, base_rate):
    """The port's color_graph(seed=s) is JAX's native coloring: the same
    mt19937_64 seed draw, colors, hops and count; with JAX's invariants
    (hop >= 1 exactly on colored nodes, max_hop + 1 at most)."""
    ds, tg = graphs
    want = jc.color_graph(ds.graph, ds.train_idx, max_hop=max_hop,
                          base_rate=base_rate, seed=seed)
    nc, color, hop = tc.color_graph(tg, ds.train_idx, max_hop=max_hop,
                                    base_rate=base_rate, seed=seed)
    assert nc == want[0] and nc > 0
    assert color.dtype == np.int64 and hop.dtype == np.int32
    np.testing.assert_array_equal(color, want[1])
    np.testing.assert_array_equal(hop, want[2])
    assert color.max() <= nc and color.min() >= 0
    assert (hop[color > 0] >= 1).all() and (hop[color == 0] == 0).all()
    assert hop.max() <= max_hop + 1
    if max_hop == 10 and base_rate == 0.02:
        assert (color > 0).mean() > 0.5


def test_oracle_structural_agreement(graphs):
    """The NumPy oracle draws other picks (numpy's generator), so its
    colors differ from the native ones, but both satisfy the invariants;
    the oracle equals JAX's oracle exactly."""
    ds, tg = graphs
    for use_native in (True, False):
        nc, color, hop = tc.color_graph(tg, ds.train_idx, max_hop=3,
                                        base_rate=0.02, seed=1,
                                        use_native=use_native)
        assert nc > 0 and (hop[color > 0] >= 1).all() and hop.max() <= 4
    got = tc.color_graph(tg, ds.train_idx, max_hop=3, base_rate=0.02,
                         seed=1, use_native=False)
    want = jc.color_graph(ds.graph, ds.train_idx, max_hop=3, base_rate=0.02,
                          seed=1, use_native=False)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_native_exactly_matches_oracle_given_seeds(graphs):
    """color_graph_from_seeds: native and oracle agree exactly, and equal
    JAX's native."""
    ds, tg = graphs
    picks = np.random.default_rng(7).choice(ds.train_idx, size=12,
                                            replace=False).astype(np.int64)
    for max_hop in (2, 10):
        n = tc.color_graph_from_seeds(tg, ds.train_idx, picks,
                                      max_hop=max_hop, use_native=True)
        p = tc.color_graph_from_seeds(tg, ds.train_idx, picks,
                                      max_hop=max_hop, use_native=False)
        j = jc.color_graph_from_seeds(ds.graph, ds.train_idx, picks,
                                      max_hop=max_hop, use_native=True)
        assert n[0] == p[0] == j[0] == len(picks)
        for a, b in ((n, p), (n, j)):
            np.testing.assert_array_equal(a[1], b[1])
            np.testing.assert_array_equal(a[2], b[2])
        assert (n[1][picks] > 0).all()


def test_affinity_matches_jax_and_oracle(graphs):
    """color_affinity bitwise JAX's native on the same coloring; the
    port's oracle equal to its native (scores to 1e-10)."""
    ds, tg = graphs
    nc, color, hop = tc.color_graph(tg, ds.train_idx, max_hop=10,
                                    base_rate=0.02, seed=0)
    tk, sc = tc.color_affinity(tg, color, hop, nc, topk=5)
    jtk, jsc = jc.color_affinity(ds.graph, color, hop, nc, topk=5)
    np.testing.assert_array_equal(tk, jtk)
    assert sc.tobytes() == np.asarray(jsc).tobytes()
    ptk, psc = tc.color_affinity(tg, color, hop, nc, topk=5,
                                 use_native=False)
    np.testing.assert_array_equal(tk, ptk)
    np.testing.assert_allclose(sc, psc, rtol=1e-10, atol=1e-12)


def test_affinity_scores_normalized_and_sorted(graphs):
    ds, tg = graphs
    meta = tc.generate_color_metadata(tg, ds.train_idx, base_rate=0.02,
                                      topk=10, seed=0)
    assert meta.topk.shape == (meta.num_colors, 10) and meta.topk_k == 10
    assert (meta.score >= 0).all() and (meta.score <= 1.0 + 1e-9).all()
    for c in range(meta.num_colors):
        s = meta.score[c][meta.topk[c] != 0]
        assert (np.diff(s) <= 1e-12).all()
        assert (meta.topk[c] != c + 1).all()


def test_metadata_round_trip_across_packages(tmp_path, graphs):
    """Each package reads what the other wrote (and its own), the
    reference's flat 1-D score.npy too."""
    ds, tg = graphs
    tmeta = tc.generate_color_metadata(tg, ds.train_idx, base_rate=0.02)
    jmeta = jc.generate_color_metadata(ds.graph, ds.train_idx,
                                       base_rate=0.02)
    for name, meta, save, load in (
            ("t2j", tmeta, tc.save_color_metadata, jc.load_color_metadata),
            ("j2t", jmeta, jc.save_color_metadata, tc.load_color_metadata),
            ("t2t", tmeta, tc.save_color_metadata, tc.load_color_metadata)):
        path = str(tmp_path / name)
        save(meta, path)
        back = load(path)
        for field in ("color", "topk", "score", "hop"):
            a, b = getattr(meta, field), getattr(back, field)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert back.num_colors == meta.num_colors
    np.save(tmp_path / "t2t" / "score.npy", tmeta.score.reshape(-1))
    assert tc.load_color_metadata(str(tmp_path / "t2t")).score.shape == \
        tmeta.score.shape


def test_generate_colors_cli_writes_jax_arrays(tmp_path, capsys):
    """python -m coala_gnn_tpu_torch.generate_colors writes the four arrays
    examples/generate_colors.py writes at the same flags, byte for byte;
    --data other than synthetic raises naming its ROADMAP.md item."""
    from coala_gnn_tpu_torch import generate_colors

    flags = ["--num_nodes", "3000", "--feature_dim", "8", "--seed", "2"]
    generate_colors.main(flags + ["--out", str(tmp_path / "port")])
    spec = importlib.util.spec_from_file_location(
        "jax_generate_colors", os.path.join(ROOT, "examples",
                                            "generate_colors.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    script.main(flags + ["--out", str(tmp_path / "jax")])
    out = capsys.readouterr().out.splitlines()
    assert out[0].split(" in ")[0] == out[2].split(" in ")[0]
    for name in ("color", "topk", "score", "hop"):
        a = np.load(tmp_path / "port" / f"{name}.npy")
        b = np.load(tmp_path / "jax" / f"{name}.npy")
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    with pytest.raises(NotImplementedError, match="Not ported"):
        generate_colors.main(["--data", "ogbn-arxiv", "--out",
                              str(tmp_path)])
