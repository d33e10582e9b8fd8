"""The port's host sampler (``sampling/neighbor.py``) and its native layer
draw (``csrc/host_native.cpp:cg_sample_layer``) against the JAX package's,
bit for bit on the same seeds: dedup and contiguous layouts, native and
numpy draws, consecutive batches of one sampler (the seed stream).
Mirrors tests/test_sampler.py and the layout invariants of
tests/test_contig_host_pipeline.py on the port; the port raises where the
JAX sampler falls back to numpy."""

import numpy as np
import pytest

from coala_gnn_tpu.graph.datasets import synthetic_graph as jax_synthetic
from coala_gnn_tpu.native import lib as jax_native
from coala_gnn_tpu.sampling.neighbor import NeighborSampler as JaxSampler
from coala_gnn_tpu.sampling.neighbor import \
    max_sample_size as jax_max_sample_size
from coala_gnn_tpu_torch.graph.csc import CSCGraph
from coala_gnn_tpu_torch.graph.datasets import synthetic_graph
from coala_gnn_tpu_torch.native import lib as native
from coala_gnn_tpu_torch.sampling import neighbor
from coala_gnn_tpu_torch.sampling.neighbor import (NeighborSampler,
                                                   block_capacities,
                                                   max_sample_size)


@pytest.fixture(scope="module")
def ds():
    return synthetic_graph(num_nodes=2000, avg_degree=10, feature_dim=8,
                           num_classes=8, seed=7)


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _batches_equal(ours, ref):
    _equal(ours.seeds, ref.seeds)
    _equal(ours.input_ids, ref.input_ids)
    assert ours.num_input == ref.num_input
    assert len(ours.blocks) == len(ref.blocks)
    for a, b in zip(ours.blocks, ref.blocks):
        _equal(a.src_ids, b.src_ids)
        _equal(a.mask, b.mask)
        assert (a.adj is None) == (b.adj is None)
        if a.adj is not None:
            _equal(a.adj, b.adj)
        assert (a.num_dst, a.num_src) == (b.num_dst, b.num_src)


@pytest.mark.parametrize("batch,fanouts", [(1024, [10, 5]), (4, [10, 5]),
                                           (16, [5, 3, 2]), (7, [1])])
def test_max_sample_size_equals_jax(batch, fanouts):
    assert max_sample_size(batch, fanouts) == \
        jax_max_sample_size(batch, fanouts)
    assert block_capacities(batch, fanouts)[0][1] == \
        max_sample_size(batch, fanouts)


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("contiguous", [False, True])
@pytest.mark.parametrize("B,fanouts,seed", [(16, [5, 3], 1), (32, [4, 4], 42),
                                            (8, [12, 6, 2], 3)])
def test_sampler_is_bitwise_jax(ds, use_native, contiguous, B, fanouts, seed):
    """Four consecutive batches of one sampler: every block, id list and
    count equal; fanouts below and above the in-degrees (draws and
    take-all rows)."""
    jds = jax_synthetic(num_nodes=2000, avg_degree=10, feature_dim=8,
                        num_classes=8, seed=7)
    ours = NeighborSampler(ds.graph, fanouts, B, seed=seed,
                           use_native=use_native, contiguous=contiguous)
    ref = JaxSampler(jds.graph, fanouts, B, seed=seed, use_native=use_native,
                     contiguous=contiguous)
    assert (ours._native is not None) == (ref._native is not None) \
        == use_native
    assert ours.caps == ref.caps
    for i in range(4):
        seeds = ds.train_idx[i * B:(i + 1) * B]
        _batches_equal(ours.sample(seeds), ref.sample(seeds))


@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("fanout,seed", [(3, 0), (10, 12345), (25, 2**62)])
def test_native_sample_layer_is_bitwise_jax(ds, idx_dtype, fanout, seed):
    g = CSCGraph(indptr=ds.graph.indptr,
                 indices=ds.graph.indices.astype(idx_dtype))
    dst = np.random.default_rng(fanout).integers(0, g.num_nodes, 700)
    got = native.sample_layer(native.get(), g, dst, fanout, seed)
    want = jax_native.sample_layer(jax_native.get(), g, dst, fanout, seed)
    for a, b in zip(got, want):
        _equal(a, b)
    with pytest.raises(TypeError):
        native.sample_layer(native.get(), CSCGraph(
            indptr=g.indptr, indices=g.indices.astype(np.int16)), dst, 3, 0)


@pytest.mark.parametrize("use_native", [False, True])
def test_sampled_block_invariants(ds, use_native):
    B, fanouts = 32, [5, 3]
    batch = NeighborSampler(ds.graph, fanouts, B, seed=1,
                            use_native=use_native).sample(ds.train_idx[:B])
    out_block, in_block = batch.blocks[-1], batch.blocks[0]
    np.testing.assert_array_equal(out_block.src_ids[:B], ds.train_idx[:B])
    assert out_block.num_dst == B
    np.testing.assert_array_equal(in_block.src_ids[:out_block.num_src],
                                  out_block.src_ids[:out_block.num_src])
    assert in_block.num_dst == out_block.num_src
    indptr, indices = ds.graph.indptr, ds.graph.indices
    for blk in batch.blocks:
        assert np.unique(blk.src_ids[:blk.num_src]).size == blk.num_src
        for i in range(blk.num_dst):
            dst = blk.src_ids[i]
            nbrs = set(indices[indptr[dst]:indptr[dst + 1]].tolist())
            got = [blk.src_ids[blk.adj[i, k]] for k in range(blk.fanout)
                   if blk.mask[i, k] > 0]
            assert set(got) <= nbrs
            # valid slots = min(degree with multiplicity, fanout)
            assert len(got) == min(indptr[dst + 1] - indptr[dst],
                                   blk.fanout)
        assert blk.adj.max() < max(blk.num_src, 1)


def test_take_all_below_fanout(ds):
    """deg <= fanout returns each in-neighbour exactly once."""
    B = 16
    blk = NeighborSampler(ds.graph, [100], B, seed=0,
                          use_native=False).sample(ds.train_idx[:B]).blocks[0]
    indptr, indices = ds.graph.indptr, ds.graph.indices
    for i in range(B):
        dst = ds.train_idx[i]
        got = [int(blk.src_ids[blk.adj[i, k]]) for k in range(blk.fanout)
               if blk.mask[i, k] > 0]
        assert sorted(got) == sorted(
            indices[indptr[dst]:indptr[dst + 1]].tolist())


def test_contig_layout_invariants(ds):
    B, fanouts = 16, [8, 8]
    sent = ds.graph.num_nodes
    s = NeighborSampler(ds.graph, fanouts, B, seed=0, contiguous=True)
    batch = s.sample(ds.train_idx[:B])
    for l, blk in enumerate(batch.blocks):
        cap_dst, cap_src = s.caps[l]
        assert blk.adj is None and blk.src_ids.shape == (cap_src,)
        assert blk.mask.shape == (cap_dst, fanouts[l])
        if l + 1 < len(batch.blocks):
            np.testing.assert_array_equal(blk.src_ids[:cap_dst],
                                          batch.blocks[l + 1].src_ids)
        slots = blk.src_ids[cap_dst:].reshape(fanouts[l], cap_dst).T
        np.testing.assert_array_equal(blk.mask > 0, slots != sent)
    assert batch.num_input == int((batch.input_ids != sent).sum())


def test_sampler_refuses_what_is_not_ported(ds, monkeypatch):
    """A wrong batch size raises; the contiguous layout of a typed
    (hetero) graph raises NotImplementedError, as JAX's does (the default
    layout samples it: tests/test_torch_hetero.py); use_native=True raises
    where the native library does not build (the JAX sampler falls back to
    numpy there)."""
    with pytest.raises(ValueError):
        NeighborSampler(ds.graph, [3], 8, use_native=False).sample(
            ds.train_idx[:5])

    class Typed:
        edge_types = np.zeros(3, np.int32)

    with pytest.raises(NotImplementedError, match="hetero"):
        NeighborSampler(Typed(), [3], 8, contiguous=True)

    def broken():
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(neighbor.native_lib, "get", broken)
    with pytest.raises(RuntimeError):
        NeighborSampler(ds.graph, [3], 8, use_native=True)
    assert NeighborSampler(ds.graph, [3], 8, use_native=False)._native is None


def test_draws_are_uniform_in_both_engines():
    """deg > fanout: native draws without replacement, numpy with; both
    pick each neighbour with share 1/deg."""
    deg, fanout, trials = 20, 5, 3000
    indptr = np.zeros(deg + 2, np.int64)
    indptr[1:] = deg
    g = CSCGraph(indptr=indptr, indices=np.arange(1, deg + 1, dtype=np.int64))
    for use_native in (True, False):
        s = NeighborSampler(g, [fanout], batch_size=1, seed=7,
                            use_native=use_native)
        counts = np.zeros(deg + 1, np.int64)
        for _ in range(trials):
            nbr, mask, _ = s._sample_layer(np.array([0], np.int64), fanout)
            assert mask.sum() == fanout
            ids, c = np.unique(nbr[0], return_counts=True)
            counts[ids] += c
        freq = counts[1:] / (trials * fanout)
        assert np.abs(freq - 1.0 / deg).max() < 0.012, (use_native, freq)
