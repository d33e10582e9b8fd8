"""The port's one-device cache front (``parallel/sharded_cache.py``)
against the JAX package's ``ShardedFeatureCache`` on one device, built as
bench.py builds it (``jax.devices()[:1]``): features, hit and miss counts
and the whole cache state (tags, lines, cursors, line colors, color
counts, counters, int8 scales) bitwise equal after prewarms, plain,
packed and sentinel fetches with misses and fills, degree prewarms and
row inserts. Mirrors the one-device cases of tests/test_sharded_cache.py
and tests/test_fetch_variants.py."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from coala_gnn_tpu.cache import feature_cache as jfc
from coala_gnn_tpu.cache.host_tier import HostFeatureStore as JaxStore
from coala_gnn_tpu.parallel.mesh import DATA_AXIS, make_mesh
from coala_gnn_tpu.parallel.sharded_cache import \
    ShardedFeatureCache as JaxCache
from coala_gnn_tpu_torch.cache import feature_cache as fc
from coala_gnn_tpu_torch.cache.host_tier import HostFeatureStore
from coala_gnn_tpu_torch.data.packing import (pack_request,
                                              pack_request_contig)
from coala_gnn_tpu_torch.graph.datasets import synthetic_graph
from coala_gnn_tpu_torch.parallel.sharded_cache import (MODES,
                                                        ShardedFeatureCache)
from coala_gnn_tpu_torch.sampling.neighbor import NeighborSampler

torch.set_num_threads(1)

N_NODES, DIM, NUM_COLORS = 5000, 16, 6


@pytest.fixture(scope="module")
def feats():
    return np.random.default_rng(0).normal(size=(N_NODES, DIM)).astype(
        np.float32)


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _pair(mode="isolated", num_sets=8, quantize=False, num_colors=0):
    """(port cache, JAX cache) of the same geometry on one device."""
    kw = dict(num_sets=num_sets, ways=fc.WAYS, dim=DIM,
              cache_dim=fc.round_cache_dim(DIM), num_colors=num_colors,
              quantize=quantize)
    return (ShardedFeatureCache(fc.CacheConfig(**kw), ["cpu"], mode=mode),
            JaxCache(cfg=jfc.CacheConfig(**kw),
                     mesh=make_mesh(jax.devices()[:1]), mode=mode))


def _states_equal(ours: ShardedFeatureCache, ref) -> None:
    """The port keeps one scratch set (row num_sets) that no lookup reads;
    every other entry equals JAX's. int8 scales: within one ulp, since
    JAX's jitted insert computes absmax * (1/127) where the port (and
    JAX's eager function) divides (ROADMAP.md section C)."""
    s, js = ours.state, ref.state
    n = ours.cfg.num_sets
    for got, want in ((s.base.tags[:n], js.tags), (s.base.data[:n], js.data),
                      (s.base.rr, js.rr), (s.line_colors[:n], js.line_colors),
                      (s.base.color_counts, js.color_counts),
                      (s.base.hits, js.hits), (s.base.misses, js.misses)):
        _equal(got.numpy(), np.asarray(want)[0])
    assert (s.base.scales is None) == (js.scales is None)
    if js.scales is not None:
        np.testing.assert_array_max_ulp(s.base.scales[:n].numpy(),
                                        np.asarray(js.scales)[0], maxulp=1)


def _feats_equal(got: torch.Tensor, want, quantize: bool) -> None:
    """Bitwise; dequantised int8 rows within the 2 ulps that a scale one
    ulp away moves q * scale."""
    if quantize:
        np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want),
                                        maxulp=2)
    else:
        _equal(got.numpy(), np.asarray(want))


def _request(rng, n_req, n_valid, pool):
    ids = np.zeros((1, n_req), dtype=np.int32)
    ids[0, :n_valid] = rng.choice(pool, size=n_valid)     # with repeats
    return ids, np.asarray([n_valid], np.int32)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("quantize,with_colors", [(False, False),
                                                  (False, True),
                                                  (True, False)])
def test_fetches_with_fills_are_bitwise_jax(feats, mode, quantize,
                                            with_colors):
    """Every mode name on one device is the device's own cache. Requests
    of 64 ids over 1,000 nodes into 256 lines: misses, fills, evictions,
    repeats within a request; one fetch without fill."""
    ours, ref = _pair(mode, quantize=quantize,
                      num_colors=NUM_COLORS if with_colors else 0)
    store, jstore = HostFeatureStore(feats), JaxStore(feats)
    colors = (np.random.default_rng(9).integers(
        1, NUM_COLORS + 1, N_NODES).astype(np.int32) if with_colors
        else None)
    rng = np.random.default_rng(1)
    for r in range(5):
        ids, nv = _request(rng, 64, 50 + r, np.arange(1000))
        fill = r != 3
        got = ours.fetch(ids, nv, store.fetch, colors=colors, fill=fill)
        want = ref.fetch(ids, nv, jstore.fetch, colors=colors, fill=fill)
        assert got.shape == (1, 64, DIM)
        _feats_equal(got, want, quantize)
        _states_equal(ours, ref)
    assert ours.stats() == ref.stats()
    _equal(ours.color_meta(), ref.color_meta())
    _equal(ours.local_color_meta(), ref.local_color_meta())
    if with_colors:
        assert ours.color_meta().sum() > 0


def test_features_are_the_host_rows_and_refetch_hits(feats):
    ours, _ = _pair(num_sets=64)
    store = HostFeatureStore(feats)
    ids, nv = _request(np.random.default_rng(2), 32, 32, np.arange(N_NODES))
    np.testing.assert_array_equal(ours.fetch(ids, nv, store.fetch)[0],
                                  feats[ids[0]])
    s1 = ours.stats()
    assert s1["hits"] == 0 and s1["misses"] == 32
    np.testing.assert_array_equal(ours.fetch(ids, nv, store.fetch)[0],
                                  feats[ids[0]])
    assert ours.stats()["hit_ratio"] == 1.0


@pytest.mark.parametrize("contiguous", [False, True])
def test_packed_fetches_pipelined_are_bitwise_jax(feats, contiguous):
    """The request buffer of real sampled batches already on the device,
    its probe one batch ahead of the fetch_complete that resolves it (the
    host pipeline's order); the contiguous layout's sentinel ids are
    invalid wherever they sit."""
    ds = synthetic_graph(num_nodes=N_NODES, avg_degree=6, feature_dim=DIM,
                         num_classes=4, seed=3)
    ds.features = feats
    B, fanouts = 16, [4, 3]
    sent = ds.graph.num_nodes
    sampler = NeighborSampler(ds.graph, fanouts, B, seed=0,
                              contiguous=contiguous)
    n_req = sampler.caps[0][1]
    ours, ref = _pair(num_sets=16)
    store, jstore = HostFeatureStore(feats), JaxStore(feats)
    pending = None
    for trial in range(5):
        batch = sampler.sample(ds.train_idx[trial * B:(trial + 1) * B])
        ids = batch.input_ids.astype(np.int32)
        labels = ds.labels[batch.seeds].astype(np.int32)
        vec = (pack_request_contig(ids, batch.num_input, labels)
               if contiguous else
               pack_request(ids, batch.num_input,
                            [b.adj for b in batch.blocks],
                            [b.mask for b in batch.blocks], labels))
        nv = np.asarray([batch.num_input], np.int32)
        s = sent if contiguous else 0
        h = ours.fetch_begin_packed(ids[None], nv, torch.from_numpy(
            vec[None]), n_req, sentinel=s)
        jh = ref.fetch_begin_packed(ids[None], nv, jax.device_put(
            vec[None], NamedSharding(ref.mesh, P(DATA_AXIS, None))), n_req,
            sentinel=s)
        assert h.miss_count() == int(np.asarray(jh[6]))
        if pending is not None:
            (h0, jh0, ids0) = pending
            got = ours.fetch_complete(h0, store.fetch)
            want = ref.fetch_complete(jh0, jstore.fetch)
            _equal(got.numpy(), np.asarray(want))
            valid = ids0 != sent if contiguous else \
                np.arange(n_req) < h0.num_valid[0]
            np.testing.assert_array_equal(got[0].numpy()[valid],
                                          feats[ids0[valid]])
            _states_equal(ours, ref)
        pending = (h, jh, ids)
    assert ours.stats() == ref.stats()


def test_prewarms_and_row_inserts_are_bitwise_jax(feats):
    ds = synthetic_graph(num_nodes=N_NODES, avg_degree=6, feature_dim=DIM,
                         num_classes=4, seed=4)
    store, jstore = HostFeatureStore(feats), JaxStore(feats)
    ours, ref = _pair(num_sets=8, num_colors=7)
    n = ours.prewarm_by_degree(ds.graph, store.fetch, chunk=100)
    assert n == ref.prewarm_by_degree(ds.graph, jstore.fetch, chunk=100) \
        == 256
    _states_equal(ours, ref)
    warm = np.random.default_rng(5).choice(N_NODES, 700).astype(np.int32)
    ours.prewarm(warm, store.fetch, chunk=128)
    ref.prewarm(warm, jstore.fetch, chunk=128)
    _states_equal(ours, ref)
    rows_ids = np.random.default_rng(6).choice(N_NODES, 300).astype(np.int32)
    cols = np.arange(300, dtype=np.int32) % 7
    ours.insert_rows(rows_ids, feats[rows_ids], cols, chunk=128)
    ref.insert_rows(rows_ids, feats[rows_ids], cols, chunk=128)
    _states_equal(ours, ref)
    ours.insert_rows(rows_ids[:10], feats[rows_ids[:10]])
    ref.insert_rows(rows_ids[:10], feats[rows_ids[:10]])
    _states_equal(ours, ref)
    # hubs of the degree prewarm mostly stay resident
    hubs = np.argsort(np.diff(ds.graph.indptr))[-64:].astype(np.int32)
    ours.stats()
    ref.stats()
    args = (hubs[None], np.asarray([64], np.int32))
    _equal(ours.fetch(*args, store.fetch, fill=False).numpy(),
           np.asarray(ref.fetch(*args, jstore.fetch, fill=False)))
    assert ours.stats() == ref.stats()


def test_refuses_what_is_not_ported():
    cfg = fc.CacheConfig(num_sets=8, ways=fc.WAYS, dim=DIM,
                         cache_dim=fc.round_cache_dim(DIM), num_colors=0)
    # more than one card is more than one rank, each with its own Mesh
    # (tests/test_torch_multigpu_cache.py)
    with pytest.raises(ValueError, match="one process per card"):
        ShardedFeatureCache(cfg, ["cpu", "cpu"])
    with pytest.raises(ValueError):
        ShardedFeatureCache(cfg, ["cpu"], mode="nvshmem")
    cache = ShardedFeatureCache(cfg, ["cpu"])
    with pytest.raises(ValueError):
        cache.fetch_begin(np.zeros((2, 8), np.int32), np.zeros(2, np.int32))
    with pytest.raises(ValueError):
        cache.fetch_begin_packed(np.zeros((1, 8), np.int32),
                                 np.zeros(1, np.int32),
                                 torch.zeros(9, dtype=torch.int32), 8)
