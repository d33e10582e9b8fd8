"""The port's seed distribution (``distribution/``: the greedy, native and
numpy, ``SeedDistributor`` in both modes, ``DistributionScheduler``)
against the JAX package's, bit for bit on the same seeds and color
metadata. Mirrors tests/test_distribution.py; the color metadata comes
from the JAX package's coloring (the port has none yet) and feeds both."""

import numpy as np
import pytest

from coala_gnn_tpu.coloring import generate_color_metadata
from coala_gnn_tpu.distribution import DistributionScheduler as JaxScheduler
from coala_gnn_tpu.distribution import SeedDistributor as JaxDistributor
from coala_gnn_tpu.distribution import \
    greedy_affinity_assign as jax_greedy
from coala_gnn_tpu.graph.datasets import synthetic_graph
from coala_gnn_tpu_torch.distribution import (DistributionScheduler,
                                              SeedDistributor,
                                              greedy_affinity_assign)
from coala_gnn_tpu_torch.distribution import distributor as distributor_mod


@pytest.fixture(scope="module")
def colored():
    ds = synthetic_graph(num_nodes=2000, avg_degree=10, feature_dim=8,
                         num_classes=8, seed=7)
    meta = generate_color_metadata(ds.graph, ds.train_idx, base_rate=0.02,
                                   seed=0)
    return ds, meta


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _pair(ids, **kw):
    return SeedDistributor(ids, **kw), JaxDistributor(ids, **kw)


def _color_kw(meta):
    return dict(mode="node_color", color=meta.color, topk_colors=meta.topk,
                affinity=meta.score)


@pytest.mark.parametrize("num_parts,cap", [(4, 64), (3, 50), (1, 32)])
def test_greedy_native_and_numpy_equal_jax(colored, num_parts, cap):
    ds, meta = colored
    cache_meta = np.random.default_rng(num_parts).integers(
        0, 50, size=(num_parts, meta.num_colors + 1)).astype(np.int32)
    seeds = ds.train_idx[:num_parts * cap]
    args = (seeds, meta.color, meta.topk, meta.score, cache_meta, cap)
    want = jax_greedy(*args, use_native=True)
    _equal(greedy_affinity_assign(*args, use_native=True), want)
    _equal(greedy_affinity_assign(*args, use_native=False), want)
    _equal(jax_greedy(*args, use_native=False), want)


def test_greedy_respects_capacity_and_scores(colored):
    ds, meta = colored
    num_parts, cap = 3, 50
    cache_meta = np.zeros((num_parts, meta.num_colors + 1), dtype=np.int32)
    cache_meta[1, :] = 100          # part 1 holds every color: wins first
    counts = np.bincount(greedy_affinity_assign(
        ds.train_idx[:num_parts * cap], meta.color, meta.topk, meta.score,
        cache_meta, cap), minlength=num_parts)
    assert counts[1] == cap and counts.sum() == num_parts * cap
    assert (counts <= cap).all()


def test_greedy_raises_without_the_native_library(colored, monkeypatch):
    """No silent numpy fallback (the JAX function swallows the failure)."""
    ds, meta = colored

    def broken():
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(distributor_mod.native_lib, "get", broken)
    cache_meta = np.ones((2, meta.num_colors + 1), np.int32)
    args = (ds.train_idx[:8], meta.color, meta.topk, meta.score, cache_meta,
            4)
    with pytest.raises(RuntimeError):
        greedy_affinity_assign(*args)
    assert greedy_affinity_assign(*args, use_native=False).shape == (8,)


def test_baseline_striping_equals_jax(colored):
    ds, _ = colored
    ours, ref = _pair(ds.train_idx, batch_size=8, local_size=2, num_parts=2,
                      mode="baseline", shuffle_seed=1)
    _equal(ours.items, ref.items)
    assert ours.num_iters == ref.num_iters
    for it in (0, 1, ours.num_iters - 1):
        out = ours.distribute(it)
        _equal(out, ref.distribute(it))
        _equal(ours.device_slice(out[0], 1), ref.device_slice(out[0], 1))
    np.testing.assert_array_equal(ours.distribute(0)[0], ours.items[:16])


def test_node_color_partition_equals_jax(colored):
    ds, meta = colored
    ours, ref = _pair(ds.train_idx, batch_size=8, local_size=2, num_parts=2,
                      shuffle_seed=1, **_color_kw(meta))
    cache_meta = np.random.default_rng(3).integers(
        0, 20, size=(2, meta.num_colors + 1)).astype(np.int32)
    for it in (0, 3):
        out = ours.distribute(it, cache_meta)
        _equal(out, ref.distribute(it, cache_meta))
        window = ours.items[it * 32:(it + 1) * 32]
        np.testing.assert_array_equal(np.sort(out.reshape(-1)),
                                      np.sort(window))
    # two replicas (as on two hosts) agree
    _equal(ours.distribute(3, cache_meta), SeedDistributor(
        ds.train_idx, batch_size=8, local_size=2, num_parts=2,
        shuffle_seed=1, **_color_kw(meta)).distribute(3, cache_meta))


def test_scheduler_pipeline_equals_jax(colored):
    """The one-ahead distribution thread and the meta refresh cadence
    (every 4 iterations) give JAX's seeds, and reset restarts."""
    ds, meta = colored
    calls = {"ours": 0, "ref": 0}

    def meta_fn(who):
        def fn():
            calls[who] += 1
            return np.full(meta.num_colors + 1, 1 + calls[who], np.int32)
        return fn

    kw = dict(batch_size=8, local_size=2, num_parts=2, shuffle_seed=0,
              **_color_kw(meta))
    ours = DistributionScheduler(SeedDistributor(ds.train_idx, **kw), 0, 1,
                                 meta_fn=meta_fn("ours"), refresh_counter=4)
    ref = JaxScheduler(JaxDistributor(ds.train_idx, **kw), 0, 1,
                       meta_fn=meta_fn("ref"), refresh_counter=4)
    n = min(ours.d.num_iters, 9)
    for _ in range(n):
        _equal(ours.run(), ref.run())
        _equal(ours.domain_valid, ref.domain_valid)
    assert calls["ours"] == calls["ref"] == (n + 3) // 4
    ours.reset(5)
    ref.reset(5)
    _equal(ours.run_domain(), ref.run_domain())


def test_drop_tail_false_visits_every_seed():
    ids = np.arange(1000, 1103)           # 103 seeds, global_batch = 16
    ours, ref = _pair(ids, batch_size=4, local_size=2, num_parts=2,
                      shuffle_seed=0, drop_tail=False)
    assert ours.num_iters == ref.num_iters == 7
    seen = set()
    for it in range(ours.num_iters):
        parts = ours.distribute(it)
        _equal(parts, ref.distribute(it))
        seen.update(parts.reshape(-1).tolist())
    assert seen == set(ids.tolist())
    assert SeedDistributor(ids, batch_size=4, local_size=2, num_parts=2,
                           shuffle_seed=0).num_iters == 103 // 16


def test_drop_tail_false_tiny_dataset_wraps():
    ours, ref = _pair(np.arange(5), batch_size=4, local_size=2, num_parts=1,
                      shuffle_seed=1, drop_tail=False)
    assert ours.num_iters == 1
    _equal(ours.distribute(0), ref.distribute(0))
    assert set(ours.distribute(0).reshape(-1).tolist()) == set(range(5))


def test_valid_mask_equals_jax():
    ids = np.arange(1000, 1103)
    ours, ref = _pair(ids, batch_size=4, local_size=2, num_parts=2,
                      shuffle_seed=0, drop_tail=False)
    total = 0
    for it in range(ours.num_iters):
        m = ours.valid_mask(it)
        _equal(m, ref.valid_mask(it))
        total += int(m.sum())
        out, valid = ours.distribute(it, return_valid=True)
        _equal(valid, m)
        for a, b in zip((out, valid), ref.distribute(it, return_valid=True)):
            _equal(a, b)
    assert total == len(ids)
    with pytest.raises(IndexError):
        ours.valid_mask(ours.num_iters)


def test_valid_mask_refuses_reordering_mode(colored):
    _, meta = colored
    d = SeedDistributor(np.arange(64), batch_size=4, local_size=2,
                        num_parts=2, shuffle_seed=0, drop_tail=False,
                        **_color_kw(meta))
    with pytest.raises(ValueError):
        d.valid_mask(0)
    with pytest.raises(ValueError):
        SeedDistributor(np.arange(8), 4, 1, 1, mode="node_color")
    with pytest.raises(ValueError):
        SeedDistributor(np.arange(8), 4, 1, 1, mode="round_robin")


def test_return_valid_node_color_equals_jax(colored):
    """Validity rides through the reordering: across the epoch the valid
    slots name every seed once; the wrapped slots repeat earlier seeds."""
    _, meta = colored
    ids = np.arange(100)                  # global_batch 16 -> a tail of 4
    ours, ref = _pair(ids, batch_size=4, local_size=2, num_parts=2,
                      shuffle_seed=0, drop_tail=False, **_color_kw(meta))
    cache_meta = np.random.default_rng(3).integers(
        0, 50, size=(2, meta.num_colors + 1)).astype(np.int32)
    seen = []
    for it in range(ours.num_iters):
        out, valid = ours.distribute(it, cache_meta, return_valid=True)
        want = ref.distribute(it, cache_meta, return_valid=True)
        _equal(out, want[0])
        _equal(valid, want[1])
        if it == ours.num_iters - 1:
            assert int(valid.sum()) == 100 % 16
            assert set(out[~valid].tolist()) <= set(seen)
        seen.extend(out[valid].tolist())
    assert sorted(seen) == ids.tolist()


def test_scheduler_threads_domain_valid_equal_jax():
    ids = np.arange(103)
    kw = dict(batch_size=4, local_size=2, num_parts=1, shuffle_seed=0,
              drop_tail=False)
    ours = DistributionScheduler(SeedDistributor(ids, **kw), 0, 0)
    ref = JaxScheduler(JaxDistributor(ids, **kw), 0, 0)
    seen = []
    for _ in range(ours.d.num_iters):
        dom = ours.run_domain()
        _equal(dom, ref.run_domain())
        _equal(ours.domain_valid, ref.domain_valid)
        seen.extend(dom[ours.domain_valid].tolist())
    assert sorted(seen) == ids.tolist()
    with pytest.raises(StopIteration):
        ours.run_domain()
    ours.reset()
    ours.run_domain()
    assert ours.domain_valid.all()
