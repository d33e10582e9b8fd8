"""The offer of a window's stage to the cache on ``ShardedResidentTrainer``
(one rank, the CPU): under the f32 transport it reads the stage on the
device (``ShardedFeatureCache.insert_stage``), under bf16 and int8 it
inserts the f32 rows read on the host (``insert_rows``).

Held at f32, against a twin trainer whose offer inserts the same stage's
rows from the host tier through ``insert_rows`` (the host offer): after
several staged windows the cache state (tags, lines, cursors, line colors,
color counts, counters) is bitwise the twin's, and so are the losses; with
``stage_overlap`` the patch rows stay unoffered and each offer reports
the same evicted ids in the same order; ``offer_device_rows`` counts the
rows offered; no offer uploads a pageable byte, and the pinned bytes are
the stages' plus an int32 index wherever the offered positions are not
one range. Held at bf16 and int8: the offer goes through ``insert_rows``,
``offer_device_rows`` is never tallied, and the pageable bytes are the
seed grids plus each chunk's three packed arrays."""

import functools

import numpy as np
import pytest
import torch

from coala_gnn_tpu_torch.cache import feature_cache as fc
from coala_gnn_tpu_torch.cache.host_tier import HostFeatureStore
from coala_gnn_tpu_torch.graph.datasets import synthetic_graph
from coala_gnn_tpu_torch.models.gnn import make_model
from coala_gnn_tpu_torch.parallel.sharded_cache import ShardedFeatureCache
from coala_gnn_tpu_torch.parallel.sharded_resident import \
    ShardedResidentTrainer

torch.set_num_threads(1)

N, DIM, B, K, M = 600, 8, 16, 3, 4
FANOUTS = [4, 3]
CHUNK = 64          # the offer's chunk, so that one window offers several
NUM_COLORS = 5

#: name -> (colors, stage_overlap, a native host store behind host_fetch)
CASES = {
    "serial": (False, False, True),
    "colors": (True, False, True),
    "overlap-colors": (True, True, True),
    "plain-fetch": (False, False, False),
}


@functools.lru_cache(maxsize=None)
def _data():
    return synthetic_graph(num_nodes=N, avg_degree=6, feature_dim=DIM,
                           num_classes=4, seed=3)


def _trainer(transport, colors, overlap, native):
    ds = _data()
    cfg = fc.CacheConfig(num_sets=4, ways=8, dim=DIM, cache_dim=DIM,
                         num_colors=NUM_COLORS if colors else 0)
    cache = ShardedFeatureCache(cfg, ["cpu"])
    cache.insert_rows = functools.partial(cache.insert_rows, chunk=CHUNK)
    cache.insert_stage = functools.partial(cache.insert_stage, chunk=CHUNK)
    store = HostFeatureStore(ds.features)
    torch.manual_seed(0)
    model = make_model("sage", DIM, 16, 4, len(FANOUTS), dropout=0.0)
    node_colors = (np.arange(N, dtype=np.int32) % NUM_COLORS + 1
                   if colors else None)
    return ShardedResidentTrainer(
        graph=ds.graph,
        host_fetch=store.fetch if native else (lambda i: store.fetch(i)),
        labels=ds.labels, cache=cache, model=model,
        optimizer=torch.optim.Adam(model.parameters(), lr=1e-2),
        fanouts=FANOUTS, batch_size=B, colors=node_colors,
        stage_transport=transport, stage_overlap=overlap)


def _host_offer(rt, stage, return_evicted=False):
    """The host offer of a stage: its offered ids' f32 rows read from the
    host tier and inserted through ``insert_rows``."""
    mids, _, offer = stage[6]
    if not offer.any():
        return None
    ids = mids[offer]
    colors = None if rt.colors is None else rt.colors[ids]
    return rt.cache.insert_rows(ids, rt.host_fetch(ids.astype(np.int64)),
                                colors, return_evicted=return_evicted,
                                timers=rt.timers)


def _watch(rt, name, seen):
    """Record every array the cache's ``name`` returns, and the host
    stage ids and offer mask it was given (``insert_stage``)."""
    insert = getattr(rt.cache, name)

    def inner(*args, **kwargs):
        out = insert(*args, **kwargs)
        seen.append((args, None if out is None else out.clone()))
        return out
    setattr(rt.cache, name, inner)


def _state(rt) -> dict:
    s = rt.cache.state
    b = s.base
    return {"tags": b.tags, "data": b.data, "rr": b.rr,
            "color_counts": b.color_counts, "hits": b.hits,
            "misses": b.misses, "line_colors": s.line_colors}


def _grids():
    rng = np.random.default_rng(11)
    return rng.integers(0, N, size=(M, 1, K, B)).astype(np.int32)


@pytest.mark.parametrize("name", sorted(CASES))
def test_f32_offer_from_the_card_is_the_host_offer(name):
    colors, overlap, native = CASES[name]
    dev = _trainer("float32", colors, overlap, native)
    host = _trainer("float32", colors, overlap, native)
    host._offer_stage = functools.partial(_host_offer, host)
    dev_seen, dev_rows, host_seen = [], [], []
    _watch(dev, "insert_stage", dev_seen)
    _watch(dev, "insert_rows", dev_rows)
    _watch(host, "insert_rows", host_seen)
    for first in (0, M):            # two calls: the cache carries over
        got, _ = dev.train_windows(_grids(), seed=7, first_window=first)
        want, _ = host.train_windows(_grids(), seed=7, first_window=first)
        assert torch.equal(got, want)
    for k, v in _state(host).items():
        assert torch.equal(_state(dev)[k], v), k
    assert colors == bool(_state(dev)["color_counts"].sum())

    # every f32 offer came from the card, the same evicted ids in order
    assert len(dev_seen) == len(host_seen) == 2 * M and not dev_rows
    for (_, got_ev), (_, want_ev) in zip(dev_seen, host_seen):
        assert (got_ev is None) == (want_ev is None)
        if got_ev is not None:
            assert torch.equal(got_ev, want_ev)
    offered = [args[1] for args, _ in dev_seen]
    assert dev.timers.tallies["offer_device_rows"] == \
        sum(int(o.sum()) for o in offered)
    assert "offer_device_rows" not in host.timers.tallies
    if overlap:
        # patch rows were staged and left unoffered
        assert any(not o.all() for o in offered)
        assert all(ev is not None for _, ev in dev_seen[:M - 1])
    else:
        assert all(o.all() for o in offered)

    # the bytes: no pageable offer, an index where the positions split
    seeds = 2 * M * K * B * 4
    assert dev.timers.tallies["h2d_pageable_bytes"] == seeds
    split = 0
    for o in offered:
        pos = np.flatnonzero(o)
        if pos.size and pos[-1] - pos[0] + 1 != pos.size:
            split += 4 * pos.size
    assert dev.timers.tallies["h2d_pinned_bytes"] == \
        host.timers.tallies["h2d_pinned_bytes"] + split
    assert (split > 0) == overlap


@pytest.mark.parametrize("transport", ["bfloat16", "int8"])
def test_rounded_transports_offer_from_the_host(transport):
    rt = _trainer(transport, True, False, True)
    seen, staged = [], []
    _watch(rt, "insert_stage", staged)
    _watch(rt, "insert_rows", seen)
    rt.train_windows(_grids(), seed=7)
    assert len(seen) == M and not staged
    assert "offer_device_rows" not in rt.timers.tallies
    chunks = sum(max(1, -(-len(args[0]) // CHUNK)) for args, _ in seen)
    assert rt.timers.counts["insert.upload"] == chunks
    assert rt.timers.tallies["h2d_pageable_bytes"] == \
        M * K * B * 4 + chunks * CHUNK * (4 + DIM * 4 + 4)
