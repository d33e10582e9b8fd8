"""The port's tracer (``utils/timers.py`` ``PhaseTimers`` with tracing on)
and the spans and counters the window path opens, on the CPU.

Held: with tracing off no profiler range is entered, no CUDA event is
made and no span is kept; with it on, nested phases record their parents,
and the same ``trainer.*`` ranges nest the same way in a CPU
``torch.profiler`` trace; ``device_ms`` stays None off a card. One tiny
staged window of ``ShardedResidentTrainer`` opens a ``sample`` span for
every probed and every trained step, a ``lookup`` and a ``learn`` span
for every trained step, and an ``insert.kernel`` span for every chunk of
its offer: under the int8 transport with an ``insert.upload`` and an
``insert.pack`` per chunk (and ``insert.pack`` once more, for the
selection of the offered rows), under f32, whose offer reads the stage on
the device, with no upload and one ``insert.pack``, the selection; its
``h2d_pinned_bytes`` and ``h2d_pageable_bytes`` tallies equal the bytes
reckoned from its shapes."""

import functools

import numpy as np
import pytest
import torch

from coala_gnn_tpu_torch.cache import feature_cache as fc
from coala_gnn_tpu_torch.cache.host_tier import HostFeatureStore
from coala_gnn_tpu_torch.graph.datasets import synthetic_graph
from coala_gnn_tpu_torch.models.gnn import make_model
from coala_gnn_tpu_torch.parallel.resident import stage_cap
from coala_gnn_tpu_torch.parallel.sharded_cache import ShardedFeatureCache
from coala_gnn_tpu_torch.parallel.sharded_resident import \
    ShardedResidentTrainer
from coala_gnn_tpu_torch.utils import timers as T

torch.set_num_threads(1)

N, DIM, B, K = 600, 8, 16, 3
FANOUTS = [4, 3]
CHUNK = 64          # the offer's chunk, so that one window offers several


class _Counting:
    """``torch.profiler.record_function`` stand-in that counts entries."""

    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        type(self).entered += 1
        return self

    def __exit__(self, *exc):
        return False


def _trainer(transport="float32"):
    ds = synthetic_graph(num_nodes=N, avg_degree=6, feature_dim=DIM,
                         num_classes=4, seed=3)
    cfg = fc.CacheConfig(num_sets=4, ways=8, dim=DIM, cache_dim=DIM,
                         num_colors=0)
    cache = ShardedFeatureCache(cfg, ["cpu"])
    cache.insert_rows = functools.partial(cache.insert_rows, chunk=CHUNK)
    cache.insert_stage = functools.partial(cache.insert_stage, chunk=CHUNK)
    model = make_model("sage", DIM, 16, 4, len(FANOUTS), dropout=0.0)
    return ShardedResidentTrainer(
        graph=ds.graph, host_fetch=HostFeatureStore(ds.features).fetch,
        labels=ds.labels, cache=cache, model=model,
        optimizer=torch.optim.Adam(model.parameters(), lr=1e-2),
        fanouts=FANOUTS, batch_size=B, stage_transport=transport)


def _grid(window):
    rng = np.random.default_rng(window)
    return rng.integers(0, N, size=(1, K, B)).astype(np.int32)


def test_tracing_off_enters_no_range_and_keeps_no_span(monkeypatch):
    monkeypatch.setattr(_Counting, "entered", 0)
    monkeypatch.setattr(torch.profiler, "record_function", _Counting)
    events = []
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **kw: events.append(1))
    rt = _trainer()
    assert not rt.timers.tracing
    rt.train_window(_grid(0), 5, window=0)
    assert _Counting.entered == 0 and not events
    assert rt.timers.spans == []
    # the phases are timed all the same (the f32 offer uploads nothing)
    for phase in ("sample", "lookup", "learn", "insert.pack",
                  "insert.kernel", "stage_upload"):
        assert rt.timers.counts[phase] > 0, phase
    assert "stage_alloc" not in rt.timers.totals
    assert "insert.upload" not in rt.timers.totals
    t = T.PhaseTimers()
    with t.time("a", device="cpu"):
        pass
    assert _Counting.entered == 0 and t.spans == [] and t.counts["a"] == 1


def test_nested_spans_record_parents_and_nest_in_the_profiler():
    t = T.PhaseTimers()
    t.tracing = True
    t.window = 7
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with t.time("outer"):
            t.step = 2
            with t.time("inner", device=torch.device("cpu")):
                torch.ones(4).sum()
            with t.time("inner2"):
                pass
        with t.time("after"):
            pass
    names = [s.name for s in t.spans]
    assert names == ["outer", "inner", "inner2", "after"]
    assert [s.parent for s in t.spans] == [None, 0, 0, None]
    assert [s.step for s in t.spans] == [None, 2, 2, 2]
    assert all(s.window == 7 for s in t.spans)
    for s in t.spans:
        assert s.end_ns >= s.start_ns and s.device_ms is None
        assert s.events is None
    outer, inner, inner2, after = t.spans
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= \
        inner2.start_ns <= inner2.end_ns <= outer.end_ns <= after.start_ns
    assert t.counts == {"outer": 1, "inner": 1, "inner2": 1, "after": 1}
    assert t.totals["outer"] >= t.totals["inner"] + t.totals["inner2"]
    assert t.resolve() is t.spans and all(s.device_ms is None
                                          for s in t.spans)
    ranges = {e.name: e for e in prof.events()
              if e.name.startswith(T.RANGE_PREFIX)}
    assert set(ranges) == {"trainer." + n for n in names}
    for child, parent in (("inner", "outer"), ("inner2", "outer")):
        c, p = ranges["trainer." + child], ranges["trainer." + parent]
        assert c.cpu_parent is not None and c.cpu_parent.name == p.name
        assert p.time_range.start <= c.time_range.start <= \
            c.time_range.end <= p.time_range.end
    assert ranges["trainer.outer"].cpu_parent is None or \
        not ranges["trainer.outer"].cpu_parent.name.startswith("trainer.")


def test_a_span_closes_when_its_body_raises():
    t = T.PhaseTimers()
    t.tracing = True
    with pytest.raises(ValueError):
        with t.time("outer"):
            with t.time("inner"):
                raise ValueError("x")
    with t.time("next"):
        pass
    assert [s.parent for s in t.spans] == [None, 0, None]
    assert t.counts["inner"] == t.counts["outer"] == 1
    assert all(s.end_ns >= s.start_ns > 0 for s in t.spans)


@pytest.mark.parametrize("transport", ["float32", "int8"])
def test_a_staged_window_spans_and_counts_its_bytes(transport):
    rt = _trainer(transport)
    t = rt.timers
    rt.train_window(_grid(0), 5, window=0)      # warm: the cache fills
    t.reset()
    t.spans.clear()
    t.tracing = True
    rt.train_window(_grid(1), 5, window=1)
    t.tracing = False
    spans = t.resolve()
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    rows = int(t.tallies["stage_rows"])
    assert rows > CHUNK, "the window should offer several chunks"
    chunks = -(-rows // CHUNK)
    assert len(by["insert.kernel"]) == chunks
    if transport == "float32":
        # the offer reads the stage on the card: the host selects once
        assert "insert.upload" not in by
        assert len(by["insert.pack"]) == 1
        assert t.tallies["offer_device_rows"] == rows
    else:
        assert len(by["insert.upload"]) == chunks
        assert len(by["insert.pack"]) == chunks + 1
        assert "offer_device_rows" not in t.tallies
    # sampled twice a step: the probe's replay, then the window
    assert len(by["sample"]) == 2 * K
    assert len(by["lookup"]) == len(by["learn"]) == K
    assert sorted(s.step for s in by["learn"]) == list(range(K))
    assert {s.window for s in by["sample"] + by["learn"]} == {1}
    assert all(s.device_ms is None for s in spans)
    # every insert.* span lies inside the offer's insert_dispatch
    offer = next(i for i, s in enumerate(spans)
                 if s.name == "insert_dispatch")
    for name in ("insert.pack", "insert.upload", "insert.kernel"):
        assert all(s.parent == offer for s in by.get(name, [])), name
    # the window's device spans lie in window_dispatch, the probe's in
    # probe_dispatch
    parents = {spans[s.parent].name for s in by["sample"]}
    assert parents == {"window_dispatch", "probe_dispatch"}
    assert {spans[s.parent].name for s in by["lookup"] + by["learn"]} == \
        {"window_dispatch"}
    # the host time of every span is in the phase totals
    for name, group in by.items():
        assert t.counts[name] == len(group)
        assert t.totals[name] == pytest.approx(
            sum(s.host_ms for s in group) * 1e-3, rel=1e-9, abs=1e-12)

    cap = stage_cap(rows)
    row_bytes = DIM * (4 if transport == "float32" else 1)
    per_row = row_bytes + 4 + 4 + 4 + 1     # rows, ids, colors, prios, offer
    if transport == "int8":
        per_row += 4                        # the row scales
    assert t.tallies["h2d_pinned_bytes"] == cap * per_row
    seeds = 1 * K * B * 4
    # one rank offers a contiguous range of the stage: no index uploaded
    offered = 0 if transport == "float32" else chunks * CHUNK * (
        4 + DIM * 4 + 4)
    assert t.tallies["h2d_pageable_bytes"] == offered + seeds
