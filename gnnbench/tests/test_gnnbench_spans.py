"""The metrics that read the program's own spans and counters
(``gnnbench/spans.py``, ``gnnbench/metrics/*_ms_per_step.py``,
``offer_pack_ms_per_window.py``, ``h2d_mb_per_window.py``), on the CPU:
a traced run of the staged cell reports the host span and the byte
counter and leaves out every stream-time metric, since there is no
device; a program without the tracer leaves them out without failing."""

import contextlib
import time
import types

import torch

from gnnbench import cell as C
from gnnbench import registry, spans

SEED = 2**31 + 977
STREAM = ("sample_ms_per_step", "lookup_ms_per_step", "learn_ms_per_step")


def test_traced_staged_run_reports_the_program_span_and_counter(tiny_root):
    cell = registry.load_cell("sage-igbm-c4g", tiny_root)
    out = C.run_cell(cell, SEED, 0.2, True, "cpu", time.perf_counter())
    assert out is not None
    result = out[0]
    assert result["correct"], result["compared"]
    m = result["metrics"]
    assert 0 < m["offer_pack_ms_per_window"]["value"] <= \
        m["offer_ms_per_window"]["value"]
    assert m["offer_pack_ms_per_window"]["unit"] == "ms"
    rows = m["stage_rows_per_window"]["value"]
    dim = int(cell.cfg["feature_dim"])
    # at least the stage rows at f32 with their four side arrays
    assert m["h2d_mb_per_window"]["value"] >= rows * (4 * dim + 13) / 1e6
    assert m["h2d_mb_per_window"]["unit"] == "MB"
    for name in STREAM:
        assert name + ".staged" not in m and name not in m, name


def test_the_span_probe_traces_only_the_block(tiny_root):
    cell = registry.load_cell("sage-igbm-c4g", tiny_root)
    bench = C.Bench(cell, SEED, torch.device("cpu"))
    bench.setup(warmup=False)
    ctx = C.Context(cell=cell, run=bench.run, data=bench.data, seed=SEED,
                    device=bench.device)
    timers = bench.run.trainer.timers
    readers = [registry.load_reader(tiny_root, n) for n in STREAM]
    with contextlib.ExitStack() as stack:
        for r in readers:
            stack.enter_context(r.span_probe(ctx))
        assert timers.tracing
        bench.windows(count=1)
    assert not timers.tracing and timers.spans == []
    got = ctx.probes[spans.KEY]
    names = {s.name for s in got}
    assert {"sample", "lookup", "learn", "insert.pack"} <= names
    assert all(s.device_ms is None for s in got)
    ctx.trace = types.SimpleNamespace(windows=[(0.0, 1.0)])
    assert all(r.read(ctx) is None for r in readers)
    bench.windows(count=1)
    assert timers.spans == []


def test_stream_time_is_the_spans_device_time_per_profiled_step():
    S = types.SimpleNamespace
    ctx = S(cell=S(traffic={"window": 4}), probes={spans.KEY: [
        S(name="sample", device_ms=1.5), S(name="sample", device_ms=2.5),
        S(name="learn", device_ms=8.0)]},
        trace=S(windows=[(0, 1), (1, 2)]))
    assert spans.ms_per_step(ctx, "sample") == 4.0 / 8
    assert spans.ms_per_step(ctx, "learn") == 1.0
    assert spans.ms_per_step(ctx, "lookup") is None
    ctx.probes[spans.KEY].append(S(name="learn", device_ms=None))
    assert spans.ms_per_step(ctx, "learn") is None


def test_a_program_without_the_tracer_reports_nothing():
    S = types.SimpleNamespace
    ctx = S(run=S(trainer=S(timers=S(totals={}, tallies={}))), probes={},
            trace=S(windows=[(0, 1)]), cell=S(traffic={"window": 8}))
    ctx.trainer = ctx.run.trainer
    with spans.span_probe(ctx):
        pass
    assert spans.KEY not in ctx.probes
    assert spans.ms_per_step(ctx, "sample") is None
