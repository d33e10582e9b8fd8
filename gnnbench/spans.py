"""The program's own spans, read by the stream-time metrics
(``gnnbench/metrics/*_ms_per_step.py``).

The port's ``PhaseTimers`` (``coala_gnn_tpu_torch/utils/timers.py``) is its
tracer: with ``tracing`` on, each phase it times is also a span, and a
phase opened with a CUDA device records a pair of timing events on the
device's current stream at its entry and exit. ``span_probe`` turns the
trainer's tracing on, its span list cleared, for the profiled span, and
off afterwards; the events are resolved into each span's ``device_ms``
after the profile's closing ``torch.cuda.synchronize()``. A span's
``device_ms`` is stream time: from the device reaching the span's entry
to its finishing the span's last operation, including any time the
stream waits on the host inside the span.

A program without the tracer (no ``resolve`` on its timers) leaves the
metrics out, as does a run without a card (``device_ms`` None)."""

from __future__ import annotations

import contextlib

KEY = "program_spans"


@contextlib.contextmanager
def span_probe(ctx):
    """Tracing on for the block (once, however many readers ask); the
    resolved spans in ``ctx.probes[KEY]`` afterwards."""
    timers = ctx.trainer.timers
    if KEY in ctx.probes or not hasattr(timers, "resolve"):
        yield
        return
    ctx.probes[KEY] = []
    timers.spans.clear()
    timers.tracing = True
    try:
        yield
    finally:
        timers.tracing = False
    ctx.probes[KEY] = list(timers.resolve())
    timers.spans.clear()


def ms_per_step(ctx, name: str):
    """Stream time of every ``name`` span of the profiled span, in ms per
    profiled step (its windows times K); None without device times."""
    spans = [s for s in ctx.probes.get(KEY) or () if s.name == name]
    if not spans or ctx.trace is None or not ctx.trace.windows or \
            any(s.device_ms is None for s in spans):
        return None
    steps = len(ctx.trace.windows) * int(ctx.cell.traffic["window"])
    return sum(s.device_ms for s in spans) / steps
