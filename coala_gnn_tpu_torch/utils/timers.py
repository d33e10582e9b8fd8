"""Phase timers and the port's tracer (port of
``coala_gnn_tpu/utils/timers.py``): wall-clock totals and call counts per
named phase, plus unitless tallies (row counts, bytes).

``PhaseTimers.time(phase)`` always adds the phase's host time to its
total and count. With tracing on it also records a span:

    timers = trainer.timers
    timers.spans.clear()
    timers.tracing = True        # off by default
    ... train windows ...
    timers.tracing = False
    torch.cuda.synchronize()     # the tracer never synchronises
    timers.resolve()             # each device span's ``device_ms``
    for s in timers.spans:
        print(s.name, s.parent, s.window, s.step, s.host_ms, s.device_ms)

A span has a name, its parent (the index in ``spans`` of the span open
around it, or None), its start and end on ``time.perf_counter_ns``, and the
window and step it ran in where the trainer knows them (``window``,
``step``). A phase opened with ``device=`` a CUDA device also records a
pair of timing events on that device's current stream at entry and exit:
``resolve`` turns them into ``device_ms``, the stream time from the device
reaching the entry to its finishing the span's last operation (time the
stream waits on the host inside the span included). Elsewhere
``device_ms`` stays None.

Each span also runs inside ``torch.profiler.record_function("trainer." +
phase)``, so under ``torch.profiler.profile(activities=[CPU, CUDA])`` the
program's phases lie on the profiler's own timeline, nested as they ran,
beside the device operations they issued (``export_chrome_trace`` shows
them as host ranges named ``trainer.<phase>``).

With tracing off ``time`` does what it always did: two clock reads and the
totals; no range, no event, no record."""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Optional

import torch

#: name prefix of the profiler ranges the tracer opens
RANGE_PREFIX = "trainer."


@dataclasses.dataclass
class Span:
    """One traced phase (see the module docstring)."""

    name: str
    parent: Optional[int]
    start_ns: int
    end_ns: int = 0
    window: Optional[int] = None
    step: Optional[int] = None
    device_ms: Optional[float] = None
    events: Optional[tuple] = None      # (start, end) until ``resolve``

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


class PhaseTimers:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.tallies: Dict[str, float] = defaultdict(float)
        self.tracing = False
        self.spans: List[Span] = []
        #: where the caller is (stamped on each span it opens)
        self.window: Optional[int] = None
        self.step: Optional[int] = None
        self._open: List[int] = []

    @contextmanager
    def time(self, phase: str, device=None):
        if self.tracing:
            with self._span(phase, device):
                yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[phase] += time.perf_counter() - t0
            self.counts[phase] += 1

    @contextmanager
    def _span(self, phase: str, device):
        span = Span(phase, self._open[-1] if self._open else None, 0,
                    window=self.window, step=self.step)
        self.spans.append(span)
        self._open.append(len(self.spans) - 1)
        timed = device is not None and torch.device(device).type == "cuda"
        with torch.profiler.record_function(RANGE_PREFIX + phase):
            if timed:
                stream = torch.cuda.current_stream(device)
                span.events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
                span.events[0].record(stream)
            span.start_ns = time.perf_counter_ns()
            try:
                yield
            finally:
                span.end_ns = time.perf_counter_ns()
                self.totals[phase] += (span.end_ns - span.start_ns) * 1e-9
                self.counts[phase] += 1
                if timed:
                    span.events[1].record(stream)
                self._open.pop()

    def resolve(self) -> List[Span]:
        """Each span's event pair -> ``device_ms`` (the events dropped).
        Call after the device has finished the spans' work (a
        ``torch.cuda.synchronize()``); raises where an event has not been
        reached yet. -> ``spans``."""
        for s in self.spans:
            if s.events is None:
                continue
            start, end = s.events
            if not end.query():
                raise RuntimeError(f"span {s.name!r}: its device work has "
                                   "not finished; synchronise first")
            s.device_ms = start.elapsed_time(end)
            s.events = None
        return self.spans

    def add(self, phase: str, seconds: float) -> None:
        self.totals[phase] += seconds
        self.counts[phase] += 1

    def tally(self, name: str, n: float) -> None:
        """Accumulate a unitless quantity, reported apart from the phases."""
        self.tallies[name] += n

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {k: {"total_s": self.totals[k], "count": self.counts[k],
                   "mean_ms": 1000 * self.totals[k] / max(self.counts[k], 1)}
               for k in self.totals}
        for k, v in self.tallies.items():
            out[k] = {"total": v}
        return out

    def report(self) -> str:
        lines = []
        for k in sorted(self.totals, key=lambda k: -self.totals[k]):
            lines.append(f"{k:20s} {self.totals[k]:9.3f}s total  "
                         f"{1000 * self.totals[k] / max(self.counts[k], 1):8.2f} ms/call  "
                         f"x{self.counts[k]}")
        for k in sorted(self.tallies):
            lines.append(f"{k:20s} {self.tallies[k]:,.0f} total")
        return "\n".join(lines)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
        self.tallies.clear()
