"""The traced span of a ``--trace 1`` run: ``torch.profiler`` over a few
windows, its device events reduced to busy time, the device operations
that took most time and the idle gaps named by what the host was doing.

The host side is named by spans the benchmark records around the calls
into the program's layers (``labelled``): each method of the trainer in
``LABELS`` that exists runs inside ``record_function("trainer.<name>")``.
An idle gap is named by the innermost such span that holds its middle.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools
import time
from collections import defaultdict
from typing import Callable, List, Tuple

import torch

from gnnbench import arith

#: trainer methods whose calls the traced span names
LABELS = ("_probe_window", "_probe_miss_ids", "_stage_from_mids",
          "_gather_encoded", "_window", "_offer_stage", "_snapshot",
          "_learn", "_frontier", "_sample")
SPAN = "gnnbench.span"
WINDOW = "gnnbench.window"
#: seconds by which a profiled window's last device operation may end
#: before the window's host end (its readback) and still count as reaching it
TAIL_S = 0.02


@contextlib.contextmanager
def patched(obj, name: str, wrap: Callable):
    """``obj.name`` replaced by ``wrap(original)`` while the block runs
    (an instance attribute over a method; a module attribute)."""
    original = getattr(obj, name)
    had = name in vars(obj)
    setattr(obj, name, wrap(original))
    try:
        yield original
    finally:
        if had:
            setattr(obj, name, original)
        else:
            delattr(obj, name)


def _labelled(label: str, fn: Callable) -> Callable:
    @functools.wraps(fn)
    def inner(*a, **kw):
        with torch.profiler.record_function(label):
            return fn(*a, **kw)
    return inner


@contextlib.contextmanager
def labelled(trainer):
    """Every ``LABELS`` method of ``trainer`` that exists, inside its span."""
    with contextlib.ExitStack() as stack:
        for name in LABELS:
            if hasattr(trainer, name):
                stack.enter_context(patched(
                    trainer, name,
                    functools.partial(_labelled, f"trainer.{name}")))
        yield


@dataclasses.dataclass
class Trace:
    """A profiled span: ``window_s`` its host wall, ``busy_s`` the union of
    its device intervals, ``device`` (name, start, end) of each device
    operation and ``host`` (name, start, end) of each benchmark span, in
    seconds from the profiler's start."""

    window_s: float
    busy_s: float
    t0: float
    t1: float
    device: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    windows: List[Tuple[float, float]]
    tail_gaps: List[float] = dataclasses.field(default_factory=list)

    def device_ops(self, top: int = 10) -> list:
        total = defaultdict(float)
        for name, a, b in self.device:
            total[name] += b - a
        return sorted(([n[:160], s] for n, s in total.items()),
                      key=lambda r: -r[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        iv = sorted((a, b) for _, a, b in self.device)
        gaps, cur = [], self.t0
        for a, b in iv:
            if a > cur:
                gaps.append((cur, a))
            cur = max(cur, b)
        if self.t1 > cur:
            gaps.append((cur, self.t1))
        total = defaultdict(float)
        for a, b in gaps:
            mid = (a + b) / 2
            inner = [(e - s, n) for n, s, e in self.host if s <= mid <= e]
            total[min(inner)[1] if inner else "harness"] += b - a
        return sorted(([n, s] for n, s in total.items()),
                      key=lambda r: -r[1])[:top]


def profile(run_windows: Callable[[], list]) -> Tuple[list, "Trace"]:
    """Run ``run_windows`` (which returns its window records) under the
    profiler, inside the ``SPAN`` span. Raises where a window's device
    events stop more than ``TAIL_S`` before its end (``tail_gaps``): the
    profiler has been seen to stop recording device events late in a long
    process. ``Trace.tail_gaps`` keeps the gaps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with tprofile(activities=acts) as prof:
        with torch.profiler.record_function(SPAN):
            records = run_windows()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    dev, host, span, wins = [], [], None, []
    for e in prof.events():
        a, b = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == DeviceType.CUDA:
            # a span of record_function also shows on the device's
            # timeline as an annotation: it is no device operation
            if not getattr(e, "is_user_annotation", False) and not \
                    e.name.startswith(("trainer.", "gnnbench.")):
                dev.append((e.name, a, b))
        elif e.name == SPAN:
            span = (a, b)
        elif e.name == WINDOW:
            wins.append((a, b))
        elif e.name.startswith("trainer."):
            host.append((e.name, a, b))
    if span is None:
        raise RuntimeError("the profiled span left no record")
    t0, t1 = span
    dev = [(n, max(a, t0), min(b, t1)) for n, a, b in dev if b > t0 and
           a < t1]
    wins.sort()
    if torch.cuda.is_available():
        if not dev:
            raise RuntimeError("the profiler recorded no device operation")
        short = tail_gaps(dev, wins)
        if not wins or max(short) > TAIL_S:
            raise RuntimeError(
                "the device events of a profiled window stop before its "
                f"readback: gaps {short} s (allowed {TAIL_S}); the profiler "
                "stopped recording device events")
    busy = arith.busy_s((a, b) for _, a, b in dev)
    return records, Trace(window_s=t1 - t0, busy_s=busy, t0=t0, t1=t1,
                          device=dev, host=host, windows=wins,
                          tail_gaps=tail_gaps(dev, wins) if dev else [])


def tail_gaps(dev: list, wins: list) -> List[float]:
    """For each window (host start, end): how long before its end the last
    device operation that ends by ``end + TAIL_S`` ends (the window's whole
    length where none does). Each window ends in a readback, whose copy is
    a device operation, so a gap over ``TAIL_S`` means the trace stops
    short of that window's end."""
    ends = sorted(b for _, _, b in dev)
    out = []
    for a, b in wins:
        i = bisect.bisect_right(ends, b + TAIL_S)
        last = ends[i - 1] if i and ends[i - 1] >= a else a
        out.append(max(0.0, b - last))
    return out


def now() -> float:
    return time.perf_counter()
