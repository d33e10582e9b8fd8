"""Phase timers (port of ``coala_gnn_tpu/utils/timers.py``): wall-clock
totals and call counts per named phase, plus unitless tallies (row
counts, bytes)."""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict


class PhaseTimers:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.tallies: Dict[str, float] = defaultdict(float)

    @contextmanager
    def time(self, phase: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[phase] += time.perf_counter() - t0
            self.counts[phase] += 1

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
