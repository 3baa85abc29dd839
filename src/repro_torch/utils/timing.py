"""Task-lifecycle instrumentation (paper §III-C).

Every Colmena message carries a ``Timer`` that records wall-clock intervals for
each stage of the task lifecycle: serialization, queue transit, dispatch,
execution, result serialization, result transit.  The paper measures exactly
these components (Fig. 5); we reproduce the measurement machinery so Thinker
policies can reason about overheads at plan time.
"""
from __future__ import annotations

import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field


def now() -> float:
    return time.perf_counter()


@dataclass
class Timer:
    """Accumulates named wall-clock intervals for one task's lifecycle."""

    intervals: dict = field(default_factory=dict)
    marks: dict = field(default_factory=dict)

    def mark(self, name: str) -> None:
        self.marks[name] = now()

    def record(self, name: str, seconds: float) -> None:
        self.intervals[name] = self.intervals.get(name, 0.0) + seconds

    def span(self, name: str, start_mark: str, end_mark: str) -> None:
        if start_mark in self.marks and end_mark in self.marks:
            self.record(name, self.marks[end_mark] - self.marks[start_mark])

    @contextmanager
    def time(self, name: str):
        t0 = now()
        try:
            yield
        finally:
            self.record(name, now() - t0)

    def total(self, *names: str) -> float:
        return sum(self.intervals.get(n, 0.0) for n in names)

    def as_dict(self) -> dict:
        return dict(self.intervals)


class RateMeter:
    """Utilization / throughput meter over a sliding campaign window.

    Cumulative totals (``busy``, ``utilization``) cover the whole
    campaign; the per-event record is bounded to the last
    ``window_events`` entries (the fabric's sliding-window idiom, cf.
    ``BoundedIdSet``) -- a million-task campaign keeps a million-task
    utilization number without a million-entry list.
    """

    def __init__(self, window_events: int = 4096):
        self.busy = 0.0
        self.count = 0
        self.start = now()
        self.events = deque(maxlen=window_events)  # (t, kind, seconds)

    def add_busy(self, seconds: float, kind: str = "task") -> None:
        self.busy += seconds
        self.count += 1
        self.events.append((now() - self.start, kind, seconds))

    def utilization(self, capacity: float) -> float:
        """busy_time / (capacity * elapsed); capacity in worker-slots."""
        elapsed = max(now() - self.start, 1e-9)
        return self.busy / (capacity * elapsed)

    def recent_rate(self) -> float:
        """Events/second over the retained window (0.0 until two
        events exist)."""
        if len(self.events) < 2:
            return 0.0
        dt = self.events[-1][0] - self.events[0][0]
        return (len(self.events) - 1) / max(dt, 1e-9)
