"""Lock-light metrics registry embedded in every fabric role.

Counters, gauges and power-of-two-bucket histograms held in a plain
per-process dict.  Deliberately **lock-free**: all mutation is single
bytecode-level dict/int operations that the GIL serializes, the worst
race outcome is one lost increment (a telemetry rounding error, never a
correctness one), and -- decisive for this fabric -- no new locks means
no new edges in the lock-order witness graph for instrumented hot
paths to trip over.

The registry is per-process and fork-aware: a forked child starts from
its parent's counts unless it resets, which would double-count on
merge, so the registry self-clears on pid change (the
``_after_fork`` pid-check idiom).  Values leave the process either via
``snapshot()`` embedded in a ``stats_scrape`` reply (live processes) or
via the tracer's throttled ``flush_metrics`` jsonl lines (cumulative,
so SIGKILL costs at most the last unflushed window).
"""
from __future__ import annotations

import os
from typing import Dict


class Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Pow2-bucketed distribution: bucket ``b`` counts observations in
    ``[2^(b-21), 2^(b-20))`` -- micro-resolution near zero (bucket 0 is
    everything below ~1e-6), decades of headroom above, and integer-only
    bookkeeping on the observe path."""

    __slots__ = ("count", "sum", "buckets")

    def __init__(self) -> None:
        self.count = 0
        self.sum = 0.0
        self.buckets: Dict[int, int] = {}

    def observe(self, v: float) -> None:
        self.count += 1
        self.sum += v
        b = int(v * (1 << 20)).bit_length() if v > 0 else 0
        self.buckets[b] = self.buckets.get(b, 0) + 1


_registry: Dict[str, object] = {}
_registry_pid = -1


def _reg() -> Dict[str, object]:
    global _registry_pid
    pid = os.getpid()
    if pid != _registry_pid:
        # forked child: inherited counts belong to the parent's story
        _registry.clear()
        _registry_pid = pid
    return _registry


def counter(name: str) -> Counter:
    reg = _reg()
    c = reg.get(name)
    if type(c) is not Counter:
        c = reg.setdefault(name, Counter())   # racing threads converge
    return c                                   # type: ignore[return-value]


def gauge(name: str) -> Gauge:
    reg = _reg()
    g = reg.get(name)
    if type(g) is not Gauge:
        g = reg.setdefault(name, Gauge())
    return g                                   # type: ignore[return-value]


def histo(name: str) -> Histogram:
    reg = _reg()
    h = reg.get(name)
    if type(h) is not Histogram:
        h = reg.setdefault(name, Histogram())
    return h                                   # type: ignore[return-value]


def observe(name: str, v: float) -> None:
    histo(name).observe(v)


def snapshot() -> dict:
    """Primitive-only cumulative snapshot, safe to embed in a frame
    header reply or a jsonl line."""
    counters, gauges, histos = {}, {}, {}
    for name, obj in list(_reg().items()):
        if isinstance(obj, Counter):
            counters[name] = obj.value
        elif isinstance(obj, Gauge):
            gauges[name] = obj.value
        elif isinstance(obj, Histogram):
            histos[name] = {"count": obj.count, "sum": obj.sum,
                            "buckets": {str(k): v
                                        for k, v in obj.buckets.items()}}
    return {"counters": counters, "gauges": gauges, "histos": histos}


def reset() -> None:
    """Test hook: drop every instrument in this process."""
    _reg().clear()
