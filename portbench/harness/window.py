"""The measured window of one run, and the profiler of a traced run.

A driver opens the window, runs units of work (a re-score, a retrain task,
an engine call) back to back until it has closed, and calls ``boundary()``
between units, where the card has finished all the work issued so far. In a
traced run (``--trace 1``) the profiler starts at the first boundary past
``seconds - trace_seconds`` and stops at the first boundary past the close,
so the traced part holds whole units only, and the host-timed units before
it ran without the profiler's cost.

``DeviceTrace`` reduces the profiler's raw events: the device operations
(kernels, copies, sets) and the host operations, in nanoseconds on one
clock. Its busy time is the union of the device operations' intervals.
"""
from __future__ import annotations

import bisect
import threading
import time
from collections import defaultdict
from dataclasses import dataclass


@dataclass
class DeviceTrace:
    window_s: float                    # host seconds the profiler ran
    device: list                       # (name, start_ns, end_ns), sorted
    host: list                         # (name, start_ns, end_ns), sorted

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        busy, end = 0, None
        for _, s, e in self.device:
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy / 1e9

    def seconds_of(self, match) -> float:
        """Device seconds of the operations whose name ``match`` accepts."""
        return sum(e - s for n, s, e in self.device if match(n)) / 1e9

    def _gaps(self):
        end = None
        for _, s, e in self.device:
            if end is not None and s > end:
                yield end, s
            end = e if end is None else max(end, e)

    def _host_label(self, starts, t: int) -> str:
        """The innermost host operation running at ``t``."""
        i = bisect.bisect_right(starts, t)
        best = None
        for j in range(i - 1, max(-1, i - 65), -1):
            name, s, e = self.host[j]
            if e >= t and (best is None or e - s < best[1]):
                best = (name, e - s)
        return best[0] if best else "host: outside any operation"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time
        between device operations by the host operation running then."""
        ops = defaultdict(int)
        for n, s, e in self.device:
            ops[n] += e - s
        starts = [s for _, s, _ in self.host]
        gaps = defaultdict(int)
        for a, b in self._gaps():
            gaps[self._host_label(starts, (a + b) // 2)] += b - a
        gaps["window edges"] = max(
            0, round(self.window_s * 1e9) - round(self.busy_s() * 1e9)
            - sum(gaps.values()))

        def best(d):
            return [[k, v / 1e9] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": best(ops), "idle_gaps": best(gaps)}


def read_idle(ctx):
    """The reader of the ``idle.*`` metrics: the share of the traced window
    in which no operation ran on the device, in %."""
    trace = ctx["trace"]
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)


def _raw_events(prof):
    """(name, is_device, start_ns, end_ns) of every event the profiler
    kept, from its raw kineto results."""
    from torch.autograd import DeviceType

    for ev in prof.profiler.kineto_results.events():
        if hasattr(ev, "start_ns"):
            s, d = ev.start_ns(), ev.duration_ns()
        else:
            s, d = ev.start_us() * 1000, ev.duration_us() * 1000
        # annotations mirrored on the device's timeline are no operations
        if d <= 0 or (hasattr(ev, "is_user_annotation")
                      and ev.is_user_annotation()):
            continue
        yield ev.name(), ev.device_type() != DeviceType.CPU, s, s + d


class Window:
    def __init__(self, seconds: float, *, trace: bool = False,
                 trace_seconds: float = 0.0, on_cuda: bool = True):
        self.seconds = float(seconds)
        self.trace = trace
        self.trace_seconds = min(float(trace_seconds), self.seconds)
        self.on_cuda = on_cuda
        self.t0 = None
        self.t_trace = None            # (start, stop) host times, traced
        self._prof = None
        self._running = False
        self._lock = threading.Lock()
        self._asked = threading.Event()
        self._request = False

    def _profile(self):
        """A profiler of the device and of the host's operations on every
        thread (the shard's serve loop and the Task Server's workers run
        off the main thread), where this torch can record them all."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.on_cuda else [])
        try:
            from torch._C._profiler import _ExperimentalConfig
            every_thread = {"experimental_config": _ExperimentalConfig(
                profile_all_threads=True)}
        except (ImportError, TypeError):
            every_thread = {}
        return profile(activities=acts, **every_thread)

    def prepare(self) -> None:
        """In a traced run, start and stop the profiler once on the main
        thread during set-up, so that its first start in the window does
        not pay the tracer's initialisation."""
        if self.trace:
            with self._profile():
                pass

    def open(self) -> float:
        self.t0 = time.perf_counter()
        return self.t0

    @property
    def deadline(self) -> float:
        return self.t0 + self.seconds

    def expired(self) -> bool:
        return time.perf_counter() >= self.deadline

    def _due(self) -> bool:
        if self.t0 is None:
            return False
        now = time.perf_counter()
        if not self._running:
            return self.t_trace is None and (
                now >= self.deadline - self.trace_seconds)
        return now >= self.deadline

    def _act(self) -> None:
        with self._lock:
            if not self._due():
                return
            if not self._running:
                self._prof = self._profile()
                self._prof.start()
                self._running = True
                self.t_trace = (time.perf_counter(), None)
            else:
                self._stop()

    def boundary(self) -> None:
        """Start or stop the profiler of a traced run; call only where the
        device has finished the work issued before. The profiler starts
        and stops on the main thread: another thread asks for it and waits
        until the main thread's ``service()`` has acted (at most 2 s)."""
        if not self.trace or not self._due():
            return
        if threading.current_thread() is threading.main_thread():
            self._act()
            return
        self._asked.clear()
        self._request = True
        self._asked.wait(timeout=2.0)

    def service(self) -> None:
        """The main thread's side of ``boundary()`` from another thread."""
        if self._request:
            self._request = False
            self._act()
            self._asked.set()

    def _stop(self) -> None:
        t_end = time.perf_counter()
        self._prof.stop()
        self._running = False
        self.t_trace = (self.t_trace[0], t_end)

    def in_untraced_part(self, t: float) -> bool:
        """Whether host time ``t`` lies in the window before the profiler
        started (all of the window in an untraced run)."""
        start = self.t_trace[0] if self.t_trace else float("inf")
        return self.t0 <= t < min(start, self.deadline)

    def in_traced_part(self, t: float) -> bool:
        """Whether host time ``t`` lies in the part the profiler traced."""
        return bool(self.t_trace and self.t_trace[1] is not None
                    and self.t_trace[0] <= t < self.t_trace[1])

    def untraced_seconds(self) -> float:
        start = self.t_trace[0] if self.t_trace else self.deadline
        return min(start, self.deadline) - self.t0

    def finish(self):
        """Stop the profiler if it still runs and reduce its events; None
        in an untraced run or where the profiler never started."""
        with self._lock:
            if self._prof is None:
                return None
            if self._running:
                self._stop()
            prof, self._prof = self._prof, None
        device, host = [], []
        for name, is_dev, s, e in _raw_events(prof):
            (device if is_dev else host).append((name, s, e))
        device.sort(key=lambda x: x[1])
        host.sort(key=lambda x: x[1])
        return DeviceTrace(self.t_trace[1] - self.t_trace[0], device, host)
