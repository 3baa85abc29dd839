"""Per-process trace sinks: causal task spans on one fabric timeline.

Every fabric process (Thinker, broker, pool worker, inference shard)
appends span records for *sampled* tasks to its own
``spans-<host>-<role>-<pid>.jsonl`` file under ``REPRO_OBS_DIR`` --
the proven lock-witness sink pattern: each ``O_APPEND`` write is one
whole batch of newline-terminated records, atomic at the file offset
and durable past ``os._exit``/SIGKILL.  Records are *buffered* and
flushed in batches (``FLUSH_RECORDS`` records or ``FLUSH_SECONDS``,
whichever first): per-record writes on a journaling filesystem cost
tens of microseconds each and dominated the traced dispatch floor.
A daemon flusher thread drains the buffer every ``FLUSH_SECONDS`` *off
the task path* (an extending append on a journaling fs costs ~200us
under multi-process contention -- measured dominating the traced
dispatch floor when instants wrote through inline), so crash-evidence
records like the ``task_started`` instant are on disk within one flush
period of being emitted: a SIGKILLed attempt loses at most the last
``FLUSH_SECONDS`` of records, and anything older -- including the
instant that opened the attempt, for any execution longer than the
period -- survives.  Forced final metrics snapshots (process-exit
paths) still write through.  The report
(``repro_torch.observability.report``) merges the sinks into one
Chrome-trace-event timeline.

Design constraints, in order:

- **The untraced hot path pays nothing.**  The sampling decision is
  made once per task at ``send_task`` (deterministic hash of the
  task_id against ``REPRO_OBS_SAMPLE``) and rides the envelope meta as
  ``meta["trace"] = 1``; every downstream hop emits spans only under
  that flag, so with tracing off (no ``REPRO_OBS_DIR``) zero span calls
  happen per task.
- **Fork-safe by pid check.**  The module singleton re-reads its
  environment and drops any inherited sink fd whenever ``os.getpid()``
  changes (the ``ProcTransport._after_fork`` idiom) -- forked brokers,
  workers and shards each get their own sink file.
- **Lock-free.**  No locks anywhere: the GIL makes the benign races
  harmless (two threads racing the sink-fd open end up with two fds on
  one O_APPEND file; a flush snapshots the buffer with an atomic list
  swap, so a concurrent append lands in the next batch -- or, in a
  pathological interleaving, drops one *sampled telemetry* record),
  and the lock-order witness sees no new edges.

Clock model: all span times are the emitting process's
``timing.now()`` (``perf_counter`` = CLOCK_MONOTONIC, which is
system-wide on Linux -- every process on one machine shares the
timebase).  For cross-machine alignment each process calibrates an
offset to its reference broker via the idempotent ``clock_sync`` op
(min-RTT midpoint over a few roundtrips) and records ``(ref, offset)``
in its sink's ``proc`` header line; member brokers calibrate against
the federation coordinator, so the report can compose offset chains
with the coordinator as the root of the shared timeline.
"""
from __future__ import annotations

import atexit
import itertools
import json
import os
import threading
import time
import zlib
from collections import deque
from typing import Callable, List, NamedTuple, Optional

from repro_torch.observability import metrics as _metrics
from repro_torch.utils.timing import now

ENV_DIR = "REPRO_OBS_DIR"
ENV_SAMPLE = "REPRO_OBS_SAMPLE"
ENV_HOST = "REPRO_OBS_HOST"

#: sampling rate used when tracing is enabled without an explicit rate
DEFAULT_SAMPLE = 0.1

#: batch-flush thresholds for buffered sink records: the flusher thread
#: drains every FLUSH_SECONDS; a full buffer flushes inline as backstop
FLUSH_RECORDS = 256
FLUSH_SECONDS = 0.1


class _Tracer:
    """Module singleton; all state re-derived per pid (fork safety)."""

    def __init__(self) -> None:
        self._pid = -1
        self.dir = ""
        self.sample = DEFAULT_SAMPLE
        self.host = "local"
        self.role = "app"
        self.addr = ""                  # this process's service address
        self.ref = ""                   # clock reference (broker address)
        self.offset = 0.0               # + offset maps local t -> ref t
        self._sink_fd = -1
        self._wrote_head = False
        self._last_metrics_flush = 0.0
        self._buf: list = []
        self._last_write = 0.0
        self._flusher: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------

    def _ensure(self) -> None:
        pid = os.getpid()
        if pid == self._pid:
            return
        # fresh process (first call or just forked): env is the config
        # channel across fork/exec; an inherited fd points at the
        # parent's sink and must be dropped, not closed (the parent
        # still owns it) -- and inherited buffered records belong to
        # the parent (it will flush them itself) and must be dropped
        self._pid = pid
        self._sink_fd = -1
        self._wrote_head = False
        self._last_metrics_flush = 0.0
        self._buf = []
        self._last_write = now()
        self._flusher = None            # a thread never survives fork
        self.dir = os.environ.get(ENV_DIR, "")
        if self.dir:
            # normal process exit (atexit does not run under os._exit;
            # those paths -- pool workers, shards -- force-flush
            # explicitly) drains the buffered tail
            atexit.register(flush)
        try:
            self.sample = float(
                os.environ.get(ENV_SAMPLE, "") or DEFAULT_SAMPLE)
        except ValueError:
            self.sample = DEFAULT_SAMPLE
        self.host = os.environ.get(ENV_HOST, "") or self.host or "local"
        self.addr = ""
        self.ref = ""
        self.offset = 0.0

    @property
    def enabled(self) -> bool:
        return bool(self.dir)

    def _sink_path(self) -> str:
        safe_role = self.role.replace("/", "_").replace(":", "_")
        safe_host = self.host.replace("/", "_").replace(":", "_")
        return os.path.join(
            self.dir, f"spans-{safe_host}-{safe_role}-{self._pid}.jsonl")

    def _emit(self, rec: dict, through: bool = False) -> None:
        # record dicts buffer raw; json encoding happens at flush time
        # in the flusher thread -- measured, the per-record encode on a
        # GIL-saturated thinker/broker cost more dispatch-floor wall
        # than the disk writes themselves
        self._buf.append(rec)
        if self._flusher is None:
            self._start_flusher()
        if through or len(self._buf) >= FLUSH_RECORDS:
            self.flush()

    def _start_flusher(self) -> None:
        pid = self._pid

        def loop() -> None:
            while True:
                time.sleep(FLUSH_SECONDS)
                if os.getpid() != pid:      # belt and braces vs fork
                    return
                try:
                    self.flush()
                except OSError:             # sink dir torn down under us
                    return

        th = threading.Thread(target=loop, daemon=True, name="obs-flusher")
        self._flusher = th
        th.start()

    def flush(self) -> None:
        buf, self._buf = self._buf, []      # atomic swap (GIL): lock-free
        self._last_write = now()
        if not buf:
            return
        if self._sink_fd < 0:
            os.makedirs(self.dir, exist_ok=True)
            self._sink_fd = os.open(
                self._sink_path(),
                os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        # one O_APPEND write per batch: atomic at the offset, and ~batch
        # size fewer journal commits than per-record writes
        os.write(self._sink_fd, ("\n".join(
            json.dumps(r, sort_keys=True) for r in buf) + "\n").encode())

    def _head(self) -> None:
        if self._wrote_head:
            return
        self._wrote_head = True
        self._emit({"kind": "proc", "host": self.host, "role": self.role,
                    "pid": self._pid, "addr": self.addr, "ref": self.ref,
                    "offset": self.offset, "t": now()})


_T = _Tracer()


# -----------------------------------------------------------------------
# module API (what instrumented fabric code calls)
# -----------------------------------------------------------------------


def enabled() -> bool:
    _T._ensure()
    return _T.enabled


def sample_rate() -> float:
    _T._ensure()
    return _T.sample


def obs_dir() -> str:
    _T._ensure()
    return _T.dir


def configure(role: Optional[str] = None, host: Optional[str] = None,
              addr: str = "", ref: str = "",
              offset: Optional[float] = None) -> None:
    """Identify this process on the fabric timeline.  Called once from
    each role's process main (after any env the launcher pushed has been
    applied); writes the sink's ``proc`` header line eagerly so every
    participating process is visible to the report even if it ends up
    emitting no sampled spans."""
    _T._ensure()
    if role is not None:
        _T.role = role
    if host is not None:
        _T.host = host
    if addr:
        _T.addr = addr
    if ref:
        _T.ref = ref
    if offset is not None:
        _T.offset = offset
    if _T.enabled:
        _T._head()


def sampled(trace_id: str) -> bool:
    """Deterministic per-task sampling decision: every hop that hashes
    the same id agrees, with no coordination."""
    _T._ensure()
    if not _T.dir:
        return False
    if _T.sample >= 1.0:
        return True
    if _T.sample <= 0.0:
        return False
    return (zlib.crc32(trace_id.encode()) % 10_000) < _T.sample * 10_000


def span(trace_id: str, name: str, t0: float, t1: float,
         attempt: int = 0, **args) -> None:
    """One completed interval of a sampled task's lifecycle.  Times are
    this process's local monotonic clock; the report aligns them via the
    proc-header offset."""
    _T._ensure()
    if not _T.dir:
        return
    _T._head()
    rec = {"kind": "span", "trace": trace_id, "name": name,
           "t0": t0, "t1": t1}
    if attempt:
        rec["attempt"] = attempt
    if args:
        rec["args"] = args
    _T._emit(rec)


def instant(trace_id: str, name: str, t: Optional[float] = None,
            attempt: int = 0, **args) -> None:
    """A zero-duration marker.  The flusher thread puts it on disk
    within ``FLUSH_SECONDS`` -- so for any execution longer than that,
    the ``task_started`` instant of a SIGKILLed attempt survives as the
    crash evidence: an instant with no closing span."""
    _T._ensure()
    if not _T.dir:
        return
    _T._head()
    rec = {"kind": "instant", "trace": trace_id, "name": name,
           "t": now() if t is None else t}
    if attempt:
        rec["attempt"] = attempt
    if args:
        rec["args"] = args
    _T._emit(rec)


def emit_timers(trace_id: str, intervals: dict) -> None:
    """The envelope Timer's final interval set for a sampled task, as
    seen by the result consumer.  The report checks the merged span
    decomposition sums against these totals (the acceptance bound)."""
    _T._ensure()
    if not _T.dir:
        return
    _T._head()
    _T._emit({"kind": "timers", "trace": trace_id,
              "intervals": {k: float(v) for k, v in intervals.items()}})


def flush_metrics(min_interval: float = 0.5, force: bool = False) -> None:
    """Append a cumulative metrics snapshot line, throttled.  Snapshots
    are cumulative, so losing the final window to SIGKILL costs only
    that window's delta -- everything flushed earlier is on disk."""
    _T._ensure()
    if not _T.dir:
        return
    t = now()
    if not force and t - _T._last_metrics_flush < min_interval:
        return
    _T._last_metrics_flush = t
    snap = _metrics.snapshot()
    if not any(snap.values()) and not force:
        return
    _T._head()
    # force is the process-exit path: write through so the final
    # cumulative snapshot (and any buffered span tail) reaches disk
    _T._emit({"kind": "metrics", "t": t, "data": snap}, through=force)


def flush() -> None:
    """Drain buffered sink records to disk (no-op when untraced).
    Called from fabric teardown paths -- ``ColmenaQueues.shutdown``,
    broker exit -- and registered via ``atexit`` for normal exits."""
    _T._ensure()
    if _T.dir:
        _T.flush()


def addr_str(address) -> str:
    """Canonical string form of a broker address, used for ``addr``/
    ``ref`` in proc headers so the report can match reference chains:
    a Unix socket is its path, TCP is ``host:port``."""
    if isinstance(address, bytes):
        return address.decode(errors="replace")
    if isinstance(address, str):
        return address
    try:
        if address and address[0] == "unix":
            return str(address[1])
        return f"{address[0]}:{address[1]}"
    except (TypeError, IndexError):
        return str(address)


def calibrate(sync_fn: Callable[[], float], rounds: int = 5) -> float:
    """Estimate this process's clock offset to a reference: ``sync_fn``
    performs one ``clock_sync`` roundtrip and returns the reference's
    ``now()``.  Min-RTT midpoint over ``rounds`` tries -- the shortest
    roundtrip has the least asymmetric queueing, so its midpoint is the
    best bound on where the remote read actually happened."""
    best_rtt = float("inf")
    offset = 0.0
    for _ in range(rounds):
        a = now()
        t_ref = sync_fn()
        b = now()
        rtt = b - a
        if rtt < best_rtt:
            best_rtt = rtt
            offset = t_ref - (a + rtt / 2.0)
    return offset


# -----------------------------------------------------------------------
# layer spans: an always-on, bounded in-memory ring per process
# -----------------------------------------------------------------------
#
# The sinks above hold sampled task spans and cost nothing when off.
# Layer spans are the other kind: every call of a layer boundary (the
# serve loop's intake, admit and step; the engine's calls; the
# surrogate's install, predict, rank and train) is recorded, always, in
# memory, and read in-process by whoever wants the timings -- a
# benchmark after its window, a launcher after its rounds.  A span costs
# two ``perf_counter_ns`` reads, an id and one ``deque.append``: no
# lock, no I/O, no profiler call.  The ring holds ``RING_SPANS`` spans;
# when full, the oldest go and are counted (``layer_dropped``).
#
# Clock: span times are ``time.perf_counter_ns()``.  ``clock_offset_ns``
# maps them onto the Unix epoch, which is the clock of torch.profiler's
# event times, so a reader can lay spans onto a device trace.

#: layer spans the ring holds
RING_SPANS = 1 << 18


class LayerSpan(NamedTuple):
    name: str                   # declared in observability.names
    t0: int                     # time.perf_counter_ns() at the start
    t1: int                     # ... at the end
    sid: int                    # the span's number in this process
    parent: int                 # sid of the span open around it on its
                                # thread when it started, or -1
    rid: Optional[str]          # the request it served, if one
    attrs: dict                 # a few integer attributes


class _Ring:
    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.spans: deque = deque(maxlen=RING_SPANS)
        self.ids = itertools.count()
        self.stacks: list = []          # every recording thread's open sids
        self.tls = threading.local()

    def stack(self) -> list:
        """This thread's open spans (their sids), innermost last."""
        try:
            return self.tls.open
        except AttributeError:
            stack = self.tls.open = []
            self.stacks.append(stack)
            return stack

    def issued(self) -> int:
        """Sids handed out so far; ``itertools.count`` shows its next
        value in its repr, and reading it there takes no sid."""
        return int(repr(self.ids)[len("count("):-1])


_clock = time.perf_counter_ns
_RING = _Ring()
os.register_at_fork(after_in_child=_RING.reset)  # a child's ring is its own
_OFFSET: list = []


class _Layer:
    """An open layer span: what ``layer`` returns."""

    __slots__ = ("name", "rid", "attrs", "t0", "sid", "parent", "stack")

    def __enter__(self) -> "_Layer":
        try:
            stack = self.stack = _RING.tls.open
        except AttributeError:
            stack = self.stack = _RING.stack()
        self.parent = stack[-1] if stack else -1
        self.sid = sid = next(_RING.ids)
        stack.append(sid)
        self.t0 = _clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        t1 = _clock()
        self.stack.pop()
        _RING.spans.append((self.name, self.t0, t1, self.sid, self.parent,
                            self.rid, self.attrs))


_new_layer = object.__new__


def layer(name: str, rid: Optional[str] = None, **attrs) -> _Layer:
    """One layer span around a block::

        with obs.layer("serve.step") as sp:
            ...
            sp.attrs["rows"] = n

    ``rid`` names the request served; keyword arguments start ``attrs``.
    (A function, not the class: a class's ``__init__`` with keyword
    arguments costs a few hundred ns more a span.)"""
    sp = _new_layer(_Layer)
    sp.name, sp.rid, sp.attrs = name, rid, attrs
    return sp


def layer_at(name: str, t0: int, t1: int, rid: Optional[str] = None,
             **attrs) -> None:
    """One layer span whose caller took its times (``perf_counter_ns``);
    its parent is the span open on this thread now."""
    stack = _RING.stack()
    _RING.spans.append((name, t0, t1, next(_RING.ids),
                        stack[-1] if stack else -1, rid, attrs))


def layer_spans() -> List[LayerSpan]:
    """The spans the ring holds, oldest end first."""
    return [LayerSpan._make(r) for r in list(_RING.spans)]


def layer_dropped() -> int:
    """Spans the full ring has let go since the process (or the last
    ``reset_layers``) started."""
    recorded = _RING.issued() - sum(len(st) for st in list(_RING.stacks))
    return max(0, recorded - len(_RING.spans))


def layer_complete_since(t_ns: int) -> bool:
    """Whether the ring still holds every span that ended after
    ``t_ns``: nothing was dropped, or the oldest span held ended by
    then."""
    spans = _RING.spans
    return layer_dropped() == 0 or (bool(spans) and spans[0][2] <= t_ns)


def reset_layers() -> None:
    """Empty the ring and restart its counts (tests)."""
    _RING.reset()


def clock_offset_ns() -> int:
    """``time.time_ns() - time.perf_counter_ns()``, taken once per
    process from the closest-spaced of 64 back-to-back read pairs: add
    it to a span's times to put them on the Unix epoch, the clock of
    torch.profiler's event times."""
    if not _OFFSET:
        best = None
        for _ in range(64):
            a = time.perf_counter_ns()
            w = time.time_ns()
            b = time.perf_counter_ns()
            if best is None or b - a < best[0]:
                best = (b - a, w - (a + b) // 2)
        _OFFSET.append(best[1])
    return _OFFSET[0]
