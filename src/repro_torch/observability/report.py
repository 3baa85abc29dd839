"""Merge per-process span sinks into one campaign timeline.

``python -m repro_torch.observability.report OBS_DIR --out trace.json`` emits
a Chrome-trace-event JSON file (load it at https://ui.perfetto.dev or
chrome://tracing) where every process is a named track and every
sampled task is one ``tid`` row of its causal spans across Thinker,
broker, worker and shard processes.  ``--table`` prints the paper's
Fig.-5-style per-span decomposition (count/median/p90/total) plus any
scraped role metrics; ``--check-decomposition R`` exits nonzero unless
the merged span sums agree with the envelope Timer totals within
ratio ``R`` (the PR's acceptance bound).

Clock alignment: each sink's ``proc`` header carries ``(ref, offset)``
from ``clock_sync`` calibration -- offset maps that process's local
monotonic times onto its reference broker's clock, and member brokers
carry their own offset to the federation coordinator.  Offsets compose
along that (depth <= 2) chain, with the coordinator the root of the
shared timeline.  On one machine CLOCK_MONOTONIC is already
system-wide, so offsets are microseconds; the chain exists for the
cross-machine case.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

# span names whose measurements mirror Timer intervals: the
# decomposition check compares exactly these against the timers records
TIMER_MIRRORED = ("serialize_request", "request_queue_transit",
                  "deserialize_request", "execute", "serialize_result",
                  "result_queue_transit", "deserialize_result")


def read_sinks(obs_dir) -> Tuple[List[dict], List[dict], List[dict],
                                 List[dict]]:
    """Returns (procs, spans, timers, metrics); span/instant records are
    annotated with their emitting proc's host/role/pid.  A truncated
    final line (a writer killed mid-write; O_APPEND makes this the only
    corruption mode) is skipped, not fatal."""
    procs: List[dict] = []
    spans: List[dict] = []
    timers: List[dict] = []
    metrics: List[dict] = []
    for path in sorted(Path(obs_dir).glob("spans-*.jsonl")):
        proc: Optional[dict] = None
        for line in path.read_text().splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            kind = rec.get("kind")
            if kind == "proc":
                proc = rec
                procs.append(rec)
                continue
            if proc is not None:
                rec.setdefault("host", proc["host"])
                rec.setdefault("role", proc["role"])
                rec.setdefault("pid", proc["pid"])
            if kind in ("span", "instant"):
                spans.append(rec)
            elif kind == "timers":
                timers.append(rec)
            elif kind == "metrics":
                rec["_path"] = path.name
                metrics.append(rec)
    return procs, spans, timers, metrics


def global_offsets(procs: List[dict]) -> Dict[Tuple[str, str, int], float]:
    """(host, role, pid) -> offset onto the coordinator's clock.  A
    process's header offset maps it onto its ref broker; if that broker
    itself declares a ref (member -> coordinator), the offsets add."""
    by_addr: Dict[str, dict] = {}
    for p in procs:
        if p.get("addr"):
            by_addr[str(p["addr"])] = p
    out: Dict[Tuple[str, str, int], float] = {}
    for p in procs:
        off = float(p.get("offset", 0.0))
        ref = str(p.get("ref", "") or "")
        hops = 0
        while ref and hops < 4:                 # chain depth is <= 2 today
            parent = by_addr.get(ref)
            if parent is None or parent is p:
                break
            off += float(parent.get("offset", 0.0))
            ref = str(parent.get("ref", "") or "")
            hops += 1
        out[(p["host"], p["role"], p["pid"])] = off
    return out


def _aligned(rec: dict, offsets) -> Tuple[float, float]:
    off = offsets.get((rec.get("host"), rec.get("role"), rec.get("pid")),
                      0.0)
    if rec.get("kind") == "instant":
        t = float(rec["t"]) + off
        return t, t
    return float(rec["t0"]) + off, float(rec["t1"]) + off


def to_chrome(procs: List[dict], spans: List[dict]) -> dict:
    """Chrome trace-event JSON: one pid per fabric process (named
    ``host/role/pid``), one tid row per sampled task so its lifecycle
    reads left-to-right across process tracks."""
    offsets = global_offsets(procs)
    pids: Dict[Tuple[str, str, int], int] = {}
    events: List[dict] = []
    for p in procs:
        key = (p["host"], p["role"], p["pid"])
        if key in pids:
            continue
        pids[key] = len(pids) + 1
        events.append({"name": "process_name", "ph": "M", "pid": pids[key],
                       "tid": 0, "args": {"name": "/".join(
                           str(k) for k in key)}})
    tids: Dict[str, int] = {}
    t_zero = None
    aligned = []
    for rec in spans:
        t0, t1 = _aligned(rec, offsets)
        aligned.append((t0, t1, rec))
        if t_zero is None or t0 < t_zero:
            t_zero = t0
    for t0, t1, rec in aligned:
        key = (rec.get("host"), rec.get("role"), rec.get("pid"))
        pid = pids.setdefault(key, len(pids) + 1)
        trace = str(rec.get("trace", "?"))
        tid = tids.setdefault(trace, len(tids) + 1)
        args = {"trace": trace, "attempt": rec.get("attempt", 0)}
        args.update(rec.get("args") or {})
        ev = {"name": rec["name"], "cat": rec.get("role", "fabric"),
              "pid": pid, "tid": tid,
              "ts": (t0 - (t_zero or 0.0)) * 1e6, "args": args}
        if rec.get("kind") == "instant":
            ev.update(ph="i", s="t")
        else:
            ev.update(ph="X", dur=max(t1 - t0, 0.0) * 1e6)
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _percentile(xs: List[float], q: float) -> float:
    xs = sorted(xs)
    if not xs:
        return 0.0
    i = min(len(xs) - 1, int(q * (len(xs) - 1) + 0.5))
    return xs[i]


def decomposition_table(spans: List[dict]) -> List[tuple]:
    """(name, count, median_ms, p90_ms, total_s) per span name -- the
    Fig.-5 per-component overhead decomposition, from merged spans."""
    by_name: Dict[str, List[float]] = {}
    for rec in spans:
        if rec.get("kind") != "span":
            continue
        by_name.setdefault(rec["name"], []).append(
            float(rec["t1"]) - float(rec["t0"]))
    rows = []
    for name in sorted(by_name):
        ds = by_name[name]
        rows.append((name, len(ds), _percentile(ds, 0.5) * 1e3,
                     _percentile(ds, 0.9) * 1e3, sum(ds)))
    return rows


def check_decomposition(spans: List[dict], timers: List[dict],
                        max_drift: float = 0.1) -> Tuple[int, int, float]:
    """Per sampled task: sum of Timer-mirrored span durations vs the sum
    of the envelope Timer's matching intervals.  Spans are emitted from
    the same measurements as ``timer.record``, so agreement is
    structural; drift beyond ``max_drift`` means an instrumentation hop
    dropped or double-emitted a span.  Returns (checked, failed,
    worst_drift); traces with under 10 ms of accounted time are skipped
    (relative drift on microsecond sums is noise, not signal)."""
    span_sum: Dict[str, float] = {}
    for rec in spans:
        if rec.get("kind") == "span" and rec["name"] in TIMER_MIRRORED:
            span_sum[str(rec["trace"])] = (
                span_sum.get(str(rec["trace"]), 0.0)
                + float(rec["t1"]) - float(rec["t0"]))
    checked = failed = 0
    worst = 0.0
    for rec in timers:
        trace = str(rec["trace"])
        want = sum(float(v) for k, v in rec["intervals"].items()
                   if k in TIMER_MIRRORED)
        got = span_sum.get(trace)
        if got is None or want < 0.010:
            continue
        checked += 1
        drift = abs(got - want) / want
        worst = max(worst, drift)
        if drift > max_drift:
            failed += 1
    return checked, failed, worst


def summarize_metrics(metrics: List[dict]) -> Dict[str, dict]:
    """Last cumulative snapshot per sink file, merged: counters sum
    across processes, gauges report the last value per process."""
    last: Dict[str, dict] = {}
    for rec in metrics:
        last[rec["_path"]] = rec            # jsonl order = time order
    counters: Dict[str, int] = {}
    gauges: Dict[str, list] = {}
    for rec in last.values():
        data = rec.get("data", {})
        for k, v in data.get("counters", {}).items():
            counters[k] = counters.get(k, 0) + v
        for k, v in data.get("gauges", {}).items():
            gauges.setdefault(k, []).append(v)
    return {"counters": counters, "gauges": gauges}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.observability.report",
        description="merge span sinks; export a Perfetto-loadable "
                    "Chrome-trace timeline and the Fig.-5 table")
    ap.add_argument("obs_dir", type=Path, help="REPRO_OBS_DIR of the run")
    ap.add_argument("--out", type=Path, default=None,
                    help="write Chrome trace-event JSON here")
    ap.add_argument("--table", action="store_true",
                    help="print the per-span decomposition table")
    ap.add_argument("--check-decomposition", type=float, default=None,
                    metavar="R", help="fail if any task's span sum "
                    "drifts more than R from its Timer totals")
    args = ap.parse_args(argv)

    procs, spans, timers, metrics = read_sinks(args.obs_dir)
    hosts = sorted({p["host"] for p in procs})
    roles = sorted({p["role"] for p in procs})
    n_traces = len({str(r.get("trace")) for r in spans})
    print(f"{len(procs)} process(es) on {len(hosts)} host(s) "
          f"{hosts}, roles {roles}; {len(spans)} span/instant record(s) "
          f"across {n_traces} sampled task(s)")

    if args.out is not None:
        args.out.write_text(json.dumps(to_chrome(procs, spans)))
        print(f"wrote {args.out} ({args.out.stat().st_size} bytes) -- "
              "load it at https://ui.perfetto.dev")

    if args.table:
        rows = decomposition_table(spans)
        if rows:
            w = max(len(r[0]) for r in rows)
            print(f"\n{'span':<{w}}  {'count':>6}  {'median':>9}  "
                  f"{'p90':>9}  {'total':>9}")
            for name, n, med, p90, tot in rows:
                print(f"{name:<{w}}  {n:>6}  {med:>7.3f}ms  "
                      f"{p90:>7.3f}ms  {tot:>8.3f}s")
        summary = summarize_metrics(metrics)
        if summary["counters"]:
            print("\ncounters (summed across processes):")
            for k, v in sorted(summary["counters"].items()):
                print(f"  {k}: {v}")
        for k, vs in sorted(summary["gauges"].items()):
            print(f"  {k}: {['%.3g' % v for v in vs]}")

    if args.check_decomposition is not None:
        checked, failed, worst = check_decomposition(
            spans, timers, args.check_decomposition)
        print(f"\ndecomposition check: {checked} task(s) checked, "
              f"{failed} beyond {args.check_decomposition:.0%} drift "
              f"(worst {worst:.1%})")
        if checked == 0:
            print("decomposition check: no checkable tasks "
                  "(need sampled tasks with >=10ms accounted time)")
            return 1
        if failed:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
