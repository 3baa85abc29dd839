"""``idle_engine.serve``: the share of the traced window in which the
device was idle while the engine's host code ran, in %.

The idle time is the gaps between device operations, as
``DeviceTrace.breakdown`` takes them (the window's edges are not gaps). The
part of each gap that an ``engine.*`` layer span of the program covers
(``Engine.prefill_batch``, ``decode_batch``, ``gather_rows``; the program's
in-memory ring, put onto the profiler's clock by
``observability.clock_offset_ns``) is summed and divided by the traced
window. None where the trace holds no device operation, where no such span
overlaps the traced part, where the ring dropped spans of the window, or
where the program keeps no ring."""


def covered_ns(gaps, spans) -> int:
    """Nanoseconds of the sorted, disjoint ``gaps`` that the union of
    ``spans`` ((start, end) pairs) covers."""
    merged: list = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    total = j = 0
    for a, b in gaps:
        while j < len(merged) and merged[j][1] <= a:
            j += 1
        k = j
        while k < len(merged) and merged[k][0] < b:
            total += min(b, merged[k][1]) - max(a, merged[k][0])
            k += 1
    return total


def traced_spans(ctx, prefixes):
    """The program's layer spans whose name starts with one of
    ``prefixes`` and that overlap the traced part, as (start, end) on the
    profiler's clock; None where there is nothing to read."""
    from repro_torch import observability as obs

    trace, win = ctx["trace"], ctx["win"]
    if (trace is None or not trace.device or not win.t_trace
            or win.t_trace[1] is None or not hasattr(obs, "layer_spans")):
        return None
    start, stop = (round(t * 1e9) for t in win.t_trace)
    if not obs.layer_complete_since(start):
        return None
    off = obs.clock_offset_ns()
    spans = [(s.t0 + off, s.t1 + off) for s in obs.layer_spans()
             if s.name.startswith(prefixes) and s.t1 > start and s.t0 < stop]
    return spans or None


def read(ctx):
    spans = traced_spans(ctx, ("engine.",))
    if spans is None:
        return None
    trace = ctx["trace"]
    # the gaps as DeviceTrace.breakdown takes them
    return 100.0 * covered_ns(trace._gaps(), spans) / (trace.window_s * 1e9)
