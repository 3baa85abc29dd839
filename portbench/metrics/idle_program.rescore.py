"""``idle_program.rescore``: the share of the traced window in which the
device was idle while the surrogate's host code ran, in %.

As ``idle_engine.serve`` (whose interval arithmetic this reader loads), for
the gap time that an ``mpnn.*`` layer span covers (``Surrogate.load_numpy``,
``Surrogate.predict`` to its host copy, ``rank_space``'s host UCB and
argsort). The rest of ``idle.rescore`` is the benchmark's own weight nudge
between re-scores and the window's edges."""
import importlib.util
from pathlib import Path


def _engine_reader():
    path = Path(__file__).with_name("idle_engine.serve.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_idle_engine_serve_shared", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read(ctx):
    eng = _engine_reader()
    spans = eng.traced_spans(ctx, ("mpnn.",))
    if spans is None:
        return None
    trace = ctx["trace"]
    # the gaps as DeviceTrace.breakdown takes them
    return 100.0 * eng.covered_ns(trace._gaps(), spans) / (
        trace.window_s * 1e9)
