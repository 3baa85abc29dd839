"""``idle_loop.serve``: the share of the traced window in which the
device was idle while the serve loop's own host code ran, in %.

As ``idle_engine.serve`` (whose interval arithmetic this reader loads), for
the gap time that a ``serve.*`` layer span covers (``ServeLoop``'s intake
with its channel wait, admission, decode round) and no ``engine.*`` span
does. The engine's calls run inside the loop's spans, so this is the gap
time under the union of both kinds less that under the engine's."""
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
    both = eng.traced_spans(ctx, ("serve.", "engine."))
    if both is None:
        return None
    gaps = list(ctx["trace"]._gaps())   # as DeviceTrace.breakdown takes them
    engine = eng.traced_spans(ctx, ("engine.",)) or []
    covered = eng.covered_ns(gaps, both) - eng.covered_ns(gaps, engine)
    return 100.0 * covered / (ctx["trace"].window_s * 1e9)
