"""Fabric-wide observability: causal task traces, role metrics, and the
campaign monitor/report that merge them into one timeline.

Three layers (see the module docstrings for the full contracts):

- ``trace`` -- per-process O_APPEND jsonl span sinks; sampling decided
  once per task at submit and carried as envelope meta; clock offsets
  calibrated via the idempotent ``clock_sync`` broker op.  Beside them,
  the always-on in-memory ring of layer spans (``layer``, ``layer_at``,
  read back with ``layer_spans``; ``clock_offset_ns`` maps them onto
  the profiler's clock).
- ``metrics`` -- lock-free per-process counters/gauges/histograms,
  scraped live via the ``stats_scrape`` broker op or flushed to the
  span sinks.
- ``monitor`` / ``report`` -- the launcher-side aggregator and the
  ``python -m repro_torch.observability.report`` exporter (Chrome-trace JSON
  for Perfetto + the paper's Fig.-5 decomposition table).

Instrumented fabric code imports this package as ``obs`` by
convention::

    from repro_torch import observability as obs

    if env.meta.get("trace"):
        obs.span(task_id, "queue_wait", t_put, now(), topic=topic)
    obs.counter("expired_leases").inc()

The ``obs.span(...)``/``obs.counter(...)`` receiver-name convention is
what the ``span-name-registry`` fabriclint pass keys on: every name
literal at such a call site in ``core/**``/``serving/**`` (and
``apps/**``/``models/**``, ``obs.layer``/``obs.layer_at`` among them)
must be declared in ``observability.names``.
"""
from repro_torch.observability.metrics import (counter, gauge, histo, observe,
                                         snapshot as metrics_snapshot)
from repro_torch.observability.names import METRIC_NAMES, SPAN_NAMES
from repro_torch.observability.trace import (DEFAULT_SAMPLE, ENV_DIR, ENV_HOST,
                                       ENV_SAMPLE, addr_str, calibrate,
                                       configure, emit_timers, enabled,
                                       flush, flush_metrics, instant,
                                       obs_dir, sample_rate, sampled, span)
from repro_torch.observability.trace import (LayerSpan, clock_offset_ns,
                                             layer, layer_at,
                                             layer_complete_since,
                                             layer_dropped, layer_spans,
                                             reset_layers)

__all__ = [
    "METRIC_NAMES", "SPAN_NAMES", "DEFAULT_SAMPLE",
    "ENV_DIR", "ENV_HOST", "ENV_SAMPLE",
    "addr_str", "calibrate", "configure", "counter", "emit_timers",
    "enabled", "flush", "flush_metrics", "gauge", "histo", "instant",
    "metrics_snapshot", "obs_dir", "observe", "sample_rate", "sampled",
    "span",
    "LayerSpan", "clock_offset_ns", "layer", "layer_at",
    "layer_complete_since", "layer_dropped", "layer_spans", "reset_layers",
]
