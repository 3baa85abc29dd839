"""Single-source registry of every span and metric name the fabric emits.

Dashboards, the report's Fig.-5 decomposition table, and the chaos
trace-continuity tests all key on these names.  Instrumentation in
``core/**`` and ``serving/**`` (and, for this pass, ``apps/**`` and
``models/**``) may only use names declared here -- the
``span-name-registry`` fabriclint pass enforces it (the same
single-source pattern as ``IDEMPOTENT_OPS``), so a renamed span cannot
silently drop out of a dashboard or acceptance check.

Span names mirror the ``Timer`` interval names wherever both exist
(``serialize_request``, ``execute``, ...): the span is emitted at the
same moment, from the same measurement, as the ``timer.record`` call --
which is what makes the report's per-task span decomposition sum to the
envelope Timer totals by construction rather than by luck.
"""

# span name -> one-line description (who emits it, what it bounds)
SPAN_NAMES = {
    # -- task lifecycle (mirrors Timer intervals where named alike) ------
    "submit": "Thinker: send_task entry to transport put return",
    "serialize_request": "Thinker: task payload pickle",
    "shm_write": "producer: payload copy into a /dev/shm segment",
    "queue_wait": "broker: envelope enqueue (t_put) to lease grant",
    "shm_read": "consumer: payload map+copy out of a /dev/shm segment",
    "request_queue_transit": "worker: envelope t_put to decode "
                             "(sender/receiver clocks; same machine "
                             "shares CLOCK_MONOTONIC)",
    "deserialize_request": "worker: task payload unpickle",
    "task_started": "worker: instant marker written BEFORE execute -- a "
                    "SIGKILLed attempt leaves this and nothing after it",
    "execute": "worker: user function wall time",
    "serialize_result": "worker: result payload pickle",
    "publish_result": "worker: fused put+claim of the result envelope",
    "result_queue_transit": "Thinker: result envelope t_put to decode",
    "deserialize_result": "Thinker: result payload unpickle",
    # -- inference shard lifecycle ---------------------------------------
    "infer_queue": "shard: request enqueue to micro-batch admission",
    "prefill": "shard: the admitted group's prefill call",
    "decode": "shard: first decode step to the row's finish",
    "retire": "shard: row finish to result publish",
    # -- streaming steering (per-observation, under the task's trace) ----
    "report_intermediate": "worker: observation serialize + stream "
                           "publish (one span per observation)",
    "observation_transit": "Thinker: observation envelope t_put to decode",
    # -- layer spans (always on, the in-memory ring of trace.layer) ------
    "serve.intake": "shard: ServeLoop._intake, the channel wait included "
                    "(requests drained, groups active)",
    "serve.admit": "shard: ServeLoop._admit (requests admitted, padded "
                   "rows)",
    "serve.step": "shard: ServeLoop._step, one decode round over every "
                  "group (real and padded rows of its decode calls)",
    "engine.prefill": "Engine.prefill_batch to its first tokens on the "
                      "host (rows, length)",
    "engine.decode": "Engine.decode_batch to its tokens on the host "
                     "(rows, pos)",
    "engine.gather": "Engine.gather_rows (rows)",
    "mpnn.install": "Surrogate.load_numpy",
    "mpnn.predict": "Surrogate.predict to its host copy (molecules, "
                    "chunks, edge_bytes)",
    "mpnn.rank": "rank_space: the host UCB and argsort after predict",
    "mpnn.train": "Surrogate.train, to the loss's host read (epochs, "
                  "molecules)",
}

# metric name -> one-line description (role, kind)
METRIC_NAMES = {
    # -- broker (counters live; depth/lease gauges computed at scrape) ---
    "expired_leases": "broker counter: leases that hit their deadline",
    "redeliveries": "broker counter: envelopes requeued by lease expiry",
    "claim_rejects": "broker counter: fused put+claim lost the claim race",
    "backup_clones": "broker counter: straggler backup clones enqueued",
    "queue_depth": "broker gauge (scrape-computed): queued envelopes/topic",
    "inflight_leases": "broker gauge (scrape-computed): leased envelopes",
    "shm_segments": "broker gauge (scrape-computed): live shm segments",
    # -- pool workers ----------------------------------------------------
    "tasks_completed": "worker counter: results published",
    "task_retries": "worker counter: failed attempts requeued for retry",
    "worker_busy_frac": "worker gauge: execute wall / process uptime",
    # -- inference shards ------------------------------------------------
    "prefills": "shard counter: micro-batch prefill calls",
    "decode_steps": "shard counter: decode steps across all groups",
    "batch_occupancy": "shard histogram: admitted rows / max_batch",
    "infer_queue_delay": "shard histogram: request enqueue-to-admission (s)",
    # -- streaming steering / preemption ---------------------------------
    "tasks_cancelled": "broker counter: cancel ops that won the claim "
                       "(lease revoked, queued copies destroyed)",
    "cancel_latency": "Thinker histogram: cancel() call to broker "
                      "revocation acknowledged (s)",
    "observations": "worker counter: intermediate observations published",
    "observations_dropped": "worker counter: observations dropped because "
                            "the task was already cancelled",
    # -- models ----------------------------------------------------------
    "edge_bytes": "MPNNEnsemble.forward counter: bytes of the edge "
                  "tensors it allocated",
}

__all__ = ["SPAN_NAMES", "METRIC_NAMES"]
