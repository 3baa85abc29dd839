"""The idempotent-op registry behind reconnect-resend (``retry=True``).

``FrameClient.request(..., retry=True)`` reconnects and resends a frame
whose connection died mid-exchange.  That is only sound for ops whose
resend cannot change server state or mis-answer the caller -- the op may
already have been applied before the connection died.  Every op named at
a ``retry=True`` call site must appear here with a one-line justification;
the ``idempotent-retry-registry`` fabriclint pass enforces it, replacing
the ad-hoc ``# retry=True is safe: ...`` comments that previously carried
this argument at each site.

Deliberately ABSENT (their call sites must not pass ``retry=True``):

- ``put`` / ``vs_put`` / ``vs_release`` / ``claim`` -- may have been
  applied before the drop; a resend double-applies or answers the
  rightful first claimant False.
- ``get`` -- a leased dequeue.  A dropped response merely strands a
  lease that expires and redelivers; a resend would fetch *different*
  envelopes under a second lease and hide the failure.
- ``renew`` / ``ack`` -- a lost renew is healed by the next heartbeat
  tick; acks are restored to the pending set and ride the next frame.
- ``backup`` -- a resend of an applied straggler clone enqueues a
  *second* clone; harmless (claim dedup) but wasteful, and the
  straggler timer re-fires on its own if the first send truly died.
- ``cancel`` -- fused claim: an applied-then-dropped cancel's resend
  would answer ``won=False`` to the rightful first canceller, who
  would then skip its own bookkeeping for a cancel that *did* land.
- ``put_stream`` -- an observation publish; a resend could
  double-publish the observation under the same seq.  Observations are
  advisory (no claim, no lease), so losing one to a dropped connection
  is cheaper than duplicating it.
"""

IDEMPOTENT_OPS = {
    # broker ops (transport/proc.py, cluster/federation.py)
    "len": "read-only queue-depth probe; a resend cannot change state",
    "wake": "epochs only ever bump; waking twice == waking once",
    "snapshot": "read-only serialization of broker state",
    "restore": "wholesale state replacement; the same snapshot twice "
               "converges to the same state",
    "endpoints": "read-only topology advertisement (peer map, partition, "
                 "machine, shm scope)",
    # value-server shard ops (transport/shards.py, cluster/launcher.py)
    "vs_ring": "read-only fetch of the current ring message",
    "vs_set_ring": "epoch-guarded install; shards keep the max epoch, so "
                   "a resend of an applied ring is a no-op",
    "vs_get": "read-only payload fetch",
    "vs_size_of": "read-only size probe",
    "vs_contains": "read-only membership probe",
    "vs_delete": "deleting an absent key is a no-op; a resend of an "
                 "applied delete converges",
    "vs_keys": "read-only key inventory",
    "vs_export": "read-only dump of one key's stored bytes + refcount",
    "vs_expect": "epoch-guarded set union of incoming-key announcements; "
                 "a resend converges to the same window",
    "vs_end_expect": "epoch-guarded clear of the expect window; clearing "
                     "twice == clearing once",
    "vs_snapshot": "read-only serialization of one shard's contents",
    "vs_stats": "read-only counter probe",
    "cancelled": "read-only membership probe of the bounded cancelled-id "
                 "window; a resend cannot change state",
    # observability ops (transport/broker.py; see repro/observability)
    "clock_sync": "read-only monotonic-clock probe; the caller keeps only "
                  "the min-RTT round, so a resend merely adds a sample",
    "stats_scrape": "read-only queue-depth/lease/metrics snapshot "
                    "(lease expiry it piggybacks is itself idempotent)",
}
