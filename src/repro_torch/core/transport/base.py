"""Transport interface: channels of single-pickle envelopes.

An ``Envelope`` is what physically traverses a queue hop: the enqueue
timestamp (for queue-transit measurement), the message's single pickle,
and the sender-side measurements the receiver grafts onto the message's
Timer.  Backends differ only in *where* the envelope waits: an in-process
deque (``local``) or a broker process reached over a socket (``proc``).
"""
from __future__ import annotations

import pickle
import threading
from collections import deque
from typing import List, NamedTuple, Optional

SNAPSHOT_VERSION = 1


def dump_snapshot(queues: list, claims_maxlen: int, claims_order: list,
                  cancelled_maxlen: int = 0, cancelled_order: list = (),
                  ) -> bytes:
    """Shared snapshot wire format for both backends.  ``queues`` is a
    list of ``(topic, kind, epoch, items, leases)`` with ``items`` a list
    of ``(t_put, meta, data)`` and ``leases`` a list of ``(lease_id,
    duration, items)``.  Callers pass queues sorted by (topic, kind) and
    leases sorted by id so identical state always produces identical
    bytes (no wall-clock values are stored).  ``cancelled_*`` carries the
    preemption window: a cancelled id must stay cancelled across
    checkpoint/resume, or a restored stale envelope of a cancelled task
    would re-execute work the Thinker already culled (readers use
    ``state.get("cancelled")`` -- pre-cancel snapshots simply lack it)."""
    state = {"version": SNAPSHOT_VERSION, "queues": queues,
             "claims": {"maxlen": claims_maxlen, "order": claims_order},
             "cancelled": {"maxlen": cancelled_maxlen,
                           "order": list(cancelled_order)}}
    return pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)


def load_snapshot(data: bytes) -> dict:
    state = pickle.loads(data)
    if state.get("version") != SNAPSHOT_VERSION:
        raise ValueError(
            f"unsupported snapshot version {state.get('version')!r}")
    return state


def snapshot_id_sets(state: dict) -> tuple:
    """(all_ids, result_ids, claimed_ids) of a parsed snapshot: every
    task id riding an envelope meta (queued + leased), the subset found
    on ``results``-kind queues, and the claim window.  Building blocks
    of ``derive_active``."""
    all_ids: set = set()
    result_ids: set = set()
    for _topic, kind, _epoch, items, leases in state["queues"]:
        metas = [meta for _t, meta, _d in items]
        for _lid, _dur, lease_items in leases:
            metas.extend(meta for _t, meta, _d in lease_items)
        for meta in metas:
            tid = meta.get("task_id")
            if tid is not None:
                all_ids.add(tid)
                if kind == "results":
                    result_ids.add(tid)
    return all_ids, result_ids, set(state["claims"]["order"])


def derive_active(states: list) -> int:
    """The still-unfinished task count of one or more parsed snapshots
    (a federation contributes one per member; the sets must be unioned
    *before* subtracting, because a stale envelope and the claim that
    obsoletes it can live on different members).  This is how a
    broker-side auto-snapshot, which has no application around to
    record an active count, gets one derived at resume time.

    Not every captured envelope is live work: a worker acks its
    dispatch lease only after publishing (the ack may still be
    piggyback-pending when the snapshot fires), so a snapshot can image
    a lease for a task whose result was already consumed.  Counting it
    would make a resumed ``wait_until_done`` hang forever -- the
    redelivered re-execution loses the restored claim and never
    delivers.  The tell: the id is **claimed but no result envelope is
    queued anywhere** (the claim is fused with the result enqueue, so
    claimed-and-absent means consumed).  Such ids are excluded; their
    stale envelopes redeliver, re-execute, and are swallowed by the
    claim window, exactly as in a live fabric."""
    all_ids: set = set()
    result_ids: set = set()
    claimed: set = set()
    for state in states:
        a, r, c = snapshot_id_sets(state)
        all_ids |= a
        result_ids |= r
        claimed |= c
    return len(all_ids - (claimed - result_ids))


class BoundedIdSet:
    """Insertion-ordered set with a capacity cap (oldest ids age out one
    at a time).  Shared by the Task Server's straggler dedup window and
    both transports' ``claim`` arbitration, so the eviction semantics
    can never drift apart."""

    def __init__(self, maxlen: int):
        self.maxlen = maxlen
        self._order: deque = deque()
        self._set: set = set()

    def add(self, item) -> None:
        if item in self._set:
            return
        self._set.add(item)
        self._order.append(item)
        while len(self._order) > self.maxlen:
            self._set.discard(self._order.popleft())

    def claim(self, item) -> bool:
        """Atomic-within-the-caller's-lock test-and-add: True for exactly
        the first claimant of ``item`` inside the window."""
        if item in self._set:
            return False
        self.add(item)
        return True

    def __contains__(self, item) -> bool:
        return item in self._set

    def __len__(self) -> int:
        return len(self._order)


class BoundedDict:
    """Insertion-ordered dict with BoundedIdSet's sliding-window eviction
    (oldest *keys* age out one at a time past ``maxlen``).  Used where a
    per-task diagnostic map must not grow without bound over a long
    campaign (e.g. the process pool's ``task_history``)."""

    def __init__(self, maxlen: int):
        self.maxlen = maxlen
        self._order: deque = deque()
        self._data: dict = {}

    def _admit(self, key) -> None:
        self._order.append(key)
        while len(self._order) > self.maxlen:
            self._data.pop(self._order.popleft(), None)

    def __setitem__(self, key, value) -> None:
        if key not in self._data:
            self._admit(key)
        self._data[key] = value

    def setdefault(self, key, default):
        if key not in self._data:
            self[key] = default
        return self._data[key]

    def get(self, key, default=None):
        return self._data.get(key, default)

    def __getitem__(self, key):
        return self._data[key]

    def __contains__(self, key) -> bool:
        return key in self._data

    def __len__(self) -> int:
        return len(self._data)

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()


class Envelope(NamedTuple):
    t_put: float            # enqueue time (queue-transit measurement)
    data: bytes             # the single pickle of the message
    meta: dict              # sender-side measurements grafted on receive


class Channel:
    """One direction of one topic (requests or results).

    Delivery is **lease-based** (at-least-once): a ``get_batch`` does not
    destroy the dequeued envelopes -- they move to an in-flight ledger
    under a lease held by the receiving thread, and only an ``ack``
    removes them for good.  A lease that is never acked (consumer death,
    dropped response frame) expires after the transport's
    ``lease_timeout`` and its envelopes are requeued for redelivery, so
    no failure between dequeue and handoff can lose a task.  Consumers
    ack *after* the work is safely handed off (result published, batch
    relayed downstream); acks are piggybacked on the next frame so the
    hot path stays one round-trip per batch.  Calling ``get_batch``
    again on the same thread implicitly acks the previous still-held
    lease (the poll-is-commit backstop), so naive drain loops keep their
    pre-lease semantics.  Redelivery can race a slow-but-alive original
    consumer; publishers that must be exactly-once dedup via
    ``put(..., claim=task_id)``.
    """

    def put(self, env: Envelope, claim: Optional[str] = None) -> bool:
        """Enqueue an envelope.  When ``claim`` is given, the enqueue is
        fused with an atomic first-claim of that id: the envelope is only
        enqueued (and True returned) for the first claimant -- losing
        duplicates are swallowed in the same operation, leaving no window
        where an id is claimed but its envelope was never published."""
        raise NotImplementedError

    def get(self, timeout: Optional[float] = None,
            cancel: Optional[threading.Event] = None) -> Optional[Envelope]:
        batch = self.get_batch(1, timeout=timeout, cancel=cancel)
        return batch[0] if batch else None

    def get_batch(self, max_n: int, timeout: Optional[float] = None,
                  cancel: Optional[threading.Event] = None
                  ) -> List[Envelope]:
        raise NotImplementedError

    def ack(self, flush: bool = False) -> None:
        """Acknowledge this thread's held lease: the envelopes of the
        last ``get_batch`` are safely handed off and must never be
        redelivered.  Normally the ack piggybacks on the next outgoing
        frame (zero extra round-trips); ``flush=True`` forces it onto
        the wire immediately (e.g. right before a worker exits)."""
        raise NotImplementedError

    def held_lease(self) -> Optional[int]:
        """The lease id of this thread's last unacked ``get_batch``
        (None when nothing is held).  Consumers that execute for longer
        than ``lease_timeout`` read it here to hand to a heartbeat
        thread that keeps the lease alive via ``renew``."""
        raise NotImplementedError

    def detach_lease(self) -> Optional[int]:
        """Take over lease lifetime management: return the calling
        thread's held lease id and clear it, so the next ``get_batch``
        on this thread does NOT implicitly commit it (the poll-is-commit
        backstop only covers leases the thread still holds).  The caller
        becomes responsible for eventually ``ack_lease``-ing the id (or
        letting it expire and redeliver).  This is what lets a single
        intake thread keep draining while earlier batches are still
        executing -- e.g. an inference shard admitting new requests
        between decode steps of in-flight micro-batches."""
        raise NotImplementedError

    def ack_lease(self, lease_id: Optional[int],
                  flush: bool = False) -> None:
        """Acknowledge an explicit (detached) lease id: its envelopes
        are safely handed off and must never be redelivered.  Leases are
        addressed by (topic, kind, id), so any thread of the channel may
        ack them.  ``lease_id=None`` is a no-op; acking an id that
        already expired is a no-op (the redelivered re-execution will be
        deduped by the publisher's claim)."""
        raise NotImplementedError

    def renew(self, lease_id: Optional[int] = None) -> bool:
        """Extend a lease's expiry by another full ``lease_timeout``
        from now.  ``lease_id=None`` renews the calling thread's held
        lease.  Returns False when the lease no longer exists (already
        acked, or expired and redelivered -- too late: the renewal lost
        the race, and the claim fused into the result publish is what
        dedups the re-execution).  Long-running consumers renew at
        roughly half the lease timeout so tasks that legitimately
        outlive it never trigger a wasteful redelivery."""
        raise NotImplementedError

    def backup(self, lease_id: int, task_id: str,
               meta_update: dict) -> bool:
        """Clone one envelope of a live lease back onto the queue, with
        ``meta_update`` (placement hints like ``exclude_host``) merged
        into the copy's meta and ``backup=True`` set.  This is the
        straggler-mitigation primitive for the direct-subscription data
        plane: the supervisor never holds envelope bytes, but the lease
        ledger does -- so a backup is scheduled *where the original
        lives*, addressed by (lease_id, task_id).  The original lease is
        untouched (the slow consumer may still win); first completion
        arbitrates through the publish-fused claim as always.  Returns
        False when the lease is gone (acked or expired -- a backup is
        moot either way)."""
        raise NotImplementedError

    def wake(self) -> None:
        """Nudge every blocked consumer (shutdown/cancel propagation)."""
        raise NotImplementedError

    def cancel(self, task_id: str) -> bool:
        """Preempt a task by id (call on the topic's ``requests``
        channel).  Atomically: **claims** the id (so a racing completion
        dedups through the same fused put-claim path -- exactly one of
        cancel/complete wins), records it in the cancelled window,
        destroys every queued copy of the task (original, retry requeue,
        straggler backup clone -- unlinking any shm payload segments),
        strips it out of live leases (revoking in-flight delivery: the
        executing worker's eventual ack/expiry no longer requeues it),
        and wakes parked getters so freed capacity is re-steered
        immediately.  Returns True when this cancel won the claim; False
        when the id was already claimed (completion beat the cancel --
        the result is or will be delivered) or already cancelled.
        Signalling the *executing* worker is cooperative and rides on
        top: ``put_stream``/``is_cancelled`` answer "cancelled" and the
        worker aborts at its next observation or heartbeat."""
        raise NotImplementedError

    def put_stream(self, env: Envelope, task_id: str) -> bool:
        """Publish a mid-task observation onto this topic's ``stream``
        lane, fused with a cancellation probe: when ``task_id`` is
        already cancelled the observation is dropped and True is
        returned (the worker's cue to abort), else it is enqueued for
        the Thinker's ``process_intermediate`` drain and False is
        returned.  Observations ride under the task's lease -- they are
        advisory partials, so the stream lane itself needs no claims."""
        raise NotImplementedError

    def is_cancelled(self, task_id: str) -> bool:
        """Read-only probe of the cancelled window (idempotent; safe to
        retry).  Pool-worker heartbeats poll this between renews so a
        cancel reaches a worker that publishes no observations."""
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError


class Transport:
    """Factory of channels plus fabric-wide control operations."""

    name = "base"
    #: seconds before an unacked lease expires and its envelopes requeue.
    #: Must exceed the longest consumer hold (a pool worker holds its
    #: dispatch lease for the task's full execution); premature expiry is
    #: *safe* (claim dedups the raced completions) but wasteful.
    lease_timeout: float = 30.0

    def channel(self, topic: str, kind: str) -> Channel:
        raise NotImplementedError

    def wake_all(self) -> None:
        raise NotImplementedError

    def claim(self, task_id: str) -> bool:
        """Atomic first-completion claim (straggler-race dedup across
        processes).  Returns True for exactly one claimant per id.
        Prefer ``Channel.put(env, claim=id)`` which fuses the claim with
        the publish; this standalone op remains for callers that need
        the arbitration without an enqueue."""
        raise NotImplementedError

    def snapshot(self) -> bytes:
        """Serialize every queue's state -- queued envelopes, in-flight
        leases (as durations, so the bytes carry no wall-clock and a
        snapshot->restore->snapshot round-trip is byte-identical), wake
        epochs, and the claim/dedup window.  Implementations MUST
        capture all queues plus the claim window as one consistent cut
        (both backends hold the claim guard and every queue's Condition
        simultaneously): a one-queue-at-a-time capture could image a
        claim without its published result, or miss an envelope
        mid-relay between queues -- both are lost tasks after a resume,
        which checkpoint/resume's zero-loss guarantee forbids."""
        raise NotImplementedError

    def restore(self, data: bytes, expire_leases: bool = False) -> None:
        """Replace this transport's queue state with a ``snapshot``.
        By default restored in-flight leases re-arm for their full
        duration and requeue on expiry (state-faithful: a
        restore->snapshot round-trip is byte-identical).  Pass
        ``expire_leases=True`` when the previous incarnation is known
        dead (``ColmenaQueues.resume`` does): leased envelopes requeue
        immediately instead of waiting out leases nobody holds.
        Intended for a *fresh* fabric before consumers start."""
        raise NotImplementedError

    def close(self) -> None:
        """Tear down any processes/sockets owned by this transport."""
