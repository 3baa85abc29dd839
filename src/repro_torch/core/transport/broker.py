"""The broker process: owner of every per-topic request/result queue.

One broker serves all queue channels of a fabric over a single listening
socket.  Clients (Thinker process, Task Server intake threads, pool
workers) speak the frame protocol of ``frames.py``; the broker keeps a
``deque`` + ``Condition`` per (topic, kind) -- the same event-driven
structure as the local backend, just on the other side of a socket:

- ``put``  appends the sender's envelope bytes verbatim and notifies one
  parked getter (payloads are relayed, never unpickled).  A ``claim`` id
  in the header fuses an atomic first-completion claim with the enqueue:
  only the first claimant's envelope is published, so there is no window
  where an id is claimed but its result died with the claimant.
- ``get``  parks the connection's handler thread on the queue Condition
  until items arrive, the wake epoch bumps, or the timeout lapses; up to
  ``max_n`` envelopes come back concatenated in one response frame.
  The dequeue is **leased**, not destructive: the envelopes move to the
  queue's in-flight ledger under a lease id returned with the response,
  and only an ``ack`` deletes them.  An unacked lease (consumer death, a
  response frame lost with its connection) expires after its duration
  and the envelopes are requeued at the front -- parked getters bound
  their waits by the earliest lease deadline and run the expiry
  themselves, so redelivery needs no sweeper thread.
- ``ack``  releases leases.  Acks almost never arrive as their own
  frame: every request header may carry a piggybacked ``acks`` list that
  is applied before the op, so consumers commit their previous batch on
  the frame they were sending anyway.
- ``wake`` bumps every queue's epoch and notifies all -- pending gets
  return (possibly empty) so client-side cancel events propagate without
  any polling loop.
- ``claim`` is the standalone first-completion test-and-set (kept for
  callers that need arbitration without an enqueue; result publication
  uses the fused put-with-claim above).
- ``snapshot`` / ``restore`` serialize / replace the broker's whole
  state: queued + in-flight envelopes, lease durations (never wall-clock
  deadlines, so identical state gives identical bytes), wake epochs, and
  the claim window.  This is what campaign-level checkpointing rides on.

The listening socket is bound in the *parent* before forking the broker
process, so there is no readiness race: by the time the constructor
returns the address is connectable.
"""
from __future__ import annotations

import os
import socket as socketlib
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

from repro_torch import observability as obs
from repro_torch.core.transport import frames, shm
from repro_torch.core.transport.base import (BoundedIdSet, dump_snapshot,
                                       load_snapshot)
from repro_torch.utils.timing import now


class _BrokerQueue:
    def __init__(self):
        self.items: deque = deque()        # (t_put, meta, data)
        self.cond = threading.Condition()
        self.epoch = 0
        # lease_id -> (duration, deadline, [(t_put, meta, data), ...]);
        # all access under self.cond.  Lease ids are per-queue, so an ack
        # addresses (topic, kind, lease_id) and needs no broker-global
        # index (and no second lock on the get hot path).
        self.leases: Dict[int, Tuple[float, float, list]] = {}
        self.next_lease = 0


class Broker:
    def __init__(self, claim_window: int = 1 << 16,
                 shm_scope: Optional[str] = None):
        self._queues: Dict[Tuple[str, str], _BrokerQueue] = {}
        self._qlock = threading.Lock()
        self._claimed = BoundedIdSet(claim_window)
        self._claim_lock = threading.Lock()
        # preempted ids: written under _claim_lock (cancel, restore);
        # membership reads on hot paths are lock-free (GIL-atomic set
        # probes -- a racing cancel is caught at the next probe)
        self._cancelled = BoundedIdSet(claim_window)
        # the fabric's shared-memory scope token: advertised to clients
        # via the ``endpoints`` op so producers name their segments under
        # it (and teardown can sweep exactly this fabric's leftovers)
        self.shm_scope = shm_scope

    def _queue(self, topic: str, kind: str) -> _BrokerQueue:
        with self._qlock:
            q = self._queues.get((topic, kind))
            if q is None:
                q = self._queues[(topic, kind)] = _BrokerQueue()
            return q

    # -- lease plumbing (call with q.cond held) -----------------------------

    @staticmethod
    def _expire_locked(q: _BrokerQueue) -> None:
        if not q.leases:
            return
        tnow = now()
        expired = [lid for lid, (_, deadline, _) in q.leases.items()
                   if deadline <= tnow]
        if not expired:
            return
        obs.counter("expired_leases").inc(len(expired))
        for lid in expired:
            _, _, items = q.leases.pop(lid)
            obs.counter("redeliveries").inc(len(items))
            for t_put, meta, data in reversed(items):
                meta = dict(meta)
                meta["redelivered"] = meta.get("redelivered", 0) + 1
                q.items.appendleft((t_put, meta, data))
        q.cond.notify_all()

    @staticmethod
    def _next_lease_deadline_locked(q: _BrokerQueue) -> Optional[float]:
        if not q.leases:
            return None
        return min(deadline for _, deadline, _ in q.leases.values())

    # -- ops ----------------------------------------------------------------

    def put(self, topic: str, kind: str, t_put: float, meta: dict,
            data: bytes, claim: Optional[str] = None,
            shm_desc: Optional[dict] = None) -> bool:
        if shm_desc is not None:
            # the payload rides shared memory: ownership of the segment
            # transferred to this broker with the frame.  It is carried
            # in the envelope meta (so lease expiry redelivers it) and
            # unlinked when the envelope is destroyed (ack / rejected
            # claim / restore / shutdown).
            meta = dict(meta)
            meta["_shm"] = shm_desc
        q = self._queue(topic, kind)
        if claim is not None:
            # the claim lock is held ACROSS the enqueue (lock order:
            # claim_lock -> q.cond, same as snapshot) so a snapshot can
            # never capture the claim without its result -- that image
            # would dedup the redelivered re-execution and lose the task
            with self._claim_lock:
                if not self._claimed.claim(claim):
                    if shm_desc is not None:
                        shm.unlink_segment(shm_desc)
                    obs.counter("claim_rejects").inc()
                    return False            # duplicate publisher: swallowed
                with q.cond:
                    q.items.append((t_put, meta, data))
                    q.cond.notify()
            return True
        with q.cond:
            q.items.append((t_put, meta, data))
            q.cond.notify()
        return True

    def get(self, topic: str, kind: str, max_n: int,
            timeout: Optional[float], last_epoch: Optional[int],
            lease_timeout: float
            ) -> Tuple[List[tuple], bool, int, Optional[int]]:
        """Blocking batched leased drain.  Returns (items, woken, epoch,
        lease): ``woken`` tells the client an empty response came from a
        wake (re-check cancel and possibly re-park) rather than a
        timeout; ``lease`` is the id the client must ack once the batch
        is safely handed off (None when no items were returned).

        ``last_epoch`` is the wake epoch the client observed on its
        previous response (None on a channel's first request).  Parking
        only happens when the client's epoch is current, so a ``wake``
        that lands between the client's cancel check and this request
        is detected instead of lost -- the first request of a channel
        never parks (it syncs the epoch and returns woken), closing the
        race without any polling."""
        q = self._queue(topic, kind)
        deadline = None if timeout is None else now() + timeout
        with q.cond:
            self._expire_locked(q)
            if not q.items and (last_epoch is None
                                or q.epoch != last_epoch):
                return [], True, q.epoch, None  # epoch sync / missed wake
            out: list = []
            while not out:
                while not q.items:
                    if q.epoch != last_epoch:
                        return [], True, q.epoch, None
                    remaining = None
                    if deadline is not None:
                        remaining = deadline - now()
                        if remaining <= 0:
                            return [], False, q.epoch, None
                    # bound the park by the earliest in-flight lease
                    # deadline so this getter requeues expired leases
                    # itself
                    lease_dl = self._next_lease_deadline_locked(q)
                    if lease_dl is not None:
                        until_lease = max(lease_dl - now(), 0.0)
                        remaining = (until_lease if remaining is None
                                     else min(remaining, until_lease))
                    if remaining is None:
                        q.cond.wait()
                    else:
                        q.cond.wait(remaining)
                    self._expire_locked(q)
                while q.items and len(out) < max_n:
                    t_put, meta, data = q.items.popleft()
                    tid = meta.get("task_id")
                    if tid is not None and tid in self._cancelled:
                        # cancelled work drained defensively (a retry
                        # requeue or lease-expiry redelivery raced the
                        # cancel's strip): destroy it.  Rare path, so
                        # the unlink may stay under the cond
                        if "_shm" in meta:
                            shm.unlink_segment(meta["_shm"])
                        continue
                    out.append((t_put, meta, data))
            lid = q.next_lease
            q.next_lease += 1
            # `out` is owned by this handler and never mutated after the
            # response is built: the ledger can share it (no copy)
            q.leases[lid] = (lease_timeout, now() + lease_timeout, out)
            if len(q.leases) == 1:
                # empty -> non-empty lease transition: getters parked
                # before any lease existed wait *unbounded* (or until
                # their own deadline) -- wake them so they re-arm their
                # park bounded by this lease's expiry, otherwise nobody
                # would ever run the expiry that redelivers it
                q.cond.notify_all()
            return out, False, q.epoch, lid

    def ack(self, topic: str, kind: str, lease_id: int) -> None:
        q = self._queue(topic, kind)
        with q.cond:
            lease = q.leases.pop(lease_id, None)    # already expired: no-op
        if lease is not None:
            # acked envelopes are destroyed: release their segments (the
            # unlink happens outside the queue lock; the items are no
            # longer reachable from any queue structure)
            for _, meta, _ in lease[2]:
                if "_shm" in meta:
                    shm.unlink_segment(meta["_shm"])

    def backup(self, topic: str, kind: str, lease_id: int, task_id: str,
               meta_update: dict) -> bool:
        """Straggler support for the direct-subscription data plane: the
        pool parent never sees envelope bytes any more, but the broker
        holds the leased original right here -- so a backup is a
        broker-side *clone* of the leased envelope back onto the queue,
        with placement metadata (``exclude_host``/``exclude_worker``)
        merged into the copy's meta.  The original lease is untouched
        (the slow worker may still win); first completion arbitrates
        through the claim as always.  False = the lease is gone (acked
        or expired -- either way a backup is moot)."""
        q = self._queue(topic, kind)
        with q.cond:
            lease = q.leases.get(lease_id)
            if lease is None:
                return False
            for t_put, meta, data in lease[2]:
                if meta.get("task_id") == task_id:
                    m = dict(meta)
                    m.update(meta_update)
                    m["backup"] = True
                    if "_shm" in m:
                        # the clone cannot share the original's segment
                        # (each envelope's destruction unlinks its own):
                        # inline the payload into the copy instead
                        try:
                            data = shm.read_segment(m.pop("_shm"))
                        except OSError:
                            return False
                    q.items.append((t_put, m, data))
                    q.cond.notify()
                    obs.counter("backup_clones").inc()
                    return True
        return False

    def renew(self, topic: str, kind: str, lease_id: int) -> bool:
        """Push a live lease's deadline out by another full duration.
        False = the lease is gone (acked, or expired and requeued): the
        renewal lost the race and the holder's eventual completion will
        arbitrate through the claim like any straggler backup.  Getters
        parked against the old deadline simply wake, find nothing
        expired, and re-bound against the new one."""
        q = self._queue(topic, kind)
        with q.cond:
            lease = q.leases.get(lease_id)
            if lease is None:
                return False
            dur, _, items = lease
            q.leases[lease_id] = (dur, now() + dur, items)
            return True

    def wake(self) -> None:
        with self._qlock:
            queues = list(self._queues.values())
        for q in queues:
            with q.cond:
                q.epoch += 1
                q.cond.notify_all()

    def claim(self, task_id: str) -> bool:
        with self._claim_lock:
            return self._claimed.claim(task_id)

    def cancel(self, topic: str, task_id: str) -> bool:
        """Preempt ``task_id`` on ``topic``: claim the id (a racing
        completion's fused put-claim dedups against this -- exactly one
        of cancel/complete wins), record it cancelled, destroy every
        queued copy (original, retry requeue, straggler backup clone)
        and strip it out of live leases on the requests *and* stream
        queues, then wake parked getters so the freed capacity is
        re-steered immediately.  The executing worker is not contacted
        here -- it notices via the fused ``put_stream`` reply or the
        heartbeat's ``is_cancelled`` probe and aborts cooperatively."""
        # resolve the queues BEFORE taking the claim lock: _queue
        # acquires _qlock, and a claim_lock -> qlock nesting would be a
        # new lock-order edge nothing else needs
        qs = [self._queue(topic, "requests"), self._queue(topic, "stream")]
        dropped: list = []
        # claim + cancelled-window write + strip are one atomic step
        # under the claim lock (claim_lock -> q.cond, the same order as
        # put-with-claim and snapshot): a snapshot can never image the
        # claim without the strip
        with self._claim_lock:
            if not self._claimed.claim(task_id):
                return False                # completion already won
            self._cancelled.add(task_id)
            for q in qs:
                with q.cond:
                    kept: deque = deque()
                    for item in q.items:
                        if item[1].get("task_id") == task_id:
                            if "_shm" in item[1]:
                                dropped.append(item[1]["_shm"])
                        else:
                            kept.append(item)
                    q.items = kept
                    for lid in list(q.leases):
                        dur, dl, items = q.leases[lid]
                        live = []
                        for item in items:
                            if item[1].get("task_id") == task_id:
                                if "_shm" in item[1]:
                                    dropped.append(item[1]["_shm"])
                            else:
                                live.append(item)
                        if len(live) == len(items):
                            continue
                        if live:
                            q.leases[lid] = (dur, dl, live)
                        else:
                            # nothing left under the lease (e.g. a
                            # backup clone's whole delivery): drop it --
                            # expiry would requeue nothing
                            del q.leases[lid]
                    # wake parked getters: an idle getter parked in an
                    # unbounded wait re-checks its cancel Event (the
                    # PR-7 stop-envelope hazard) and freed capacity is
                    # re-steerable immediately
                    q.epoch += 1
                    q.cond.notify_all()
        # revocation must unlink, not leak: the stripped envelopes owned
        # their segments (outside the locks, mirroring ack)
        for desc in dropped:
            shm.unlink_segment(desc)
        obs.counter("tasks_cancelled").inc()
        return True

    def put_stream(self, topic: str, t_put: float, meta: dict,
                   data: bytes) -> bool:
        """Mid-task observation publish fused with the cancel probe:
        True = the task is already cancelled and the observation was
        dropped (the worker's cue to abort); False = enqueued on the
        stream lane.  The membership read is lock-free (GIL-atomic; a
        cancel racing this publish is benign -- the worker aborts at its
        next probe and the get path destroys the stale observation)."""
        tid = meta.get("task_id")
        if tid is not None and tid in self._cancelled:
            obs.counter("observations_dropped").inc()
            return True
        q = self._queue(topic, "stream")
        with q.cond:
            q.items.append((t_put, meta, data))
            q.cond.notify()
        return False

    def is_cancelled(self, task_id: str) -> bool:
        """Read-only probe of the cancelled window (idempotent)."""
        return task_id in self._cancelled   # GIL-atomic read

    def qlen(self, topic: str, kind: str) -> int:
        q = self._queue(topic, kind)
        with q.cond:
            self._expire_locked(q)
            return len(q.items)

    def scrape_stats(self) -> dict:
        """The ``stats_scrape`` reply body: per-queue depth and in-flight
        lease counts read live under each queue's own lock, the shm
        segment count derived from envelope metas, plus this process's
        cumulative metrics registry (expiry/claim-reject/backup
        counters).  Read-only and idempotent by construction."""
        with self._qlock:
            queues = sorted(self._queues.items())
        depth: Dict[str, int] = {}
        inflight: Dict[str, int] = {}
        segs = 0
        for (topic, kind), q in queues:
            key = f"{topic}/{kind}"
            with q.cond:
                self._expire_locked(q)
                depth[key] = len(q.items)
                leased = [it for _, _, items in q.leases.values()
                          for it in items]
                inflight[key] = len(leased)
                segs += sum(1 for _, meta, _ in q.items if "_shm" in meta)
                segs += sum(1 for _, meta, _ in leased if "_shm" in meta)
        obs.gauge("queue_depth").set(sum(depth.values()))
        obs.gauge("inflight_leases").set(sum(inflight.values()))
        obs.gauge("shm_segments").set(segs)
        return {"t": now(), "pid": os.getpid(),
                "machine": socketlib.gethostname(),
                "queue_depth": depth, "inflight_leases": inflight,
                "shm_segments": segs, "metrics": obs.metrics_snapshot()}

    # -- shared-memory plumbing ----------------------------------------------

    @staticmethod
    def _inline_shm(item: tuple) -> tuple:
        """Snapshot form of a queue item: segment payloads are read back
        inline and the descriptor dropped, so a snapshot is self-contained
        (restorable into a fresh incarnation whose segments are gone) and
        byte-identical across resnaps of identical state (segment names
        are incarnation-local and must not leak into the image)."""
        t_put, meta, data = item
        if "_shm" not in meta:
            return item
        meta = dict(meta)
        data = shm.read_segment(meta.pop("_shm"))
        return (t_put, meta, data)

    def release_segments(self) -> None:
        """Unlink every segment still referenced by a queue or lease --
        the graceful-shutdown path (a SIGKILLed broker's leftovers are
        reclaimed by the owner transport's scope sweep instead)."""
        with self._qlock:
            queues = list(self._queues.values())
        for q in queues:
            with q.cond:
                items = list(q.items)
                for _, _, lease_items in q.leases.values():
                    items.extend(lease_items)
            for _, meta, _ in items:
                if "_shm" in meta:
                    shm.unlink_segment(meta["_shm"])

    # -- snapshot/restore -----------------------------------------------------

    def snapshot(self) -> bytes:
        """A *consistent global cut*: the claim lock plus every queue
        Condition are held simultaneously (acquired in the same sorted
        order everywhere, claim lock first -- matching put-with-claim's
        claim_lock -> cond order), so no envelope mid-relay between two
        queues and no claim-fused publish can straddle the image.  An
        envelope captured in two queues (leased upstream and already
        relayed downstream) merely re-executes into the claim dedup;
        captured in neither would be a lost task, and cannot happen."""
        from contextlib import ExitStack
        with self._qlock:
            queues = sorted(self._queues.items())
        with ExitStack() as stack:
            stack.enter_context(self._claim_lock)
            for _, q in queues:
                stack.enter_context(q.cond)
            out = []
            for (topic, kind), q in queues:
                items = [self._inline_shm(it) for it in q.items]
                leases = sorted((lid, dur,
                                 [self._inline_shm(it) for it in lease_items])
                                for lid, (dur, _, lease_items)
                                in q.leases.items())
                out.append((topic, kind, q.epoch, items, leases))
            order = list(self._claimed._order)
            maxlen = self._claimed.maxlen
            c_order = list(self._cancelled._order)
            c_maxlen = self._cancelled.maxlen
        return dump_snapshot(out, maxlen, order, c_maxlen, c_order)

    def restore(self, data: bytes, expire_leases: bool = False) -> None:
        state = load_snapshot(data)
        # the restored image replaces the current queues wholesale: any
        # segment the discarded envelopes referenced is released first
        self.release_segments()
        tnow = now()
        for topic, kind, epoch, items, leases in state["queues"]:
            q = self._queue(topic, kind)
            with q.cond:
                q.items = deque(items)
                q.epoch = epoch
                # deadline = tnow when expiring: the holders died with the
                # previous incarnation, so the expiry below requeues now
                q.leases = {lid: (dur, tnow if expire_leases else tnow + dur,
                                  list(lease_items))
                            for lid, dur, lease_items in leases}
                if q.leases:
                    q.next_lease = max(q.leases) + 1
                if expire_leases:
                    self._expire_locked(q)
                q.cond.notify_all()
        with self._claim_lock:
            claimed = BoundedIdSet(state["claims"]["maxlen"])
            for cid in state["claims"]["order"]:
                claimed.add(cid)
            self._claimed = claimed
            # a cancelled id must stay cancelled across resume: restored
            # stale envelopes of preempted tasks are destroyed on get
            canc = state.get("cancelled")
            if canc:
                cancelled = BoundedIdSet(canc["maxlen"]
                                         or self._cancelled.maxlen)
                for cid in canc["order"]:
                    cancelled.add(cid)
                self._cancelled = cancelled

    # -- frame dispatch -------------------------------------------------------

    def handle(self, header: dict, payload: bytes
               ) -> Optional[Tuple[dict, bytes]]:
        # piggybacked acks commit the sender's previous batches before
        # the op itself runs (so a put that triggers redelivery can never
        # race ahead of the ack it travelled with)
        for topic, kind, lid in header.get("acks", ()):
            self.ack(topic, kind, lid)
        op = header["op"]
        if op == "put":
            ok = self.put(header["topic"], header["kind"], header["t_put"],
                          header["meta"], payload, header.get("claim"),
                          header.get("shm"))
            return {"ok": True, "claimed": ok}, b""
        if op == "get":
            items, woken, epoch, lease = self.get(
                header["topic"], header["kind"], header["max_n"],
                header["timeout"], header.get("epoch"),
                header.get("lease_timeout", 30.0))
            shm_ok = header.get("shm_ok", False)
            t_grant = now()
            lens, blobs = [], []
            for t_put, meta, data in items:
                if meta.get("trace") and meta.get("task_id"):
                    # queue_wait bounds enqueue -> lease grant on THIS
                    # broker's clock; t_put is the producer's clock (same
                    # CLOCK_MONOTONIC timebase on one machine, aligned by
                    # the report's offset chain across machines)
                    obs.span(meta["task_id"], "queue_wait", t_put, t_grant,
                             attempt=int(meta.get("redelivered", 0) or 0),
                             topic=header["topic"], kind=header["kind"])
                if "_shm" in meta and shm_ok:
                    # hand the descriptor through: the co-located consumer
                    # maps the segment itself and the payload never touches
                    # this socket.  The lease keeps the descriptor, so the
                    # eventual ack (or a post-expiry redelivery) still
                    # resolves the segment's lifetime here.
                    lens.append((t_put, meta, 0))
                    continue
                if "_shm" in meta:
                    # remote (or lane-disabled) consumer: inline the bytes;
                    # the leased original keeps the descriptor for cleanup
                    meta = dict(meta)
                    data = shm.read_segment(meta.pop("_shm"))
                lens.append((t_put, meta, len(data)))
                blobs.append(data)
            return {"envs": lens, "woken": woken, "epoch": epoch,
                    "lease": lease}, b"".join(blobs)
        if op == "backup":
            ok = self.backup(header["topic"], header["kind"], header["lease"],
                             header["id"], header["meta"])
            return {"ok": ok}, b""
        if op == "endpoints":
            # data-plane discovery: a plain broker IS every topic's home
            # (no peers to advertise); the federation overrides this with
            # its peer address map so clients dial home brokers directly
            return {"host": None, "peers": {}, "partition": {},
                    "machine": socketlib.gethostname(),
                    "scope": self.shm_scope}, b""
        if op == "ack":                     # explicit flush (rare path)
            return {"ok": True}, b""
        if op == "renew":
            ok = self.renew(header["topic"], header["kind"], header["lease"])
            return {"ok": ok}, b""
        if op == "wake":
            self.wake()
            return {"ok": True}, b""
        if op == "claim":
            return {"claimed": self.claim(header["id"])}, b""
        if op == "cancel":
            return {"won": self.cancel(header["topic"], header["id"])}, b""
        if op == "put_stream":
            dropped = self.put_stream(header["topic"], header["t_put"],
                                      header["meta"], payload)
            return {"ok": True, "cancelled": dropped}, b""
        if op == "cancelled":
            return {"cancelled": self.is_cancelled(header["id"])}, b""
        if op == "len":
            return {"n": self.qlen(header["topic"], header["kind"])}, b""
        if op == "snapshot":
            return {"ok": True}, self.snapshot()
        if op == "restore":
            self.restore(payload, header.get("expire_leases", False))
            return {"ok": True}, b""
        if op == "ping":
            return {"ok": True}, b""
        if op == "clock_sync":
            # read-only clock probe: the caller brackets this reply with
            # its own now() pair and min-RTT-midpoints the offset
            return {"t": now()}, b""
        if op == "stats_scrape":
            return {"stats": self.scrape_stats()}, b""
        if op == "shutdown":
            return None
        return {"error": f"unknown op {op!r}"}, b""


def start_autosnapshot(snapshot_fn, every: float, path: str,
                       stop: threading.Event) -> threading.Thread:
    """Periodic broker-side crash protection: every ``every`` seconds,
    write ``snapshot_fn()`` to ``path`` atomically (tmp + rename, so a
    kill mid-write leaves the previous image intact).  Campaigns get a
    resumable file without any application-level checkpoint call --
    ``ColmenaQueues.load_checkpoint`` recognizes the raw snapshot format
    and derives the active-task count from the envelope metas.  A failed
    write is logged-by-omission (the next tick retries); it must never
    take the broker down with it."""
    import os

    def loop():
        while not stop.wait(every):
            try:
                data = snapshot_fn()
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, path)
            except Exception:               # noqa: BLE001
                pass

    th = threading.Thread(target=loop, daemon=True, name="broker-autosnap")
    th.start()
    return th


def broker_main(sock, snapshot_every: float = 0.0,
                snapshot_path: Optional[str] = None,
                shm_scope: Optional[str] = None) -> None:
    """Entry point of the broker process (listening socket inherited from
    the parent fork)."""
    try:
        addr = obs.addr_str(sock.getsockname())
    except OSError:
        addr = ""
    obs.configure(role="broker", addr=addr)
    broker = Broker(shm_scope=shm_scope)
    stop = threading.Event()
    if snapshot_every and snapshot_path:
        start_autosnapshot(broker.snapshot, snapshot_every, snapshot_path,
                           stop)
    frames.serve_forever(sock, broker.handle, stop)
    broker.release_segments()
    # graceful shutdown: final cumulative metrics + buffered span tail
    obs.flush_metrics(force=True)
