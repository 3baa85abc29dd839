"""In-process transport: per-channel Condition-notified deques.

This is the PR-1 ``_WakeQueue`` fabric, factored out of ``queues.py`` so
it sits behind the same ``Transport`` interface as the socket backend.
Consumers park on the condition until a ``put`` (or an external ``wake``,
e.g. shutdown) notifies them, and can drain a batch per wakeup -- there is
no timeout-polling anywhere on the dispatch or result-consumption path.

Delivery is leased exactly like the broker's (see ``base.Channel``): a
``get_batch`` moves envelopes to an in-flight ledger under a per-thread
lease, ``ack`` removes them for good, and an unacked lease expires after
``lease_timeout`` and requeues -- parked getters bound their waits by the
earliest lease deadline and run the expiry themselves, so redelivery
needs no sweeper thread.  The local backend has no consumer *processes*
to die, but implementing the identical interface in-process means every
lease/ack/snapshot test parametrizes over both backends.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

from repro_torch import observability as obs
from repro_torch.core.transport.base import (BoundedIdSet, Channel, Envelope,
                                       Transport, dump_snapshot,
                                       load_snapshot)
from repro_torch.utils.timing import now


class LocalChannel(Channel):
    """FIFO of envelopes with Condition-notified blocking consumers and
    an in-flight lease ledger for at-least-once delivery."""

    def __init__(self, transport: "LocalTransport", topic: str = "",
                 kind: str = ""):
        self._t = transport
        self.topic = topic
        self.kind = kind
        self._items: "deque[Envelope]" = deque()
        self._cond = threading.Condition()
        self.epoch = 0                        # parity with the broker queue
        # lease_id -> (duration, deadline, [Envelope, ...]); all access
        # under self._cond
        self._leases: Dict[int, Tuple[float, float, List[Envelope]]] = {}
        self._next_lease = 0
        self._tls = threading.local()         # .held: this thread's lease

    # -- lease plumbing (call with self._cond held) -------------------------

    def _expire_locked(self) -> None:
        if not self._leases:
            return
        tnow = now()
        expired = [lid for lid, (_, deadline, _) in self._leases.items()
                   if deadline <= tnow]
        if not expired:
            return
        obs.counter("expired_leases").inc(len(expired))
        for lid in expired:
            _, _, envs = self._leases.pop(lid)
            obs.counter("redeliveries").inc(len(envs))
            for env in reversed(envs):
                meta = dict(env.meta)
                meta["redelivered"] = meta.get("redelivered", 0) + 1
                self._items.appendleft(Envelope(env.t_put, env.data, meta))
        self._cond.notify_all()

    def _next_lease_deadline_locked(self) -> Optional[float]:
        if not self._leases:
            return None
        return min(deadline for _, deadline, _ in self._leases.values())

    # -- Channel interface --------------------------------------------------

    def put(self, env: Envelope, claim: Optional[str] = None) -> bool:
        if claim is not None:
            # the claim guard is held ACROSS the enqueue (lock order:
            # transport lock -> cond, same as snapshot) so a snapshot
            # can never capture the claim without its result
            with self._t._lock:
                if not self._t._claimed.claim(claim):
                    obs.counter("claim_rejects").inc()
                    return False
                with self._cond:
                    self._items.append(env)
                    self._cond.notify()
            return True
        with self._cond:
            self._items.append(env)
            self._cond.notify()
        return True

    def get_batch(self, max_n: int, timeout: Optional[float] = None,
                  cancel: Optional[threading.Event] = None
                  ) -> List[Envelope]:
        self.ack()                            # poll-is-commit backstop
        deadline = None if timeout is None else now() + timeout
        with self._cond:
            while True:
                self._expire_locked()
                if self._items:
                    out = []
                    while self._items and len(out) < max_n:
                        env = self._items.popleft()
                        tid = env.meta.get("task_id")
                        # a cancelled id's envelope is dead work: destroy
                        # it here (backstop for a retry-requeue or
                        # redelivery racing the cancel's strip)
                        if tid is not None and tid in self._t._cancelled:
                            continue
                        out.append(env)
                    if not out:
                        continue              # drained only cancelled work
                    lid = self._next_lease
                    self._next_lease += 1
                    dur = self._t.lease_timeout
                    # `out` is returned to exactly one caller and never
                    # mutated: the ledger can share it (no copy)
                    self._leases[lid] = (dur, now() + dur, out)
                    if len(self._leases) == 1:
                        # getters parked before any lease existed wait
                        # unbounded: wake them to re-arm their park
                        # bounded by this lease's expiry (see broker.get)
                        self._cond.notify_all()
                    self._tls.held = lid
                    t_grant = now()
                    for env in out:
                        if env.meta.get("trace") and env.meta.get("task_id"):
                            obs.span(env.meta["task_id"], "queue_wait",
                                     env.t_put, t_grant,
                                     attempt=int(env.meta.get(
                                         "redelivered", 0) or 0))
                    return out
                if cancel is not None and cancel.is_set():
                    return []
                remaining = None
                if deadline is not None:
                    remaining = deadline - now()
                    if remaining <= 0:
                        return []
                lease_dl = self._next_lease_deadline_locked()
                if lease_dl is not None:
                    until_lease = max(lease_dl - now(), 0.0)
                    remaining = (until_lease if remaining is None
                                 else min(remaining, until_lease))
                if remaining is None:
                    self._cond.wait()
                else:
                    self._cond.wait(remaining)

    def ack(self, flush: bool = False) -> None:
        held = getattr(self._tls, "held", None)
        if held is None:
            return
        self._tls.held = None
        with self._cond:
            self._leases.pop(held, None)      # already expired: no-op

    def held_lease(self) -> Optional[int]:
        return getattr(self._tls, "held", None)

    def detach_lease(self) -> Optional[int]:
        held = getattr(self._tls, "held", None)
        self._tls.held = None
        return held

    def ack_lease(self, lease_id: Optional[int],
                  flush: bool = False) -> None:
        if lease_id is None:
            return
        with self._cond:
            self._leases.pop(lease_id, None)  # already expired: no-op

    def backup(self, lease_id: int, task_id: str,
               meta_update: dict) -> bool:
        with self._cond:
            lease = self._leases.get(lease_id)
            if lease is None:
                return False                  # acked or already expired
            for env in lease[2]:
                if env.meta.get("task_id") == task_id:
                    meta = dict(env.meta)
                    meta.update(meta_update)
                    meta["backup"] = True
                    self._items.append(Envelope(env.t_put, env.data, meta))
                    self._cond.notify()
                    return True
        return False

    def renew(self, lease_id: Optional[int] = None) -> bool:
        lid = lease_id if lease_id is not None else self.held_lease()
        if lid is None:
            return False
        with self._cond:
            lease = self._leases.get(lid)
            if lease is None:
                return False                  # acked or already expired
            dur, _, envs = lease
            self._leases[lid] = (dur, now() + dur, envs)
            return True

    def wake(self) -> None:
        with self._cond:
            self.epoch += 1
            self._cond.notify_all()

    def cancel(self, task_id: str) -> bool:
        # claim + cancelled-window write + queue/lease strip as one
        # atomic step under the transport lock, channel Conditions nested
        # inside in sorted (topic, kind) order -- the same lock order as
        # put-with-claim and snapshot, so a snapshot can never image the
        # claim without the strip (and the witness learns no new edges)
        with self._t._lock:
            if not self._t._claimed.claim(task_id):
                return False                  # completion (or an earlier
                                              # cancel) already won
            self._t._cancelled.add(task_id)
            chans = [ch for (t, k), ch in sorted(self._t._channels.items())
                     if t == self.topic and k in ("requests", "stream")]
            for ch in chans:
                with ch._cond:
                    ch._items = deque(
                        e for e in ch._items
                        if e.meta.get("task_id") != task_id)
                    for lid in list(ch._leases):
                        dur, dl, envs = ch._leases[lid]
                        live = [e for e in envs
                                if e.meta.get("task_id") != task_id]
                        if len(live) == len(envs):
                            continue
                        if live:
                            ch._leases[lid] = (dur, dl, live)
                        else:
                            # nothing left under the lease (e.g. a
                            # straggler backup clone's whole delivery):
                            # drop it -- expiry would requeue nothing
                            del ch._leases[lid]
                    # wake parked getters: capacity freed by the strip is
                    # re-steerable immediately, and an idle getter parked
                    # in an unbounded wait re-checks its cancel Event
                    # (the PR-7 stop-envelope hazard)
                    ch.epoch += 1
                    ch._cond.notify_all()
        obs.counter("tasks_cancelled").inc()
        return True

    def put_stream(self, env: Envelope, task_id: str) -> bool:
        # membership read without the transport lock: GIL-atomic, and a
        # cancel racing this publish is benign -- the worker aborts at
        # its next probe and the get path destroys the stale observation
        if task_id in self._t._cancelled:
            obs.counter("observations_dropped").inc()
            return True
        with self._cond:
            self._items.append(env)
            self._cond.notify()
        return False

    def is_cancelled(self, task_id: str) -> bool:
        return task_id in self._t._cancelled  # GIL-atomic read

    def __len__(self) -> int:
        with self._cond:
            return len(self._items)

    def inflight_count(self) -> int:
        with self._cond:
            return sum(len(envs) for _, _, envs in self._leases.values())


class LocalTransport(Transport):
    name = "local"

    def __init__(self, claim_window: int = 1 << 16,
                 lease_timeout: float = 30.0):
        self._channels: Dict[Tuple[str, str], LocalChannel] = {}
        self._lock = threading.Lock()
        self._claimed = BoundedIdSet(claim_window)
        # preempted ids: written under self._lock (cancel), read lock-free
        self._cancelled = BoundedIdSet(claim_window)
        self.lease_timeout = lease_timeout

    def channel(self, topic: str, kind: str) -> LocalChannel:
        with self._lock:
            ch = self._channels.get((topic, kind))
            if ch is None:
                ch = self._channels[(topic, kind)] = LocalChannel(
                    self, topic, kind)
            return ch

    def wake_all(self) -> None:
        with self._lock:
            channels = list(self._channels.values())
        for ch in channels:
            ch.wake()

    def claim(self, task_id: str) -> bool:
        with self._lock:
            return self._claimed.claim(task_id)

    def clock_sync(self) -> float:
        """Interface parity with ``ProcTransport.clock_sync``: everything
        shares this process's clock, so the reference time IS ``now()``
        (calibration against it converges on a ~zero offset)."""
        return now()

    # -- snapshot/restore ---------------------------------------------------

    def snapshot(self) -> bytes:
        """Consistent global cut, mirroring the broker: the transport
        lock (which guards claims) plus every channel Condition are held
        simultaneously, so no claim-fused put and no envelope mid-relay
        between channels can straddle the image."""
        from contextlib import ExitStack
        with ExitStack() as stack:
            stack.enter_context(self._lock)
            channels = sorted(self._channels.items())
            for _, ch in channels:
                stack.enter_context(ch._cond)
            queues = []
            for (topic, kind), ch in channels:
                items = [(e.t_put, e.meta, e.data) for e in ch._items]
                leases = sorted(
                    (lid, dur, [(e.t_put, e.meta, e.data) for e in envs])
                    for lid, (dur, _, envs) in ch._leases.items())
                queues.append((topic, kind, ch.epoch, items, leases))
            order = list(self._claimed._order)
            maxlen = self._claimed.maxlen
            c_order = list(self._cancelled._order)
            c_maxlen = self._cancelled.maxlen
        return dump_snapshot(queues, maxlen, order, c_maxlen, c_order)

    def restore(self, data: bytes, expire_leases: bool = False) -> None:
        state = load_snapshot(data)
        tnow = now()
        for topic, kind, epoch, items, leases in state["queues"]:
            ch = self.channel(topic, kind)
            with ch._cond:
                ch._items = deque(Envelope(t, d, m) for t, m, d in items)
                ch.epoch = epoch
                # deadline = tnow when expiring: the holders died with the
                # previous incarnation, so the next expiry check requeues
                ch._leases = {
                    lid: (dur, tnow if expire_leases else tnow + dur,
                          [Envelope(t, d, m) for t, m, d in envs])
                    for lid, dur, envs in leases}
                if ch._leases:
                    ch._next_lease = max(ch._leases) + 1
                if expire_leases:
                    ch._expire_locked()
                ch._cond.notify_all()
        with self._lock:
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

    def close(self) -> None:
        self.wake_all()
