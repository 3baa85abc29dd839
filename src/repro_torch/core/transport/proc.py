"""Client side of the socket fabric: ``ProcTransport`` + ``ProcChannel``.

``ProcTransport()`` binds a Unix-domain socket (TCP fallback), forks the
broker process on it, and hands out ``ProcChannel`` objects whose
``put``/``get_batch`` translate one-to-one into broker frames.  Consumers
block in ``recv`` while the broker parks their handler thread on the queue
Condition -- there is no polling on either side of the wire.  The
transport object is safe to capture in forked workers: its ``FrameClient``
reopens connections per (pid, thread).

Two data-plane optimizations live here, both discovered (not configured)
through the broker's ``endpoints`` op:

- **Direct routing.**  In a federation, each topic is homed at exactly
  one member broker.  Rather than sending every frame to the local
  broker and letting it relay, a channel resolves its topic's home from
  the advertised peer map and dials that broker directly -- zero relay
  hops on the data plane.  The relay path remains as the fallback (a
  frame that does land at a non-home member is still forwarded), and
  control traffic (``wake``, ``claim``, snapshots, ack flushes) keeps
  going through the connected broker, which owns the broadcast /
  coordinator semantics.
- **Shared-memory payload lane.**  When the destination broker is
  co-located (same machine, advertises a shm scope), a payload at or
  above ``shm_threshold`` is written once into a shared-memory segment
  (``transport.shm``) and only its descriptor rides the frame header;
  co-located consumers advertise ``shm_ok`` on their gets and map the
  segment themselves.  Segment lifetime is tied to the envelope's
  lease/ack lifecycle at the broker (see ``shm.py``'s ownership
  protocol); the wire format is unchanged for remote or under-threshold
  frames.

Delivery is leased (see ``base.Channel``): every non-empty ``get``
response carries a lease id, and the envelopes are only destroyed when
the consumer acks it.  Acks accumulate in a transport-level pending set
and piggyback on the *next* outgoing frame -- any frame, to any broker
of the fabric; a member receiving acks for topics homed elsewhere
forwards them (``federation._route_acks``).  If a frame carrying acks
dies with its connection, the acks are restored to the pending set: the
worst case is a redundant redelivery that the publisher-side ``claim``
dedups, never a lost task.
"""
from __future__ import annotations

import atexit
import multiprocessing
import os
import socket as socketlib
import tempfile
import threading
from typing import List, Optional, Tuple

from repro_torch import observability as obs
from repro_torch.core.transport import frames, shm
from repro_torch.core.transport.base import Channel, Envelope, Transport
from repro_torch.core.transport.broker import broker_main
from repro_torch.utils.timing import now

_mp = multiprocessing.get_context("fork")

_LOCAL_HOSTS = ("localhost", "127.0.0.1", "::1")


class ProcChannel(Channel):
    def __init__(self, transport: "ProcTransport", topic: str, kind: str):
        self._t = transport
        self.topic = topic
        self.kind = kind
        # the topic's home-broker client and whether that broker is
        # co-located (shm lane eligible); resolved lazily on first use --
        # both threads of a benign race compute the same cached client
        self._client: Optional[frames.FrameClient] = None
        self._local = False
        # wake epoch and held lease observed from the broker, tracked PER
        # THREAD (like FrameClient's sockets): the broker only parks a get
        # whose epoch is current, so a wake_all landing between a thread's
        # cancel check and its request is detected, never lost -- and one
        # consumer thread absorbing a wake (or acking its lease) cannot
        # clobber a sibling consumer's epoch or lease
        self._tls = threading.local()

    def _dc(self) -> frames.FrameClient:
        """This topic's home-broker client (direct data plane)."""
        c = self._client
        if c is None:
            c, local = self._t.client_for(self.topic)
            self._local = local
            self._client = c
        return self._client

    def put(self, env: Envelope, claim: Optional[str] = None) -> bool:
        client = self._dc()
        header = {"op": "put", "topic": self.topic, "kind": self.kind,
                  "t_put": env.t_put, "meta": env.meta}
        if claim is not None:
            header["claim"] = claim
        payload = env.data
        traced = env.meta.get("trace") and env.meta.get("task_id")
        t0 = now() if traced else 0.0
        desc = self._t.export_payload(payload) if self._local else None
        if desc is not None:
            if traced:
                obs.span(env.meta["task_id"], "shm_write", t0, now(),
                         size=len(payload))
            header["shm"] = desc
            payload = b""
        # NOTE on a failed request after export: the segment is NOT
        # unlinked here.  A connection error is ambiguous -- the broker
        # may have received the frame and now owns the segment; unlinking
        # would destroy a delivered envelope's payload.  The leak is
        # bounded: teardown sweeps the fabric's scope (shm.sweep_scope).
        resp, _ = self._t.request(header, payload, client=client)
        return resp.get("claimed", True)

    def get_batch(self, max_n: int, timeout: Optional[float] = None,
                  cancel: Optional[threading.Event] = None
                  ) -> List[Envelope]:
        self.ack()                          # poll-is-commit backstop
        client = self._dc()
        deadline = None if timeout is None else now() + timeout
        while True:
            if cancel is not None and cancel.is_set():
                return []
            remaining = None
            if deadline is not None:
                remaining = deadline - now()
                if remaining <= 0:
                    return []
            epoch = getattr(self._tls, "epoch", None)
            # NOTE no retry= here: a broker-side get is a *leased* dequeue,
            # so a response frame lost with its connection only strands a
            # lease that expires and redelivers -- but an automatic
            # reconnect-resend would still fetch *different* envelopes
            # under a fresh lease while this caller believes it asked
            # once.  Surfacing the error keeps the failure visible; the
            # lease ledger (not a resend) is what makes it recoverable.
            header, blob = self._t.request(
                {"op": "get", "topic": self.topic, "kind": self.kind,
                 "max_n": max_n, "timeout": remaining,
                 "lease_timeout": self._t.lease_timeout,
                 "epoch": epoch, "shm_ok": self._local},
                client=client)
            self._tls.epoch = header["epoch"]
            if header["envs"]:
                self._tls.held = header["lease"]
                out, off = [], 0
                for t_put, meta, n in header["envs"]:
                    if "_shm" in meta:
                        # out-of-band payload: map the co-located segment
                        # (read-only -- consumers never unlink, see shm.py)
                        meta = dict(meta)
                        desc = meta.pop("_shm")
                        t0 = (now() if meta.get("trace")
                              and meta.get("task_id") else 0.0)
                        try:
                            data = shm.read_segment(desc)
                        except OSError:
                            # our lease expired mid-flight and the
                            # redelivered copy's consumer already acked
                            # (destroying the segment): this copy lost the
                            # race anyway -- drop it, the claim dedups
                            continue
                        if t0:
                            obs.span(meta["task_id"], "shm_read", t0, now(),
                                     size=len(data))
                        out.append(Envelope(t_put, data, meta))
                        continue
                    out.append(Envelope(t_put, blob[off:off + n], meta))
                    off += n
                if out:
                    return out
                continue                    # every item raced: re-get
            if not header["woken"]:
                return []                   # server-side timeout lapsed
            # woken (wake_all) or first-request epoch sync: re-check
            # cancel/deadline, then re-park with a current epoch

    def ack(self, flush: bool = False) -> None:
        held = getattr(self._tls, "held", None)
        if held is not None:
            self._tls.held = None
            self._t.queue_ack((self.topic, self.kind, held))
        if flush:
            self._t.flush_acks()

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
        self._t.queue_ack((self.topic, self.kind, lease_id))
        if flush:
            self._t.flush_acks()

    def renew(self, lease_id: Optional[int] = None) -> bool:
        """Heartbeat a lease (the holder's, or an explicit id handed to
        a heartbeat thread -- leases are addressed by (topic, kind, id),
        so any thread's connection can renew them).  Deliberately not
        retried: a renew that died on the wire just means the next
        heartbeat tick renews a little later."""
        lid = lease_id if lease_id is not None else self.held_lease()
        if lid is None:
            return False
        header, _ = self._t.request(
            {"op": "renew", "topic": self.topic, "kind": self.kind,
             "lease": lid}, client=self._dc())
        return header["ok"]

    def backup(self, lease_id: int, task_id: str,
               meta_update: dict) -> bool:
        """Ask the broker to clone a leased envelope back onto the queue
        (straggler backup; see ``Broker.backup``).  Deliberately not
        retried: a resend of a backup that was applied before its
        connection died would enqueue a second clone -- harmless (claim
        dedup) but wasteful, and the straggler timer re-fires anyway."""
        header, _ = self._t.request(
            {"op": "backup", "topic": self.topic, "kind": self.kind,
             "lease": lease_id, "id": task_id, "meta": meta_update},
            client=self._dc())
        return header["ok"]

    def wake(self) -> None:
        self._t.wake_all()

    def cancel(self, task_id: str) -> bool:
        """Broker-side preemption (see ``Broker.cancel``).  Deliberately
        not retried: a resend of a cancel that was applied before its
        connection died would answer won=False to the rightful first
        canceller, who would then wrongly expect a result envelope."""
        header, _ = self._t.request(
            {"op": "cancel", "topic": self.topic, "id": task_id},
            client=self._dc())
        return header["won"]

    def put_stream(self, env: Envelope, task_id: str) -> bool:
        """Observation publish fused with the cancel probe (True = task
        cancelled, observation dropped).  Observations are small and
        advisory, so there is no shm lane here; deliberately not retried
        (a resend could double-publish an observation -- a missed one is
        harmless, the next publish carries fresher state anyway)."""
        header, _ = self._t.request(
            {"op": "put_stream", "topic": self.topic, "t_put": env.t_put,
             "meta": env.meta}, env.data, client=self._dc())
        return header.get("cancelled", False)

    def is_cancelled(self, task_id: str) -> bool:
        """Read-only probe of the cancelled window (idempotent, so the
        heartbeat's probe survives a reconnect)."""
        header, _ = self._t.request(
            {"op": "cancelled", "topic": self.topic, "id": task_id},
            retry=True, client=self._dc())
        return header["cancelled"]

    def __len__(self) -> int:
        header, _ = self._t.request(
            {"op": "len", "topic": self.topic, "kind": self.kind},
            retry=True, client=self._dc())
        return header["n"]


class ProcTransport(Transport):
    name = "proc"

    def __init__(self, address: Optional[tuple] = None,
                 lease_timeout: float = 30.0,
                 snapshot_every: float = 0.0,
                 snapshot_path: Optional[str] = None,
                 shm_threshold: Optional[int] = None):
        """address: connect to an existing broker (another process's
        fabric, or a cluster launcher's per-host federated broker); None
        forks a fresh broker owned by this transport.
        lease_timeout: seconds before an unacked get lease expires and
        its envelopes are redelivered; must exceed the longest consumer
        hold (a pool worker holds its lease for the task's execution)
        unless that consumer heartbeats via ``Channel.renew``.
        snapshot_every/snapshot_path: broker-side periodic auto-snapshot
        (atomic tmp+rename) -- crash protection with no application
        checkpoint call; only valid when this transport forks the
        broker (a remote broker configures its own).
        shm_threshold: payload size at which co-located frames switch to
        the shared-memory lane (default ``shm.SHM_THRESHOLD``)."""
        self._proc = None
        self._dir = None
        self._owner_pid = os.getpid()
        self.lease_timeout = lease_timeout
        self.shm_threshold = (shm.SHM_THRESHOLD if shm_threshold is None
                              else shm_threshold)
        self._pending_acks: list = []
        self._ack_lock = threading.Lock()
        # endpoints discovery + direct-client cache (lazy, lock-guarded)
        self._endpoints: Optional[dict] = None
        self._ep_lock = threading.Lock()
        self._direct_clients: dict = {}
        self._dc_lock = threading.Lock()
        self._shm_scope: Optional[str] = None   # active producer scope
        self._owned_scope: Optional[str] = None  # swept at close()
        if address is None:
            self._dir = tempfile.mkdtemp(prefix="colmena-broker-")
            sock, address = frames.make_server_socket(
                os.path.join(self._dir, "broker.sock"))
            if shm.shm_dir() is not None:
                self._owned_scope = shm.new_scope()
            self._proc = _mp.Process(
                target=broker_main,
                args=(sock, snapshot_every, snapshot_path,
                      self._owned_scope),
                daemon=True, name="colmena-broker")
            self._proc.start()
            sock.close()                    # the broker child owns it now
            atexit.register(self.close)
        elif snapshot_every:
            raise ValueError(
                "snapshot_every configures the broker this transport forks;"
                " a remote broker's auto-snapshot is configured where it is"
                " launched (ClusterSpec.snapshot_every)")
        self.address = address
        self.client = frames.FrameClient(address)

    # -- fork safety ----------------------------------------------------------

    def _after_fork(self) -> None:
        """A forked child inherits this transport's locks in whatever
        state the parent's threads held them at fork time -- a parent
        thread inside ``endpoints()`` leaves ``_ep_lock`` locked in the
        child *forever* (the owner lives in another process).  First use
        under a new pid therefore resets every transport-level mutable:
        fresh locks, empty direct-client cache (``FrameClient`` re-dials
        per pid anyway), no inherited pending acks (those are the
        parent's to flush), and cleared discovery/ownership state so the
        child re-discovers and can never tear down the parent's broker
        or sweep its shm scope.  Called from every entry point that
        touches a lock, ahead of acquiring it."""
        if os.getpid() == self._owner_pid:
            return
        self._owner_pid = os.getpid()
        self._ack_lock = threading.Lock()
        self._pending_acks = []
        self._ep_lock = threading.Lock()
        self._endpoints = None
        self._dc_lock = threading.Lock()
        self._direct_clients = {}
        self._shm_scope = None
        self._proc = None
        self._dir = None
        self._owned_scope = None

    # -- data-plane discovery -------------------------------------------------

    def endpoints(self) -> dict:
        """The connected broker's advertised topology: its federation
        host name (None for a plain broker), peer address map, topic
        partition, machine, and shm scope.  Discovered once, lazily,
        under a lock (double-checked: the fast path is one dict read);
        a broker predating the op degrades to the relay path."""
        self._after_fork()
        ep = self._endpoints
        if ep is not None:
            return ep
        with self._ep_lock:
            if self._endpoints is None:
                try:
                    header, _ = self.request({"op": "endpoints"},
                                             retry=True)
                except (ConnectionError, OSError, RuntimeError):
                    # unreachable or pre-endpoints broker: no direct
                    # routing, no shm lane -- every frame relays as before
                    header = {"host": None, "peers": {}, "partition": {},
                              "machine": None, "scope": None}
                if (header.get("scope")
                        and header.get("machine") == socketlib.gethostname()
                        and shm.shm_dir() is not None):
                    self._shm_scope = header["scope"]
                self._endpoints = header
        return self._endpoints

    @staticmethod
    def _addr_is_local(address) -> bool:
        """Whether a broker address is on this machine: a Unix-domain
        socket (a bare path, or ``("unix", path)`` as
        ``make_server_socket`` returns) always is; TCP only via loopback
        or our own hostname (the launcher's ssh path rewrites remote
        members to real hosts)."""
        if isinstance(address, (str, bytes)):
            return True
        host = address[0]
        return (host == "unix" or host in _LOCAL_HOSTS
                or host == socketlib.gethostname())

    def client_for(self, topic: str) -> Tuple[frames.FrameClient, bool]:
        """(client, co_located) for ``topic``'s home broker.  For a plain
        broker (or before/without discovery) that is the connected
        client; in a federation the topic's home is resolved from the
        advertised partition and dialed directly -- the same
        ``resolve_home`` every member routes by, so a direct frame is
        always local at its target."""
        ep = self.endpoints()
        host = ep.get("host")
        shm_on = self._shm_scope is not None
        if not host:
            return self.client, shm_on and self._addr_is_local(self.address)
        # deferred import: cluster.spec pulls in the cluster package,
        # which imports this module at load time
        from repro_torch.core.cluster.spec import resolve_home
        home = resolve_home(topic, ep["partition"], sorted(ep["peers"]))
        if home == host:
            return self.client, shm_on and self._addr_is_local(self.address)
        addr = ep["peers"][home]
        with self._dc_lock:
            c = self._direct_clients.get(home)
            if c is None:
                c = self._direct_clients[home] = frames.FrameClient(addr)
        return c, shm_on and self._addr_is_local(addr)

    def export_payload(self, data: bytes) -> Optional[dict]:
        """Move ``data`` into a shared-memory segment if the lane is on
        and the payload is big enough; returns the descriptor to ride
        the frame header, or None to send inline.  Any shm failure
        (namespace full, swept scope) silently falls back to inline --
        the lane is an optimization, never a correctness dependency."""
        scope = self._shm_scope
        if scope is None or len(data) < self.shm_threshold:
            return None
        try:
            return shm.create_segment(scope, data)
        except OSError:
            return None

    # -- ack piggybacking ---------------------------------------------------

    def queue_ack(self, ack: tuple) -> None:
        self._after_fork()
        with self._ack_lock:
            self._pending_acks.append(ack)

    def flush_acks(self) -> None:
        """Force pending acks onto the wire now (normally they ride the
        next frame; use before exiting a consumer)."""
        self._after_fork()
        with self._ack_lock:
            if not self._pending_acks:
                return
        self.request({"op": "ack"})

    def request(self, header: dict, payload: bytes = b"",
                retry: bool = False, client=None):
        """All broker traffic funnels through here so any frame can carry
        the pending acks -- to any broker of the fabric: a federation
        member routes acks for topics homed elsewhere (so an ack queued
        against one home broker safely rides a frame to another).  On a
        failed send the acks are restored: they ride the next successful
        frame, and until then the leases just stay in-flight (expiry +
        claim dedup make that safe)."""
        self._after_fork()
        if client is None:
            client = self.client
        acks = None
        with self._ack_lock:
            if self._pending_acks:
                acks = self._pending_acks
                self._pending_acks = []
        if acks:
            header = dict(header)
            header["acks"] = acks
        try:
            return client.request(header, payload, retry=retry)
        except (ConnectionError, OSError):
            if acks:
                with self._ack_lock:
                    self._pending_acks = acks + self._pending_acks
            raise

    # -- Transport interface ------------------------------------------------

    def channel(self, topic: str, kind: str) -> ProcChannel:
        return ProcChannel(self, topic, kind)

    def wake_all(self) -> None:
        try:
            self.request({"op": "wake"}, retry=True)
        except (ConnectionError, OSError):
            pass                    # broker already torn down: nothing parked

    def clock_sync(self) -> float:
        """One roundtrip of the idempotent ``clock_sync`` op against the
        connected broker: returns the broker's ``now()``.  Feed it to
        ``observability.calibrate`` to estimate this process's clock
        offset onto that broker's timeline."""
        header, _ = self.request({"op": "clock_sync"}, retry=True)
        return float(header["t"])

    def claim(self, task_id: str) -> bool:
        # deliberately NOT retried: a resend of a claim that was applied
        # before the connection died would answer False to the rightful
        # first claimant
        header, _ = self.request({"op": "claim", "id": task_id})
        return header["claimed"]

    def snapshot(self) -> bytes:
        _, payload = self.request({"op": "snapshot"}, retry=True)
        return payload

    def restore(self, data: bytes, expire_leases: bool = False) -> None:
        self.request({"op": "restore", "expire_leases": expire_leases},
                     data, retry=True)

    def close(self) -> None:
        # only the process that forked the broker may tear it down
        if self._proc is None or os.getpid() != self._owner_pid:
            return
        proc, self._proc = self._proc, None
        try:
            self.client.request({"op": "shutdown"})
        except (ConnectionError, OSError):
            pass
        self.client.close()
        for c in self._direct_clients.values():
            c.close()
        proc.join(timeout=2)
        if proc.is_alive():
            proc.terminate()
        if self._owned_scope is not None:
            # the broker released live segments on graceful shutdown;
            # this sweep reclaims leaks no registry could see (producer
            # died pre-handoff, broker SIGKILLed)
            shm.sweep_scope(self._owned_scope)
        if self._dir is not None:
            import shutil
            shutil.rmtree(self._dir, ignore_errors=True)
