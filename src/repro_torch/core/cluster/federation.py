"""Broker federation: per-host brokers, each owning a partition of topics.

Every host's broker is a plain ``Broker`` wrapped in a relay layer.  A
client only ever dials its *local* broker; when a frame addresses a
topic homed elsewhere, the local broker forwards the frame **verbatim**
(header minus the already-routed acks, payload bytes untouched) to the
home broker and relays the response back -- one extra hop, and only for
non-local topics.  Because the envelope payload is never touched and the
lease/claim/epoch state lives solely at the home broker, every fabric
guarantee survives federation unchanged:

- a relayed ``get`` parks this connection's handler thread inside the
  home broker's queue Condition (blocking + batching on the wire, no
  polling anywhere);
- the lease a relayed get returns is the home broker's; acks route back
  by topic -- including acks *piggybacked* on frames for other topics,
  which the relay splits by home and forwards (a forwarded ack lost to
  a dead peer merely leaves a lease to expire, which claim dedup makes
  safe);
- ``put(..., claim=)`` runs atomically at the home broker, so
  exactly-once completion arbitration is untouched;
- ``wake`` broadcasts to every member (relayed wakes carry a ``fed``
  flag so they are applied locally and never re-broadcast -- no storms);
- ``snapshot``/``restore`` operate on the whole federation: any member
  bundles its own snapshot with its peers' (each internally a consistent
  cut) into one blob, and ``restore`` unbundles it back out.  Taken from
  the application's blessed checkpoint site (no concurrent submits or
  unquiesced consumers mid-relay), the bundle is a resumable image of
  the whole cluster -- the same file format ``ColmenaQueues.checkpoint``
  wraps.  A campaign checkpoint pairs this bundle with a Value Server
  ring snapshot (``transport.shards``), so proxied payloads resume with
  the queues that reference them: restoring either half without the
  other is what used to force inline payloads, and no longer happens.

Standalone ``claim`` (no topic to route by) goes to the federation
coordinator.  The shipped task servers never use it -- completion claims
ride ``put(..., claim=)`` and arbitrate at the result topic's home -- so
the two paths cannot disagree about an id; callers that mix them across
topics homed off-coordinator would forfeit that and should not.

All members derive routing from the same ``ClusterSpec`` (partition map
+ sorted broker-host list), which is what makes the agreement total: a
relayed frame is always local at its target, so relay chains have
length exactly one.
"""
from __future__ import annotations

import pickle
import threading
from typing import Dict, Optional, Tuple

from repro_torch import observability as obs
from repro_torch.core.cluster.spec import host_hash_index, resolve_home
from repro_torch.core.transport import frames
from repro_torch.core.transport.broker import Broker, start_autosnapshot

FED_SNAPSHOT_VERSION = 1


def dump_fed_snapshot(host_snaps: Dict[str, bytes]) -> bytes:
    """Bundle per-broker snapshots into one blob.  Hosts are sorted so
    identical federation state always produces identical bytes (each
    member snapshot is itself deterministic)."""
    return pickle.dumps(
        {"fed_snapshot": FED_SNAPSHOT_VERSION,
         "hosts": dict(sorted(host_snaps.items()))},
        protocol=pickle.HIGHEST_PROTOCOL)


def is_fed_snapshot(payload: dict) -> bool:
    return isinstance(payload, dict) and "fed_snapshot" in payload


class FederatedBroker:
    """One member of the federation: a local ``Broker`` plus the relay.

    ``peers`` maps every broker host (including this one) to its
    address; relays open one connection per (handler-thread, peer) via
    ``FrameClient``'s per-thread sockets, so a parked relayed get only
    occupies its own connection on both sides."""

    def __init__(self, host: str, partition: Dict[str, str],
                 peers: Dict[str, tuple], shm_scope: Optional[str] = None):
        self.host = host
        self.partition = dict(partition)
        self.broker_hosts = sorted(peers)
        if host not in peers:
            raise ValueError(f"own host {host!r} missing from peer map")
        self.broker = Broker(shm_scope=shm_scope)
        self.peer_addresses = dict(peers)
        self._peers = {h: frames.FrameClient(addr)
                       for h, addr in peers.items() if h != host}

    def home(self, topic: str) -> str:
        return resolve_home(topic, self.partition, self.broker_hosts)

    # -- relay plumbing -----------------------------------------------------

    def _route_acks(self, header: dict) -> dict:
        """Apply local piggybacked acks, forward the rest to their home
        brokers (as fed ack frames), and return the header stripped of
        them.  Runs before the op itself, preserving the broker's
        commit-before-op ordering for the local share; a forwarding
        failure only strands a lease for expiry + claim dedup."""
        acks = header.get("acks", ())
        if not acks:
            return header
        remote: Dict[str, list] = {}
        for topic, kind, lid in acks:
            h = self.home(topic)
            if h == self.host:
                self.broker.ack(topic, kind, lid)
            else:
                remote.setdefault(h, []).append((topic, kind, lid))
        for h, racks in remote.items():
            try:
                self._peers[h].request(
                    {"op": "ack", "fed": True, "acks": racks})
            except (ConnectionError, OSError, RuntimeError):
                pass
        header = dict(header)
        header.pop("acks", None)
        return header

    def _relay(self, h: str, header: dict,
               payload: bytes) -> Tuple[dict, bytes]:
        fh = dict(header)
        fh["fed"] = True
        return self._peers[h].request(fh, payload)

    # -- federation-wide ops ------------------------------------------------

    def fed_snapshot(self) -> bytes:
        snaps = {self.host: self.broker.snapshot()}
        for h, client in sorted(self._peers.items()):
            _, snap = client.request({"op": "snapshot", "fed": True},
                                     retry=True)
            snaps[h] = snap
        return dump_fed_snapshot(snaps)

    def fed_restore(self, payload: bytes, expire_leases: bool) -> None:
        # control-plane decode: the payload IS a federation snapshot
        # bundle this layer owns, not a relayed task envelope
        # fabriclint: skip=frame-header-hygiene -- snapshot bundle, not an envelope
        state = pickle.loads(payload)
        if not is_fed_snapshot(state):
            # a single-broker snapshot restores into the local member
            self.broker.restore(payload, expire_leases)
            return
        if state["fed_snapshot"] != FED_SNAPSHOT_VERSION:
            raise ValueError("unsupported federation snapshot version "
                             f"{state['fed_snapshot']!r}")
        unknown = set(state["hosts"]) - set(self.broker_hosts)
        if unknown:
            raise ValueError(
                f"snapshot names brokers not in this federation: "
                f"{sorted(unknown)}")
        for h, snap in state["hosts"].items():
            if h == self.host:
                self.broker.restore(snap, expire_leases)
            else:
                self._peers[h].request(
                    {"op": "restore", "fed": True,
                     "expire_leases": expire_leases}, snap, retry=True)

    def fed_wake(self) -> None:
        self.broker.wake()
        for client in self._peers.values():
            try:
                client.request({"op": "wake", "fed": True}, retry=True)
            except (ConnectionError, OSError, RuntimeError):
                pass            # dead peer: nothing parked there anyway

    # -- frame dispatch -----------------------------------------------------

    def handle(self, header: dict,
               payload: bytes) -> Optional[Tuple[dict, bytes]]:
        if header.get("fed"):
            # already routed by a peer: strictly local (length-one chains)
            return self.broker.handle(header, payload)
        header = self._route_acks(header)
        op = header["op"]
        # cancel/put_stream/cancelled route like the data-plane ops: a
        # topic's requests/results/stream queues AND its slice of the
        # cancelled window all live at the topic's home broker, so the
        # cancel claim and the completion's fused put-claim arbitrate in
        # one place
        if op in ("put", "get", "len", "renew", "backup",
                  "cancel", "put_stream", "cancelled"):
            h = self.home(header["topic"])
            if h != self.host:
                return self._relay(h, header, payload)
            return self.broker.handle(header, payload)
        if op == "endpoints":
            # advertise the whole federation so clients open their own
            # connection to each topic's home broker (relay chains of
            # length zero on the data plane); the relay path above stays
            # as the compatibility fallback for clients that don't
            import socket as socketlib
            return {"host": self.host, "peers": dict(self.peer_addresses),
                    "partition": dict(self.partition),
                    "machine": socketlib.gethostname(),
                    "scope": self.broker.shm_scope}, b""
        if op == "wake":
            self.fed_wake()
            return {"ok": True}, b""
        if op == "claim":
            h = self.broker_hosts[0]        # the coordinator (see module doc)
            if h != self.host:
                return self._relay(h, header, payload)
            return self.broker.handle(header, payload)
        if op == "snapshot":
            return {"ok": True}, self.fed_snapshot()
        if op == "restore":
            self.fed_restore(payload, header.get("expire_leases", False))
            return {"ok": True}, b""
        # ack (the explicit-flush carrier), ping, shutdown, unknown ops
        return self.broker.handle(header, payload)


def federated_broker_main(sock, host: str, partition: Dict[str, str],
                          peers: Dict[str, tuple],
                          snapshot_every: float = 0.0,
                          snapshot_path: Optional[str] = None,
                          shm_scope: Optional[str] = None) -> None:
    """Entry point of one federation member's broker process.  Only the
    coordinator is given ``snapshot_every``: its auto-snapshot bundles
    the *whole federation* into one resumable file."""
    fb = FederatedBroker(host, partition, peers, shm_scope=shm_scope)
    # identify this member on the fabric timeline; non-coordinators
    # calibrate their clock against the coordinator so the report can
    # compose every process's offset chain to one root
    coord = sorted(peers)[0]
    ref, offset = "", None
    if obs.enabled() and coord != host and coord in fb._peers:
        def _probe() -> float:
            hdr, _ = fb._peers[coord].request({"op": "clock_sync"},
                                              retry=True)
            return float(hdr["t"])
        try:
            offset = obs.calibrate(_probe)
            ref = obs.addr_str(peers[coord])
        except (ConnectionError, OSError, RuntimeError, KeyError,
                TypeError, ValueError):
            offset = None                   # telemetry only: never fatal
    obs.configure(role="broker", host=host,
                  addr=obs.addr_str(peers.get(host, "")),
                  ref=ref, offset=offset)
    stop = threading.Event()
    if snapshot_every and snapshot_path:
        start_autosnapshot(fb.fed_snapshot, snapshot_every, snapshot_path,
                           stop)
    frames.serve_forever(sock, fb.handle, stop)
    fb.broker.release_segments()


__all__ = ["FederatedBroker", "federated_broker_main", "dump_fed_snapshot",
           "is_fed_snapshot", "host_hash_index"]
