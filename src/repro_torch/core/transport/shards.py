"""Sharded Value Server over the socket fabric — durable and elastic.

Each ``ValueServerShard`` is a process holding one ``ValueServer`` (with
its own ``capacity_bytes`` LRU bound and spill-to-disk tier) and serving
it over the frame protocol: values travel as the client's pickle bytes and
are stored *as bytes*, so a shard never re-pickles payloads and the spill
files round-trip byte-identically.

``ShardedValueServer`` is the client: it implements the exact in-process
``ValueServer`` API (put/get/add_ref/release/delete/size_of/prefetch/
stats) so ``ColmenaQueues`` proxies and worker caches are oblivious to the
deployment.  Keys are routed by **consistent hashing** (md5 ring with
virtual nodes over stable shard ids); the client is fork-safe
(``FrameClient`` reopens connections per pid), which is how pool workers
in other processes resolve the same proxies.

Durability (this module's three load-bearing guarantees):

- **Replication** (``replicas=R``): every key is written to the R distinct
  successor shards of its ring position.  The hot path is primary-ack --
  the first live successor acknowledges synchronously, the remaining
  copies fan out through a background replication thread (one FIFO
  thread, so a ``release`` enqueued after a ``put`` can never overtake
  it on a replica); ``put(..., sync=True)`` waits for every copy.
  ``get`` fails over down the successor list when the primary is dead
  (or restarted blank), and refcount ops (``add_ref``/``release``/
  ``delete``) propagate to every replica the same way.  Replica-side
  refcounts are best-effort during membership churn; the surviving
  primary is authoritative and ``rebalance`` re-derives copies from it.
- **Ring rebalancing** (``add_shard``/``remove_shard``/``replace_shard``):
  membership changes recompute the ring and migrate only the keys whose
  replica set actually moved (~1/N of the key space per added shard).
  A spilled key whose source and destination shards share a filesystem
  moves by **renaming its spill file** (`detach_spilled`/`adopt_spilled`
  -- zero payload bytes on the wire); everything else re-puts over the
  frame protocol.  The new ring travels to every shard with a bumped
  ``ring_epoch``; a client still holding the old ring gets a **redirect
  frame** (``{"stale": True, "ring": ...}``) instead of a miss, adopts
  the new ring, and retries -- connected clients converge without any
  out-of-band coordination.
- **Snapshot/restore**: ``snapshot()`` bundles every shard's store (both
  tiers, deduplicated across replicas, sorted -- identical contents give
  identical bytes) into one blob; ``restore()`` re-puts each entry
  through the *current* ring with full-sync replication, so a checkpoint
  taken on one topology restores onto another.  This is what lifts the
  "checkpointing requires inline payloads" restriction:
  ``ColmenaQueues.checkpoint`` captures the Value Server alongside the
  queue fabric and a resumed campaign's restored proxies resolve.
"""
from __future__ import annotations

import atexit
import bisect
import hashlib
import multiprocessing
import os
import pickle
import queue
import tempfile
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple
import uuid

from repro_torch.core.transport import frames, ndcodec

_mp = multiprocessing.get_context("fork")

VS_SNAPSHOT_VERSION = 1

#: shard ops routed by key: these carry the client's ring epoch and are
#: answered with a redirect frame when the client's ring is stale
ROUTED_OPS = frozenset({"vs_put", "vs_get", "vs_add_ref", "vs_release",
                        "vs_delete", "vs_size_of", "vs_contains",
                        "vs_export"})

#: how long a shard holds a ``vs_get`` reply for a key a migration
#: announced but has not delivered (vs_expect without vs_end_expect --
#: the migration manager died); bounds the worst-case client stall
EXPECT_WAIT = 30.0


class HashRing:
    """Consistent-hash ring over *stable shard ids* (md5, virtual nodes).

    ``nodes`` may be an int (ids ``0..n-1``, the original positional
    form) or an explicit id list -- ids survive membership changes, so
    removing shard 1 from ``[0, 1, 2]`` leaves keys homed at 0 and 2
    untouched."""

    def __init__(self, nodes, vnodes: int = 64):
        if isinstance(nodes, int):
            nodes = list(range(nodes))
        self.node_ids = list(nodes)
        points: List[Tuple[int, int]] = []
        for node in self.node_ids:
            for v in range(vnodes):
                h = hashlib.md5(f"shard-{node}:{v}".encode()).digest()
                points.append((int.from_bytes(h[:8], "big"), node))
        points.sort()
        self._hashes = [p[0] for p in points]
        self._nodes = [p[1] for p in points]

    def _pos(self, key: str) -> int:
        h = int.from_bytes(
            hashlib.md5(key.encode()).digest()[:8], "big")
        return bisect.bisect(self._hashes, h) % len(self._hashes)

    def node(self, key: str) -> int:
        return self._nodes[self._pos(key)]

    def nodes(self, key: str, n: int) -> List[int]:
        """The first ``n`` *distinct* shards clockwise from the key's
        ring position -- the key's replica set, primary first.  Walking
        the same ring every client derives from the same member list is
        what makes replica placement agreement total."""
        n = min(n, len(set(self.node_ids)))
        i = self._pos(key)
        out: List[int] = []
        for step in range(len(self._nodes)):
            cand = self._nodes[(i + step) % len(self._nodes)]
            if cand not in out:
                out.append(cand)
                if len(out) == n:
                    break
        return out


# ---------------------------------------------------------------------------
# Shard server process
# ---------------------------------------------------------------------------


def _shard_main(sock, capacity_bytes: Optional[int], spill_dir: Optional[str],
                fetch_bandwidth: Optional[float]) -> None:
    from repro_torch.core.value_server import ValueServer
    vs = ValueServer(capacity_bytes=capacity_bytes, spill_dir=spill_dir,
                     fetch_bandwidth=fetch_bandwidth)
    # the ring this shard believes is current ({"epoch", "members",
    # "replicas"}), pushed by whoever drives membership (owner client or
    # cluster launcher).  None = pre-ring deployment: no staleness checks.
    state = {"ring": None}
    # keys a migration has announced as incoming (``vs_expect``): a get
    # for one of them holds its reply until the copy lands or the
    # migration window closes, instead of answering a transient miss
    # that a replicas=1 deployment has no fallback for.  serve_forever
    # is thread-per-connection, so a held reply blocks only its caller.
    expect = {"keys": set(), "epoch": -1}
    expect_cond = threading.Condition()

    def _landed(key) -> None:
        with expect_cond:
            if key in expect["keys"]:
                expect["keys"].discard(key)
                expect_cond.notify_all()

    def handle(header: dict, payload: bytes):
        op = header["op"]
        ring = state["ring"]
        epoch = header.get("epoch")
        if (ring is not None and epoch is not None and op in ROUTED_OPS
                and epoch < ring["epoch"]):
            # the client routed this with an outdated ring: hand it the
            # current one instead of a wrong-shard miss (or worse, a
            # write landing outside the key's replica set)
            return {"stale": True, "ring": ring}, b""
        if op == "vs_put":
            # stored as the client's pickle bytes: never re-pickled here
            key = vs.put(payload, size=header["size"], refs=header["refs"],
                         key=header["key"])
            _landed(key)
            return {"key": key}, b""
        if op == "vs_get":
            key = header["key"]
            while True:
                try:
                    return {"ok": True}, vs.get(key)
                except KeyError:
                    with expect_cond:
                        if key not in expect["keys"]:
                            return {"ok": False}, b""
                        if not expect_cond.wait(timeout=EXPECT_WAIT):
                            # window never closed (migration manager
                            # died pre-end_expect): stop holding gets
                            expect["keys"].discard(key)
                            return {"ok": False}, b""
        if op == "vs_add_ref":
            vs.add_ref(header["key"])
            return {"ok": True}, b""
        if op == "vs_release":
            return {"deleted": vs.release(header["key"])}, b""
        if op == "vs_delete":
            vs.delete(header["key"])
            return {"ok": True}, b""
        if op == "vs_size_of":
            try:
                return {"size": vs.size_of(header["key"])}, b""
            except KeyError:
                return {"size": None}, b""
        if op == "vs_contains":
            return {"in": header["key"] in vs}, b""
        if op == "vs_export":
            # migration source: the stored bytes plus the metadata the
            # destination's vs_put needs (refs travel with the copy).
            # peek, not get: exporting must not fault a spilled entry
            # into memory (evicting others / deleting its disk copy)
            try:
                data, size, refs = vs.peek(header["key"])
            except KeyError:
                return {"ok": False}, b""
            return {"ok": True, "size": size, "refs": refs}, data
        if op == "vs_keys":
            return {"keys": vs.keys_info()}, b""
        if op == "vs_detach_spill":
            try:
                size, refs = vs.detach_spilled(header["key"])
            except KeyError:
                return {"ok": False}, b""
            return {"ok": True, "size": size, "refs": refs}, b""
        if op == "vs_adopt_spill":
            vs.adopt_spilled(header["key"], header["size"], header["refs"])
            _landed(header["key"])
            return {"ok": True}, b""
        if op == "vs_expect":
            # migration preamble, sent BEFORE the ring push: these keys
            # are on their way here.  Epoch-guarded set union, so a
            # replayed announcement (or one racing a newer migration)
            # converges instead of resurrecting a closed window.
            with expect_cond:
                if header["epoch"] >= expect["epoch"]:
                    expect["epoch"] = header["epoch"]
                    expect["keys"].update(header["keys"])
            return {"ok": True}, b""
        if op == "vs_end_expect":
            # migration postamble (finally-block): whatever did not land
            # is not coming -- release every held get to answer its miss
            with expect_cond:
                if header["epoch"] >= expect["epoch"]:
                    expect["keys"].clear()
                expect_cond.notify_all()
            return {"ok": True}, b""
        if op == "vs_ring":
            return {"ring": state["ring"]}, b""
        if op == "vs_set_ring":
            new = header["ring"]
            cur = state["ring"]
            if cur is None or new["epoch"] >= cur["epoch"]:
                state["ring"] = new
            return {"ok": True, "epoch": state["ring"]["epoch"]}, b""
        if op == "vs_snapshot":
            return {"ok": True}, vs.snapshot()
        # (no per-shard restore op: ShardedValueServer.restore re-puts
        # through the ring so copies land replicated at current homes --
        # a shard-local restore would bypass both)
        if op == "vs_stats":
            return {"stats": dict(vs.stats), "len": len(vs),
                    "bytes": vs.total_bytes,
                    "spilled_bytes": vs.spilled_bytes}, b""
        if op == "ping":
            return {"ok": True}, b""
        if op == "shutdown":
            return None
        return {"error": f"unknown op {op!r}"}, b""

    frames.serve_forever(sock, handle, threading.Event())


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------


class ShardedValueServer:
    """Drop-in ValueServer client routing keys to shard processes.

    ``capacity_bytes`` is **per shard**; with ``spill=True`` each shard
    gets its own spill directory under a shared temp root, so the
    aggregate working set is ``num_shards * capacity_bytes`` in memory
    plus unbounded disk.  ``replicas=R`` stores every key on its R ring
    successors (see module docstring); ``len()`` and the byte totals
    count stored *copies*, so they scale with R."""

    def __init__(self, num_shards: int = 2, *,
                 capacity_bytes: Optional[int] = None,
                 spill: bool = False,
                 fetch_bandwidth: Optional[float] = None,
                 vnodes: int = 64,
                 replicas: int = 1,
                 array_codec: bool = True):
        assert num_shards >= 1
        assert 1 <= replicas
        self.replicas = replicas
        self.array_codec = array_codec
        self.vnodes = vnodes
        self._dir = tempfile.mkdtemp(prefix="colmena-vs-")
        self._owner_pid = os.getpid()
        self._capacity_bytes = capacity_bytes
        self._spill = spill
        self._fetch_bandwidth = fetch_bandwidth
        self._procs: Dict[int, _mp.Process] = {}
        self._clients: Dict[int, frames.FrameClient] = {}
        self._spill_dirs: Dict[int, Optional[str]] = {}
        self._init_client_state()
        members = [(i, self._spawn(i)) for i in range(num_shards)]
        self._install_ring(members, 1)
        self._push_ring(members)
        atexit.register(self.shutdown)

    def _init_client_state(self) -> None:
        self._meta_lock = threading.RLock()
        self._resolver: Optional[ThreadPoolExecutor] = None
        self._resolver_pid = None
        self._repl_q = None
        self._repl_pid = None
        # client-side durability counters (per process)
        self.client_stats = {"failovers": 0, "replica_reads": 0,
                             "redirects": 0, "repl_errors": 0,
                             "repl_stale_drops": 0, "migrate_renames": 0,
                             "migrate_reputs": 0, "migrated_keys": 0}

    @classmethod
    def connect(cls, addresses: List[tuple], vnodes: int = 64,
                replicas: Optional[int] = None,
                array_codec: bool = True) -> "ShardedValueServer":
        """Attach to already-running shard processes (a cluster
        launcher's) instead of spawning them.  The client first asks the
        shards for the current ring (``vs_ring``): if one was pushed
        (epoch, stable ids, replica factor), every connected client
        adopts the *same* membership regardless of the order its address
        list came in.  Pre-ring shards fall back to the positional rule:
        every client must then pass the same ordered address list.
        ``shutdown`` on a connected client is a no-op -- the launcher
        owns the shard processes."""
        assert addresses, "connect() needs at least one shard address"
        self = cls.__new__(cls)
        self.array_codec = array_codec
        self.vnodes = vnodes
        self._dir = None
        self._owner_pid = None              # not ours to shut down
        self._capacity_bytes = None
        self._spill = False
        self._fetch_bandwidth = None
        self._procs = {}
        self._clients = {}
        self._spill_dirs = {}
        self._init_client_state()
        ring = None
        for a in addresses:
            try:
                header, _ = frames.FrameClient(tuple(a)).request(
                    {"op": "vs_ring"}, retry=True)
            except (ConnectionError, OSError):
                continue                    # dead shard: ask the next one
            ring = header.get("ring")
            if ring is not None:
                break
            # reachable but ringless (e.g. a replacement forked just
            # before the rebalance pushed): keep asking -- adopting the
            # positional fallback while a pushed ring exists elsewhere
            # would route this client differently from every other one
        if ring is not None:
            self.replicas = (replicas if replicas is not None
                             else ring.get("replicas", 1))
            self._install_ring([(sid, tuple(ad))
                                for sid, ad in ring["members"]],
                               ring["epoch"])
        else:
            self.replicas = replicas or 1
            self._install_ring([(i, tuple(a))
                                for i, a in enumerate(addresses)], 0)
        return self

    # -- membership plumbing --------------------------------------------------

    def _spawn(self, sid: int) -> tuple:
        """Fork one shard process (owner mode only); returns its address."""
        sock, address = frames.make_server_socket(
            os.path.join(self._dir, f"shard{sid}.sock"))
        spill_dir = (os.path.join(self._dir, f"spill{sid}")
                     if self._spill else None)
        p = _mp.Process(target=_shard_main,
                        args=(sock, self._capacity_bytes, spill_dir,
                              self._fetch_bandwidth),
                        daemon=True, name=f"colmena-vs-shard{sid}")
        p.start()
        sock.close()
        self._procs[sid] = p
        self._spill_dirs[sid] = spill_dir
        self._clients[sid] = frames.FrameClient(address)
        return address

    def _install_ring(self, members: List[tuple], epoch: int) -> None:
        """Adopt a membership: (sid, address) list + epoch.  Clients for
        departed members are kept around (a rebalance still drains them;
        they are closed at shutdown)."""
        with self._meta_lock:
            self._members = [(sid, tuple(addr)) for sid, addr in members]
            self._epoch = epoch
            self._ring = HashRing([sid for sid, _ in self._members],
                                  vnodes=self.vnodes)
            for sid, addr in self._members:
                cur = self._clients.get(sid)
                if cur is None or tuple(cur.address) != addr:
                    # also replaces a client whose sid was *reused* at a
                    # new address (remove then add): keeping the stale
                    # FrameClient would dial a dead socket forever
                    if cur is not None:
                        cur.close()
                    self._clients[sid] = frames.FrameClient(addr)
            self.num_shards = len(self._members)

    def _ring_message(self) -> dict:
        with self._meta_lock:
            return {"epoch": self._epoch,
                    "members": list(self._members),
                    "replicas": self.replicas}

    def _push_ring(self, targets: List[tuple]) -> None:
        """Install the current ring on every reachable shard in
        ``targets`` ((sid, addr) pairs) so stale clients get redirected
        rather than mis-routed."""
        msg = self._ring_message()
        for sid, _ in targets:
            try:
                self._clients[sid].request(
                    {"op": "vs_set_ring", "ring": msg}, retry=True)
            except (ConnectionError, OSError):
                pass                        # dead shard: nothing to redirect

    def _adopt(self, ring: dict) -> None:
        """Apply a redirect frame's ring (newer epochs only)."""
        with self._meta_lock:
            if ring["epoch"] > self._epoch:
                self.replicas = ring.get("replicas", self.replicas)
                self._install_ring(ring["members"], ring["epoch"])
                self.client_stats["redirects"] += 1

    def _refresh_ring(self) -> bool:
        """Ask the live membership for a newer ring; True if one was
        adopted.  Redirect frames only arrive from members a request
        *reaches* -- a stale client whose key's whole (old) replica set
        departed would otherwise dial dead sockets forever, so the
        total-unreachability path asks everyone else before giving up."""
        for sid, _ in list(self._members):
            try:
                h, _ = self._clients[sid].request({"op": "vs_ring"})
            except (ConnectionError, OSError, RuntimeError):
                continue
            ring = h.get("ring")
            if ring is not None and ring["epoch"] > self._epoch:
                self._adopt(ring)
                return True
        return False

    def _replica_set(self, key: str) -> List[int]:
        with self._meta_lock:
            return self._ring.nodes(key, min(self.replicas,
                                             len(self._members)))

    def _send(self, sid: int, header: dict, payload: bytes = b"",
              retry: bool = False) -> Tuple[dict, bytes]:
        header = dict(header)
        header["epoch"] = self._epoch
        return self._clients[sid].request(header, payload, retry=retry)

    def shard_of(self, key: str) -> int:
        return self._replica_set(key)[0]

    # -- background replication (FIFO: ops on one key cannot reorder) --------

    def _repl_queue(self) -> "queue.SimpleQueue":
        # per-process, like the resolver: a forked worker builds its own.
        # Creation is guarded: two threads racing the lazy init would
        # split the fan-out across two FIFOs, and a release drained from
        # one queue could overtake its put waiting in the other
        with self._meta_lock:
            if self._repl_q is None or self._repl_pid != os.getpid():
                self._repl_q = queue.SimpleQueue()
                self._repl_pid = os.getpid()
                threading.Thread(target=self._repl_loop,
                                 args=(self._repl_q,),
                                 daemon=True, name="vs-repl").start()
            return self._repl_q

    def _repl_loop(self, q) -> None:
        while True:
            item = q.get()
            if item is None:
                return                      # close/shutdown sentinel
            if isinstance(item, threading.Event):
                item.set()                  # flush_replication barrier
                continue
            sid, header, payload = item
            try:
                h, _ = self._send(sid, header, payload)
                if h.get("stale"):
                    # membership changed under the queued op: adopt the
                    # ring and let rebalance re-derive the copy (re-fanning
                    # a release here could double-apply it)
                    self._adopt(h["ring"])
                    self.client_stats["repl_stale_drops"] += 1
            except (ConnectionError, OSError, RuntimeError):
                self.client_stats["repl_errors"] += 1

    def _repl_enqueue(self, sid: int, header: dict,
                      payload: bytes = b"") -> None:
        self._repl_queue().put((sid, header, payload))

    def flush_replication(self, timeout: float = 30.0) -> bool:
        """Barrier: wait until every queued replica op has been applied
        (or failed).  ``snapshot`` and ``rebalance`` call this so they
        observe settled replicas; tests use it for determinism."""
        if self._repl_q is None or self._repl_pid != os.getpid():
            return True
        ev = threading.Event()
        self._repl_q.put(ev)
        return ev.wait(timeout)

    # -- ValueServer API ------------------------------------------------------

    def put(self, value, *, size: Optional[int] = None, refs: int = 0,
            sync: bool = False) -> str:
        # dense arrays (numpy / jax device arrays) take the typed codec
        # path: raw buffer behind a dtype/shape header, never a pickle
        # of the array body (ndcodec module docstring).  Everything else
        # pickles as before; the formats self-describe, so readers need
        # no flag agreement with the writer.
        data = ndcodec.encode(value) if self.array_codec else None
        if data is None:
            data = pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)
        if size is None:
            size = len(data)
        # key is minted client-side so routing needs no coordination; the
        # shard adopts it verbatim
        key = uuid.uuid4().hex
        self._put_bytes(key, data, size, refs, sync=sync)
        return key

    def _write_op(self, key: str, header: dict, payload: bytes = b"",
                  sync: bool = False, retry: bool = False) -> dict:
        """Primary-ack write loop shared by put and the refcount ops
        (the write-side sibling of ``_read_op``): the first live shard
        of the replica set that can apply the op acknowledges
        synchronously -- a dead successor fails over to the next, and so
        does one that answers with a server-side error (a blank restarted
        primary raising KeyError for ``add_ref`` must not shadow a
        replica that holds the copy; the error is re-raised only when NO
        replica could apply, preserving single-shard semantics).  The
        remaining copies fan out asynchronously in replication-queue
        order, or inline with ``sync=True`` -- where a stale-ring
        redirect re-runs the whole fan-out (idempotent) rather than
        silently under-replicating a "full-sync" write.  ``retry``
        reconnect-and-resends dropped sockets (idempotent ops only)."""
        for _ in range(4):
            targets = self._replica_set(key)
            resp = None
            rest: List[int] = []
            stale = None
            last_err = None
            for sid in targets:
                if resp is not None:
                    rest.append(sid)
                    continue
                try:
                    h, _ = self._send(sid, header, payload, retry=retry)
                except (ConnectionError, OSError):
                    self.client_stats["failovers"] += 1
                    continue                # dead successor: next one acks
                except RuntimeError as e:
                    last_err = e            # alive but cannot apply
                    self.client_stats["failovers"] += 1
                    continue
                if h.get("stale"):
                    stale = h["ring"]
                    break
                resp = h
            if stale is not None:
                self._adopt(stale)
                continue
            if resp is None:
                if last_err is not None:
                    raise last_err
                if self._refresh_ring():    # see _read_op: stale set dead
                    continue
                raise ConnectionError(
                    f"every replica of key {key!r} is unreachable")
            for sid in rest:
                if sync:
                    try:
                        h, _ = self._send(sid, header, payload)
                    except (ConnectionError, OSError, RuntimeError):
                        self.client_stats["repl_errors"] += 1
                        continue
                    if h.get("stale"):
                        stale = h["ring"]
                        break
                else:
                    self._repl_enqueue(sid, header, payload)
            if stale is not None:
                self._adopt(stale)
                continue
            return resp
        raise RuntimeError("ring membership kept changing during "
                           + header["op"])

    def _put_bytes(self, key: str, data: bytes, size: int, refs: int,
                   sync: bool = False) -> None:
        self._write_op(key, {"op": "vs_put", "key": key, "size": size,
                             "refs": refs}, data, sync=sync)

    _MISS = object()                        # sentinel: replica can't answer

    def _read_op(self, key: str, header: dict, hit):
        """Shared read-side failover loop (get / size_of / contains):
        walk the key's replica set in order, failing over past dead
        shards, adopting stale-ring redirects and retrying (max 4
        membership changes), raising ConnectionError when no replica is
        reachable and KeyError when every live replica misses.  A miss
        on one replica is never authoritative -- a restarted (blank)
        primary must not shadow a live replica's copy.  ``hit(resp,
        payload, i)`` extracts the answer or returns ``_MISS``."""
        for _ in range(4):
            stale = None
            alive = 0
            for i, sid in enumerate(self._replica_set(key)):
                try:
                    # fabriclint: retry-ops=vs_get,vs_size_of,vs_contains
                    h, payload = self._send(sid, header, retry=True)
                except (ConnectionError, OSError):
                    self.client_stats["failovers"] += 1
                    continue                # dead replica: try the next
                if h.get("stale"):
                    stale = h["ring"]
                    break
                alive += 1
                out = hit(h, payload, i)
                if out is not self._MISS:
                    return out
            if stale is not None:
                self._adopt(stale)
                continue
            if alive == 0:
                # the whole (possibly stale) replica set is dead: a
                # membership change may have moved the key -- learn the
                # current ring from any live member before giving up
                if self._refresh_ring():
                    continue
                raise ConnectionError(
                    f"every replica of key {key!r} is unreachable")
            raise KeyError(key)
        raise RuntimeError("ring membership kept changing during "
                           + header["op"])

    def get(self, key: str):
        # ndcodec.decode falls through to pickle.loads for plain
        # pickles, so a codec-off writer and codec-on reader (or the
        # reverse) always interoperate
        return ndcodec.decode(self._get_bytes(key))

    def _get_bytes(self, key: str) -> bytes:
        def hit(h, payload, i):
            if not h["ok"]:
                return self._MISS
            if i > 0:
                self.client_stats["replica_reads"] += 1
            return payload

        return self._read_op(key, {"op": "vs_get", "key": key}, hit)

    def add_ref(self, key: str) -> None:
        self._write_op(key, {"op": "vs_add_ref", "key": key})

    def release(self, key: str) -> bool:
        return self._write_op(
            key, {"op": "vs_release", "key": key})["deleted"]

    def delete(self, key: str) -> None:
        self._write_op(key, {"op": "vs_delete", "key": key}, retry=True)

    def size_of(self, key: str) -> int:
        return self._read_op(
            key, {"op": "vs_size_of", "key": key},
            lambda h, _p, _i: h["size"] if h["size"] is not None
            else self._MISS)

    def __contains__(self, key: str) -> bool:
        # every-live-replica-misses is a definitive "absent" here (the
        # KeyError becomes False); an unreachable replica set still
        # raises ConnectionError -- an outage is not evidence of
        # deletion, and a False could make a caller drop or resubmit a
        # payload that survived
        try:
            return self._read_op(
                key, {"op": "vs_contains", "key": key},
                lambda h, _p, _i: True if h["in"] else self._MISS)
        except KeyError:
            return False

    def prefetch(self, key: str) -> Future:
        # the executor is per-process: a forked worker lazily builds its
        # own.  Guarded like _repl_queue -- two racing prefetch calls must
        # not each build an executor (the loser's 4 threads would leak)
        with self._meta_lock:
            if self._resolver is None or self._resolver_pid != os.getpid():
                self._resolver = ThreadPoolExecutor(
                    max_workers=4, thread_name_prefix="vs-resolve")
                self._resolver_pid = os.getpid()
            resolver = self._resolver
        return resolver.submit(self.get, key)

    # -- membership changes / rebalancing -------------------------------------

    def add_shard(self, address: Optional[tuple] = None) -> Tuple[int, int]:
        """Grow the ring by one shard: spawn a process (owner mode,
        ``address=None``) or adopt an externally started one.  Returns
        ``(new_sid, keys_migrated)`` -- the consistent ring bounds the
        migration to ~1/N of the key space."""
        with self._meta_lock:
            new_sid = max(sid for sid, _ in self._members) + 1
            if address is None:
                assert self._dir is not None, \
                    "a connected client adds externally started shards: " \
                    "pass address="
                address = self._spawn(new_sid)
            else:
                address = tuple(address)
                self._clients[new_sid] = frames.FrameClient(address)
            new_members = self._members + [(new_sid, address)]
        moved = self._rebalance(new_members)
        return new_sid, moved

    def remove_shard(self, sid: int) -> int:
        """Shrink the ring: drain the shard's keys to their new homes
        (when it is still reachable -- a dead shard's keys are re-derived
        from replicas), then drop it from membership.  Owner mode also
        stops the process.  Returns the number of keys migrated."""
        with self._meta_lock:
            new_members = [m for m in self._members if m[0] != sid]
            assert new_members, "cannot remove the last shard"
        unreachable = set() if self._probe(sid) else {sid}
        moved = self._rebalance(new_members, unreachable=unreachable)
        self._stop_shard(sid)
        return moved

    def replace_shard(self, dead_sid: int,
                      address: Optional[tuple] = None) -> int:
        """Swap a (typically dead) shard for a fresh one in a single
        rebalance: the replacement joins the ring, lost copies are
        re-replicated from survivors, and the dead member leaves.
        Returns the new shard's sid."""
        with self._meta_lock:
            new_sid = max(sid for sid, _ in self._members) + 1
            if address is None:
                assert self._dir is not None, \
                    "a connected client replaces with an externally " \
                    "started shard: pass address="
                address = self._spawn(new_sid)
            else:
                address = tuple(address)
                self._clients[new_sid] = frames.FrameClient(address)
            new_members = ([m for m in self._members if m[0] != dead_sid]
                           + [(new_sid, address)])
        unreachable = set() if self._probe(dead_sid) else {dead_sid}
        self._rebalance(new_members, unreachable=unreachable)
        self._stop_shard(dead_sid)
        return new_sid

    def _probe(self, sid: int) -> bool:
        client = self._clients.get(sid)
        if client is None:
            return False
        return client.probe()

    def _stop_shard(self, sid: int) -> None:
        p = self._procs.pop(sid, None)
        if p is None:
            return
        try:
            self._clients[sid].request({"op": "shutdown"})
        except (ConnectionError, OSError):
            pass
        p.join(timeout=2)
        if p.is_alive():
            p.terminate()

    def terminate_shard(self, sid: int) -> None:
        """Chaos helper (owner mode): SIGKILL one shard process -- the
        node-loss failure the replication/failover paths exist for."""
        p = self._procs.get(sid)
        assert p is not None, f"shard {sid} is not owned by this client"
        p.kill()
        p.join(timeout=2)

    def _rebalance(self, new_members: List[tuple],
                   unreachable: frozenset = frozenset()) -> int:
        """Adopt ``new_members``, push the bumped ring to every shard,
        and migrate exactly the copies whose replica set changed.

        Ordering: the old members are inventoried and every receiving
        shard is told which keys are incoming (``vs_expect``) *before*
        the bumped ring is pushed and any data moves -- so from the very
        first frame a redirected client can route by the new ring, a
        mid-move ``get`` of a not-yet-landed key **blocks at its new
        home until the copy arrives** instead of answering a transient
        miss (which a replicas=1 deployment has no replica to absorb).
        The expect window is closed in a ``finally`` (``vs_end_expect``)
        so keys whose transfer failed answer their miss instead of
        stalling gets until the shard-side timeout.  Concurrent *puts*
        remain subject to the quiesced-point caveat: a put landing on a
        departing member between the inventory and the ring push is
        invisible to this migration (campaigns drive membership changes
        from launcher restart / resume, where no puts are in flight)."""
        self.flush_replication()
        with self._meta_lock:
            old_members = list(self._members)
            self._install_ring(new_members, self._epoch + 1)
            epoch = self._epoch
            push_targets = {sid: addr for sid, addr in old_members}
            push_targets.update(dict(self._members))
        # inventory: key -> holders (replicas disagree only transiently;
        # refs take the max so a pinned copy can never lose its pin)
        holders: Dict[str, dict] = {}
        for sid, _ in old_members:
            if sid in unreachable:
                continue
            try:
                h, _ = self._send(sid, {"op": "vs_keys"}, retry=True)
            except (ConnectionError, OSError):
                continue
            for key, size, refs, tier in h["keys"]:
                info = holders.setdefault(
                    key, {"size": size, "refs": refs, "tiers": {}})
                info["refs"] = max(info["refs"], refs)
                info["tiers"][sid] = tier
        R = min(self.replicas, len(new_members))
        incoming: Dict[int, set] = {}
        for key, info in holders.items():
            for dst in self._ring.nodes(key, R):
                if dst not in info["tiers"]:
                    incoming.setdefault(dst, set()).add(key)
        announced: List[int] = []
        for dst in sorted(incoming):
            try:
                self._send(dst, {"op": "vs_expect", "epoch": epoch,
                                 "keys": sorted(incoming[dst])},
                           retry=True)
                announced.append(dst)
            except (ConnectionError, OSError, RuntimeError):
                pass                # unreachable dst: transfers fail too
        moved = 0
        try:
            self._push_ring(sorted(push_targets.items()))
            for key, info in holders.items():
                new_set = self._ring.nodes(key, R)
                have = info["tiers"]
                placed = sum(1 for s in new_set if s in have)
                for dst in new_set:
                    if dst in have:
                        continue
                    src = next((s for s in new_set if s in have),
                               next(iter(have)))
                    if self._transfer(key, src, dst, info["size"],
                                      info["refs"], have[src]):
                        moved += 1
                        placed += 1
                if placed == 0:
                    # every transfer into the new replica set failed
                    # (e.g. the new home is momentarily unreachable):
                    # deleting the departing copies now would destroy
                    # the key's ONLY copies -- leave them where they
                    # are; a later rebalance re-derives placement from
                    # the surviving holders
                    continue
                for sid in set(have) - set(new_set):
                    try:
                        self._send(sid, {"op": "vs_delete", "key": key})
                    except (ConnectionError, OSError):
                        pass
        finally:
            for dst in announced:
                try:
                    self._send(dst, {"op": "vs_end_expect",
                                     "epoch": epoch}, retry=True)
                except (ConnectionError, OSError, RuntimeError):
                    pass
        self.client_stats["migrated_keys"] += moved
        return moved

    def _transfer(self, key: str, src: int, dst: int, size: int, refs: int,
                  tier: str) -> bool:
        """Move one copy.  Spill-tier fast path: when both shards'
        spill dirs are co-located (owner mode), the spill file is
        *renamed* into the destination and adopted -- no payload bytes
        cross a socket.  Otherwise the copy re-puts over the frame
        protocol."""
        src_dir = self._spill_dirs.get(src)
        dst_dir = self._spill_dirs.get(dst)
        if tier == "spill" and src_dir and dst_dir:
            src_path = os.path.join(src_dir, key + ".pkl")
            dst_path = os.path.join(dst_dir, key + ".pkl")
            detached = False
            try:
                h, _ = self._send(src, {"op": "vs_detach_spill", "key": key})
                if h.get("ok"):
                    detached = True
                    os.rename(src_path, dst_path)
                    self._send(dst, {"op": "vs_adopt_spill", "key": key,
                                     "size": h["size"], "refs": h["refs"]})
                    self.client_stats["migrate_renames"] += 1
                    return True
            except (ConnectionError, OSError, RuntimeError):
                # a detached-but-not-adopted key is registered NOWHERE: it
                # must be re-attached at the source before the re-put
                # fallback, or a replicas=1 migration would lose its only
                # copy (the file would sit orphaned on disk forever)
                if detached:
                    try:
                        if os.path.exists(dst_path):
                            os.rename(dst_path, src_path)
                        self._send(src, {"op": "vs_adopt_spill", "key": key,
                                         "size": h["size"],
                                         "refs": h["refs"]})
                    except (ConnectionError, OSError, RuntimeError):
                        return False        # source gone too: unrecoverable
        try:
            h, payload = self._send(src, {"op": "vs_export", "key": key},
                                    retry=True)
            if not h.get("ok"):
                return False
            h2, _ = self._send(dst, {"op": "vs_put", "key": key,
                                     "size": h["size"], "refs": refs},
                               payload)
            if "key" not in h2:
                # a stale-ring redirect (another manager raced this
                # rebalance): the copy was NOT stored -- counting it
                # would let the caller delete the only real copies
                return False
        except (ConnectionError, OSError, RuntimeError):
            return False
        self.client_stats["migrate_reputs"] += 1
        return True

    # -- snapshot / restore ---------------------------------------------------

    def snapshot(self) -> bytes:
        """One deterministic blob for the whole ring: every shard's
        store (both tiers), deduplicated across replicas (max refs wins
        -- a lagging replica can never strip a pin), sorted by key.  A
        dead shard contributes nothing *only when the replica factor
        covers it*: with ``replicas`` unreachable members the missing
        keys could have no surviving copy, and writing that image would
        atomically overwrite the last complete checkpoint with a
        silently incomplete one -- so that raises instead."""
        self.flush_replication()
        entries: Dict[str, tuple] = {}
        unreachable = []
        for sid, _ in self._members:
            try:
                _, blob = self._send(sid, {"op": "vs_snapshot"}, retry=True)
            except (ConnectionError, OSError):
                unreachable.append(sid)
                continue
            for key, data, size, refs in pickle.loads(blob)["entries"]:
                cur = entries.get(key)
                if cur is None or refs > cur[3]:
                    entries[key] = (key, data, size, refs)
        if len(unreachable) >= self.replicas:
            raise ConnectionError(
                f"shards {unreachable} unreachable with replicas="
                f"{self.replicas}: a snapshot taken now could be missing"
                " keys with no surviving copy -- refusing to write an"
                " incomplete checkpoint")
        return pickle.dumps(
            {"version": VS_SNAPSHOT_VERSION, "sharded": True,
             "entries": [entries[k] for k in sorted(entries)]},
            protocol=pickle.HIGHEST_PROTOCOL)

    def restore(self, data: bytes) -> int:
        """Re-put every snapshot entry through the *current* ring with
        full-sync replication -- the restoring topology may have a
        different shard count or replica factor than the one that took
        the snapshot.  A plain (in-process) ValueServer snapshot is
        accepted too: its entry values are live objects and get pickled
        on the way in, so a local-backend checkpoint restores onto a
        sharded deployment."""
        state = pickle.loads(data)
        if state.get("version") != VS_SNAPSHOT_VERSION:
            raise ValueError("unsupported value-server snapshot version "
                             f"{state.get('version')!r}")
        sharded = state.get("sharded", False)
        for key, blob, size, refs in state["entries"]:
            if not sharded:
                blob = pickle.dumps(blob, protocol=pickle.HIGHEST_PROTOCOL)
            self._put_bytes(key, blob, size, refs, sync=True)
        return len(state["entries"])

    # -- introspection --------------------------------------------------------

    def per_shard_stats(self) -> List[dict]:
        out = []
        for sid, _ in self._members:
            try:
                header, _ = self._send(sid, {"op": "vs_stats"}, retry=True)
            except (ConnectionError, OSError):
                # introspection must tolerate the node-loss states the
                # data path fails over through: a dead member reports
                # zeros (flagged), it doesn't crash monitoring code
                out.append({"sid": sid, "dead": True, "len": 0,
                            "bytes": 0, "spilled_bytes": 0})
                continue
            out.append({"sid": sid, "len": header["len"],
                        "bytes": header["bytes"],
                        "spilled_bytes": header["spilled_bytes"],
                        **header["stats"]})
        return out

    @property
    def stats(self) -> Dict[str, int]:
        # aggregate only the counters the in-process ValueServer.stats has
        # (len/bytes/spilled_bytes live on their own properties), keeping
        # the drop-in key set identical across deployments
        agg: Dict[str, int] = {}
        for s in self.per_shard_stats():
            for k, v in s.items():
                if k in ("sid", "dead", "len", "bytes", "spilled_bytes"):
                    continue
                agg[k] = agg.get(k, 0) + v
        return agg

    def __len__(self) -> int:
        return sum(s["len"] for s in self.per_shard_stats())

    @property
    def total_bytes(self) -> int:
        return sum(s["bytes"] for s in self.per_shard_stats())

    @property
    def spilled_bytes(self) -> int:
        return sum(s["spilled_bytes"] for s in self.per_shard_stats())

    def _stop_repl_thread(self) -> None:
        """Drain-and-stop the background replication thread (queued ops
        apply first -- the sentinel is FIFO behind them).  Without this,
        every client that ever fanned out an async op leaks a daemon
        thread parked on ``q.get()`` that pins the whole object alive."""
        with self._meta_lock:
            q, self._repl_q = self._repl_q, None
            pid, self._repl_pid = self._repl_pid, None
        if q is not None and pid == os.getpid():
            q.put(None)

    def close(self) -> None:
        """Close this client's sockets and stop its replication thread
        (shard processes untouched) -- the counterpart of ``connect``
        for short-lived management clients; owner clients use
        ``shutdown``."""
        self._stop_repl_thread()
        for c in self._clients.values():
            c.close()

    def shutdown(self) -> None:
        if os.getpid() != self._owner_pid or not self._procs:
            return
        self._stop_repl_thread()
        procs, self._procs = dict(self._procs), {}
        for sid, p in procs.items():
            try:
                self._clients[sid].request({"op": "shutdown"})
            except (ConnectionError, OSError):
                pass
        for c in self._clients.values():
            c.close()
        for p in procs.values():
            p.join(timeout=2)
            if p.is_alive():
                p.terminate()
        import shutil
        shutil.rmtree(self._dir, ignore_errors=True)
