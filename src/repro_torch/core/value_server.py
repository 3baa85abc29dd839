"""Value Server with lazy object proxies (paper §III-B3).

Large task inputs/results bypass the Thinker <-> Task Server queue path:
the value is placed in a key-value store and replaced by a small ``Proxy``.
Proxies are lazy -- cheap to serialize and to pass around; the value is
fetched only when first used.  Workers keep a local proxy cache (re-used
inputs such as ML model weights are fetched once per worker) and can
*asynchronously pre-resolve* proxies so the fetch overlaps with task
startup (paper: "communication with the Value Server is overlapped with the
task's execution").

Lifecycle management (long-campaign posture): entries carry a refcount and
the store keeps LRU order.  One-shot payloads created by the queue layer
(``proxy_tree(one_shot=True)``) are pinned with one reference and released
by the consumer once resolved, so per-task inputs/results are deleted
instead of accumulating over a campaign.  Independently, a
``capacity_bytes`` bound evicts least-recently-used *unreferenced* entries
(e.g. superseded model weights) on insert; pinned entries are never
evicted.

Spill tier: with ``spill_dir`` set, capacity evictions land in a file
store (one pickle per key) instead of being discarded, and a later ``get``
faults the entry back into the memory tier byte-identically (possibly
spilling something else to make room).  This turns ``capacity_bytes`` from
a destructive bound into a working-set bound, which is what the sharded
deployment (``transport.shards``) runs per shard.

Spill I/O is **staged outside the store lock**: a fault-in (or eviction
write) marks its key in-flight, releases the lock for the ~ms disk
read/write, and re-acquires it only to publish the entry -- so a shard
thrashing its capacity bound no longer serializes every unrelated
``get``/``put`` behind the disk.  Any operation touching an in-flight key
waits on the store condition until the marker clears, which keeps the
per-key linearizability the locked implementation had (a concurrent
``get`` of a key mid-spill waits and then faults it back; it can never
observe the key missing).

TPU adaptation note (DESIGN.md §2): on a real pod the store holds
device-resident jax.Arrays and resolution is a device-to-device copy; in
this container the store is an in-process dict with a configurable
simulated fetch bandwidth so SynApp can reproduce the paper's Fig. 5/6
crossover behaviour honestly.
"""
from __future__ import annotations

import os
import pickle
import threading
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Iterator, Optional
import uuid

from repro_torch.utils.timing import now


class _Entry:
    __slots__ = ("value", "size", "refs")

    def __init__(self, value, size: int, refs: int):
        self.value = value
        self.size = size
        self.refs = refs


class ValueServer:
    def __init__(self, *, fetch_bandwidth: Optional[float] = None,
                 capacity_bytes: Optional[int] = None,
                 spill_dir: Optional[str] = None):
        """fetch_bandwidth: simulated bytes/s for fetches (None = no wait).
        capacity_bytes: LRU-evict unreferenced entries past this bound
        (None = unbounded, matching the original behaviour).
        spill_dir: evictions spill to files here (created if missing) and
        fault back in on ``get`` instead of being discarded."""
        self._store: "OrderedDict[str, _Entry]" = OrderedDict()
        self._lock = threading.Lock()
        # notified whenever a key's in-flight spill I/O marker clears;
        # shares the store lock so `with self._lock` sections compose
        self._io_done = threading.Condition(self._lock)
        self._io_keys: set = set()          # keys with staged disk I/O
        self._resolver = ThreadPoolExecutor(max_workers=4,
                                            thread_name_prefix="vs-resolve")
        self.fetch_bandwidth = fetch_bandwidth
        self.capacity_bytes = capacity_bytes
        self.spill_dir = spill_dir
        if spill_dir is not None:
            os.makedirs(spill_dir, exist_ok=True)
        self._spilled: dict = {}            # key -> [size, refs]
        self._bytes = 0
        self.stats = {"puts": 0, "gets": 0, "bytes_put": 0, "bytes_get": 0,
                      "evictions": 0, "deletes": 0, "spills": 0,
                      "spill_hits": 0}

    def _await_key_locked(self, key: str) -> None:
        """Block (lock held, released while waiting) until no staged
        spill I/O is in flight for ``key`` -- afterwards the key is back
        in exactly one of the two tiers and the caller can proceed as if
        the I/O had happened atomically."""
        while key in self._io_keys:
            self._io_done.wait()

    def put(self, value, *, size: Optional[int] = None, refs: int = 0,
            key: Optional[str] = None) -> str:
        """key: adopt a caller-minted key (the sharded deployment mints
        keys client-side so consistent-hash routing needs no handshake)."""
        key = key or uuid.uuid4().hex
        if size is None:
            # arrays are sized from their buffer (matching the sharded
            # deployment's typed codec bytes); a pickle of a large device
            # array just to measure it would defeat the pickle-free path
            from repro_torch.core.transport import ndcodec
            size = ndcodec.nbytes_of(value)
            if size is None:
                size = len(pickle.dumps(value,
                                        protocol=pickle.HIGHEST_PROTOCOL))
        with self._lock:
            self._await_key_locked(key)
            # putting over an existing key replaces it wholesale: the old
            # entry's size must leave the accounting (and a stale spill
            # copy must leave the disk), or restore/rebalance re-puts
            # would inflate _bytes until the LRU thrashes live entries
            old = self._store.pop(key, None)
            if old is not None:
                self._bytes -= old.size
            if self._spilled.pop(key, None) is not None:
                self._remove_spill_file(key)
            self._store[key] = _Entry(value, size, refs)
            self._bytes += size
            self.stats["puts"] += 1
            self.stats["bytes_put"] += size
        # capacity enforcement happens after the insert is published: the
        # store can transiently exceed the bound by one entry while the
        # eviction writes its spill file outside the lock
        self._evict(protect=key)
        return key

    def get(self, key: str):
        entry = None
        with self._lock:
            self._await_key_locked(key)
            entry = self._store.get(key)
            if entry is not None:
                self._store.move_to_end(key)
                self.stats["gets"] += 1
                self.stats["bytes_get"] += entry.size
                value, size = entry.value, entry.size
            else:
                if key not in self._spilled:
                    raise KeyError(key)
                # stage the fault-in: claim the key, drop the lock for
                # the disk read, publish the entry on re-acquire --
                # unrelated ops proceed during the read; ops on THIS key
                # wait on the in-flight marker
                size, refs = self._spilled.pop(key)
                self._io_keys.add(key)
        if entry is None:
            try:
                value = self._read_spill(key)
            except BaseException:
                with self._lock:            # undo the claim: still spilled
                    self._spilled[key] = [size, refs]
                    self._io_keys.discard(key)
                    self._io_done.notify_all()
                raise
            self._remove_spill_file(key)
            with self._lock:
                self._store[key] = _Entry(value, size, refs)
                self._bytes += size
                self.stats["spill_hits"] += 1
                self.stats["gets"] += 1
                self.stats["bytes_get"] += size
                self._io_keys.discard(key)
                self._io_done.notify_all()
            self._evict(protect=key)        # may spill something else
        if self.fetch_bandwidth:
            import time
            time.sleep(size / self.fetch_bandwidth)
        return value

    def size_of(self, key: str) -> int:
        with self._lock:
            self._await_key_locked(key)
            if key in self._spilled:
                return self._spilled[key][0]
            return self._store[key].size

    # -- lifetime -----------------------------------------------------------

    def add_ref(self, key: str) -> None:
        with self._lock:
            self._await_key_locked(key)
            spilled = self._spilled.get(key)
            if spilled is not None and key not in self._store:
                # pure metadata update: no reason to pay the disk fault-in
                # here -- the refs ride the spill index and are restored
                # when a get brings the entry back
                spilled[1] += 1
                return
            self._store[key].refs += 1

    def release(self, key: str) -> bool:
        """Drop one reference; delete the entry once unreferenced.
        Returns True if the entry was deleted (missing keys are a no-op)."""
        with self._lock:
            self._await_key_locked(key)
            entry = self._store.get(key)
            if entry is None:
                spilled = self._spilled.get(key)
                if spilled is None:
                    return False
                spilled[1] -= 1
                if spilled[1] > 0:
                    return False
                del self._spilled[key]
                self._remove_spill_file(key)
                self.stats["deletes"] += 1
                return True
            entry.refs -= 1
            if entry.refs > 0:
                return False
            del self._store[key]
            self._bytes -= entry.size
            self.stats["deletes"] += 1
            return True

    def delete(self, key: str) -> None:
        with self._lock:
            self._await_key_locked(key)
            entry = self._store.pop(key, None)
            if entry is not None:
                self._bytes -= entry.size
            elif self._spilled.pop(key, None) is not None:
                self._remove_spill_file(key)

    # -- durability: inventory / migration / snapshot -------------------------

    def keys_info(self) -> list:
        """``[(key, size, refs, tier)]`` across both tiers (tier is
        ``"mem"`` or ``"spill"``).  Waits out staged spill I/O first so a
        key mid-transition is never missed -- this is what shard
        rebalancing enumerates before migrating."""
        with self._lock:
            while self._io_keys:
                self._io_done.wait()
            out = [(k, e.size, e.refs, "mem") for k, e in self._store.items()]
            out.extend((k, size, refs, "spill")
                       for k, (size, refs) in self._spilled.items())
            return out

    def info_of(self, key: str) -> tuple:
        """(size, refs, tier) of one key (KeyError when absent)."""
        with self._lock:
            self._await_key_locked(key)
            entry = self._store.get(key)
            if entry is not None:
                return entry.size, entry.refs, "mem"
            size, refs = self._spilled[key]
            return size, refs, "spill"

    def peek(self, key: str) -> tuple:
        """(value, size, refs) without changing tiers: a spilled entry is
        read from its file under the lock (like ``snapshot``) instead of
        being faulted into memory -- migration exports must not evict
        other entries, delete the on-disk copy, or pay the simulated
        fetch bandwidth just to copy bytes off a shard."""
        with self._lock:
            self._await_key_locked(key)
            entry = self._store.get(key)
            if entry is not None:
                return entry.value, entry.size, entry.refs
            if key not in self._spilled:
                raise KeyError(key)
            size, refs = self._spilled[key]
            return self._read_spill(key), size, refs

    def detach_spilled(self, key: str) -> tuple:
        """Forget a *spilled* entry without deleting its file; returns
        (size, refs).  The migration fast path: when source and
        destination shards share a filesystem, the caller renames the
        spill file into the destination's spill dir and ``adopt_spilled``
        registers it there -- the payload bytes never cross a socket.
        KeyError when the key is not currently in the spill tier (the
        caller falls back to the export/re-put path)."""
        with self._lock:
            self._await_key_locked(key)
            if key in self._store or key not in self._spilled:
                raise KeyError(key)
            size, refs = self._spilled.pop(key)
            return size, refs

    def adopt_spilled(self, key: str, size: int, refs: int) -> None:
        """Register a key whose spill file was placed at
        ``_spill_path(key)`` by a migration rename (counterpart of
        ``detach_spilled``)."""
        assert self.spill_dir is not None, "adopting requires a spill tier"
        with self._lock:
            self._await_key_locked(key)
            self._spilled[key] = [size, refs]
            self.stats["puts"] += 1
            self.stats["bytes_put"] += size

    def snapshot(self) -> bytes:
        """Deterministic image of the whole store: a sorted list of
        ``(key, value, size, refs)`` covering both tiers (spilled values
        are read from their files -- the snapshot reuses the spill
        tier's on-disk pickle format without faulting anything back into
        memory).  Identical contents always produce identical bytes, so
        checkpoint files stay comparable across incarnations.

        The whole capture -- spill-file reads included -- runs under the
        store lock: a concurrent ``get`` fault-in or ``release`` removes
        spill files, and reading them unlocked could race that removal
        mid-snapshot.  Serializing other ops behind a (rare) checkpoint
        is the price of the cut being consistent."""
        with self._lock:
            while self._io_keys:
                self._io_done.wait()
            entries = {k: (k, e.value, e.size, e.refs)
                       for k, e in self._store.items()}
            for k, (size, refs) in self._spilled.items():
                entries[k] = (k, self._read_spill(k), size, refs)
            return pickle.dumps(
                {"version": 1,
                 "entries": [entries[k] for k in sorted(entries)]},
                protocol=pickle.HIGHEST_PROTOCOL)

    def restore(self, data: bytes) -> int:
        """Re-put every entry of a ``snapshot`` (keys and refcounts
        preserved; capacity/spill policy re-applied on the way in).
        Returns the number of entries restored.

        Also accepts a *sharded* snapshot (``ShardedValueServer``):
        there the entry values are the client's pickle bytes, so they
        are unpickled on the way in -- a checkpoint taken on the proc
        backend restores onto an in-process deployment and vice versa."""
        state = pickle.loads(data)
        if state.get("version") != 1:
            raise ValueError("unsupported value-server snapshot version "
                             f"{state.get('version')!r}")
        sharded = state.get("sharded", False)
        for key, value, size, refs in state["entries"]:
            if sharded:
                value = pickle.loads(value)
            self.put(value, size=size, refs=refs, key=key)
        return len(state["entries"])

    # -- spill tier ---------------------------------------------------------

    def _spill_path(self, key: str) -> str:
        return os.path.join(self.spill_dir, key + ".pkl")

    def _remove_spill_file(self, key: str) -> None:
        try:
            os.remove(self._spill_path(key))
        except OSError:
            pass

    def _read_spill(self, key: str):
        """One spill-file read; factored out so tests can slow it down
        to observe that staged I/O no longer blocks unrelated ops."""
        with open(self._spill_path(key), "rb") as f:
            return pickle.loads(f.read())

    def _write_spill(self, key: str, value) -> None:
        with open(self._spill_path(key), "wb") as f:
            f.write(pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL))

    def _evict(self, protect: Optional[str] = None) -> None:
        """Bring the memory tier back under ``capacity_bytes``.  Victims
        are chosen and unlinked from the store under the lock; the spill
        *write* happens outside it with the victim's in-flight marker
        set, so concurrent ops on other keys never queue behind the
        disk.  Re-checked per iteration: concurrent evictors cannot pick
        the same victim (the pop removes it before the lock drops)."""
        if self.capacity_bytes is None:
            return
        while True:
            with self._lock:
                if self._bytes <= self.capacity_bytes:
                    return
                victim = next((k for k, e in self._store.items()
                               if e.refs <= 0 and k != protect), None)
                if victim is None:
                    return                  # everything left is pinned
                entry = self._store.pop(victim)
                self._bytes -= entry.size
                self.stats["evictions"] += 1
                if self.spill_dir is None:
                    continue                # destructive bound: discarded
                self._io_keys.add(victim)
            try:
                self._write_spill(victim, entry.value)
            except BaseException:
                with self._lock:            # failed write: keep it resident
                    self._store[victim] = entry
                    self._bytes += entry.size
                    self.stats["evictions"] -= 1
                    self._io_keys.discard(victim)
                    self._io_done.notify_all()
                raise
            with self._lock:
                self._spilled[victim] = [entry.size, 0]
                self.stats["spills"] += 1
                self._io_keys.discard(victim)
                self._io_done.notify_all()

    @property
    def total_bytes(self) -> int:
        with self._lock:
            return self._bytes

    @property
    def spilled_bytes(self) -> int:
        with self._lock:
            return sum(size for size, _ in self._spilled.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._store) + len(self._spilled)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            self._await_key_locked(key)
            return key in self._store or key in self._spilled

    def prefetch(self, key: str) -> Future:
        return self._resolver.submit(self.get, key)


class Proxy:
    """Lazy reference to a value in a ValueServer.

    Pickles as (key, size, one_shot) only; `resolve(server)` (or attribute
    access once bound) fetches and memoizes the value.  A worker-level cache
    can be attached via `bind` so repeated uses hit local memory.
    ``one_shot`` marks proxies minted by the queue layer for a single
    task/result payload; the fabric releases their store entry after the
    consumer resolves them.
    """

    __slots__ = ("key", "size", "one_shot", "_server", "_value", "_resolved",
                 "_future")

    def __init__(self, key: str, size: int, one_shot: bool = False):
        self.key = key
        self.size = size
        self.one_shot = one_shot
        self._server = None
        self._value = None
        self._resolved = False
        self._future = None

    # -- lifecycle ----------------------------------------------------------

    def bind(self, server: ValueServer, cache: Optional[dict] = None,
             async_resolve: bool = False) -> "Proxy":
        self._server = (server, cache)
        if async_resolve and not self._resolved:
            if cache is not None and self.key in cache:
                pass
            else:
                self._future = server.prefetch(self.key)
        return self

    def resolve(self, server: Optional[ValueServer] = None):
        if self._resolved:
            return self._value
        srv, cache = (self._server if self._server is not None
                      else (server, None))
        if srv is None and server is not None:
            srv, cache = server, None
        assert srv is not None, "unbound proxy"
        if cache is not None and self.key in cache:
            value = cache[self.key]
        elif self._future is not None:
            value = self._future.result()
        else:
            value = srv.get(self.key)
        # one-shot payloads have a single consumer: caching them would turn
        # the worker cache into the unbounded campaign-memory leak the
        # refcounted store deletion exists to prevent
        if cache is not None and not self.one_shot:
            cache[self.key] = value
        self._value = value
        self._resolved = True
        self._future = None
        return value

    # -- pickle: ship only the reference -------------------------------------

    def __reduce__(self):
        return (Proxy, (self.key, self.size, self.one_shot))

    def __repr__(self):
        state = "resolved" if self._resolved else "lazy"
        return f"Proxy(key={self.key[:8]}, size={self.size}, {state})"


# ---------------------------------------------------------------------------
# Tree helpers used by the queue layer
# ---------------------------------------------------------------------------


def _leaf_size(value) -> int:
    """Quick size estimate without a full pickle for arrays."""
    if hasattr(value, "nbytes"):
        return int(value.nbytes)
    try:
        return len(pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL))
    except Exception:
        return 0


def iter_proxies(obj) -> Iterator[Proxy]:
    """Yield Proxy leaves of a (shallow) container tree."""
    if isinstance(obj, (tuple, list)):
        leaves = obj
    elif isinstance(obj, dict):
        leaves = obj.values()
    else:
        leaves = (obj,)
    for v in leaves:
        if isinstance(v, Proxy):
            yield v


def proxy_tree(obj, server: ValueServer, threshold: int, timer=None,
               prefix: str = "proxy", one_shot: bool = False):
    """Replace any value (or container element) above `threshold` bytes with
    a Proxy.  Containers handled: tuple, list, dict (one level is enough for
    task args/kwargs and result values).  ``one_shot=True`` pins the store
    entry with one reference and marks the proxy so the fabric can release
    it after its single consumer resolves it."""
    t0 = now()
    refs = 1 if one_shot else 0

    def one(v):
        size = _leaf_size(v)
        if size >= threshold and not isinstance(v, Proxy):
            return Proxy(server.put(v, size=size, refs=refs), size,
                         one_shot=one_shot)
        return v

    if isinstance(obj, tuple):
        out = tuple(one(v) for v in obj)
    elif isinstance(obj, list):
        out = [one(v) for v in obj]
    elif isinstance(obj, dict):
        out = {k: one(v) for k, v in obj.items()}
    else:
        out = one(obj)
    if timer is not None:
        timer.record(prefix + "_put", now() - t0)
    return out


def resolve_tree(obj, server: Optional[ValueServer],
                 cache: Optional[dict] = None, async_start: bool = False):
    """Resolve proxies in a (shallow) container tree."""
    def one(v):
        if isinstance(v, Proxy):
            if async_start:
                return v.bind(server, cache, async_resolve=True)
            return v.bind(server, cache).resolve()
        return v

    if isinstance(obj, tuple):
        return tuple(one(v) for v in obj)
    if isinstance(obj, list):
        return [one(v) for v in obj]
    if isinstance(obj, dict):
        return {k: one(v) for k, v in obj.items()}
    return one(obj)
