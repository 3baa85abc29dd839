"""Runtime lock-order witness for the dispatch fabric.

Lockdep for the fabric: instrumented ``Lock``/``RLock``/``Condition``
wrappers record, per thread, which locks are held when another is
acquired.  Each (held -> acquired) pair is an edge in the global
acquisition graph; a cycle in that graph is a potential deadlock even
if this run never interleaved into it, so the witness fails **on the
acquisition attempt that would close the cycle** -- before the program
can actually deadlock and hang the test run.

The known-good edge set is checked in at
``src/repro_torch/analysis/lock_order.toml``
(e.g. the broker's documented claim_lock -> queue-cond order).  A new
edge is not an error by itself -- it fails the pytest session as an
*undeclared* ordering so the diff to ``lock_order.toml`` is explicit
and reviewed.  Acquiring two same-named locks (two instances from one
creation site, e.g. the snapshot cut's ExitStack over every queue
Condition) is a cycle-in-waiting unless that site is declared under
``[self_edges]`` with a justification.

Activation is opt-in: ``install()`` monkeypatches the ``threading``
factories so only locks *created* by ``src/repro_torch`` code (decided by
the
caller's frame) are wrapped; stdlib internals (Event, ThreadPoolExecutor,
multiprocessing) keep raw locks.  Forked children inherit the installed
witness object (sink path and all) along with the patched factories;
every edge is appended to the sink file (``O_APPEND``, one JSON
line) the moment it is first seen, so edges observed in a worker that
exits via ``os._exit`` (skipping atexit) are still collected.  The
pytest plugin ``repro_torch.analysis.pytest_witness`` wires this up under
``-p repro_torch.analysis.pytest_witness --torch-lock-witness``.
"""
from __future__ import annotations

import json
import os
import re
import sys
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_CONDITION = threading.Condition


class LockOrderError(RuntimeError):
    """An acquisition that would close a cycle in the lock-order graph."""


# ---------------------------------------------------------------------------
# the witness core
# ---------------------------------------------------------------------------


class Witness:
    def __init__(self, sink: Optional[str] = None,
                 allowed_self_edges: Iterable[str] = ()):
        self._tls = threading.local()
        self._mu = _REAL_LOCK()          # guards graph/edges (never wrapped)
        self._graph: Dict[str, Set[str]] = {}
        self.edges: Dict[Tuple[str, str], str] = {}   # edge -> first site
        self.self_edges: Dict[str, str] = {}          # name -> first site
        self.allowed_self_edges = set(allowed_self_edges)
        self.sink = sink
        self.active = True

    # -- held-stack plumbing (thread-local, no locking needed) --------------

    def _held(self) -> List[Tuple[str, int]]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    # -- graph ---------------------------------------------------------------

    def _path_exists(self, src: str, dst: str) -> bool:
        seen, stack = set(), [src]
        while stack:
            cur = stack.pop()
            if cur == dst:
                return True
            if cur in seen:
                continue
            seen.add(cur)
            stack.extend(self._graph.get(cur, ()))
        return False

    def _emit(self, record: dict) -> None:
        # only this witness's own sink: a throwaway Witness in a test
        # must never leak its seeded edges into a session-wide sink.
        # Forked children inherit the installed witness object itself,
        # sink and all -- no environment relay needed.
        sink = self.sink
        if not sink:
            return
        line = (json.dumps(record, sort_keys=True) + "\n").encode()
        fd = os.open(sink, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        try:
            os.write(fd, line)          # O_APPEND: atomic for short lines
        finally:
            os.close(fd)

    def _site(self) -> str:
        f = sys._getframe(2)
        while f is not None and (
                f.f_code.co_filename == __file__
                or f.f_code.co_filename == threading.__file__):
            f = f.f_back
        if f is None:
            return "?"
        return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"

    # -- acquisition hooks ---------------------------------------------------

    def before_acquire(self, name: str, ident: int) -> None:
        """Called before the real acquire blocks: record (held ->
        wanted) edges and fail if one would close a cycle."""
        if not self.active:
            return
        held = self._held()
        if not held:
            return
        if any(hid == ident for _, hid in held):
            return                      # reentrant acquire of an RLock
        site = self._site()
        for hname, hid in held:
            if hname == name:
                # second instance from the same creation site
                if name in self.allowed_self_edges:
                    with self._mu:
                        if name not in self.self_edges:
                            self.self_edges[name] = site
                            self._emit({"self_edge": name, "site": site})
                    continue
                raise LockOrderError(
                    f"two locks from the same creation site {name!r} held "
                    f"at once (at {site}); order between instances is "
                    "undefined -- declare the site under [self_edges] in "
                    "src/repro_torch/analysis/lock_order.toml with a "
                    "justification, or "
                    "impose a total order")
            edge = (hname, name)
            if edge in self.edges:
                continue
            with self._mu:
                if edge in self.edges:
                    continue
                if self._path_exists(name, hname):
                    cycle = f"{hname} -> {name} -> ... -> {hname}"
                    raise LockOrderError(
                        f"lock-order cycle: acquiring {name!r} while "
                        f"holding {hname!r} (at {site}) closes {cycle}; "
                        "the reverse order is already on record")
                self.edges[edge] = site
                self._graph.setdefault(hname, set()).add(name)
            self._emit({"edge": [hname, name], "site": site})

    def on_acquired(self, name: str, ident: int) -> None:
        if self.active:
            self._held().append((name, ident))

    def on_release(self, name: str, ident: int) -> None:
        if not self.active:
            return
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] == (name, ident):
                del held[i]
                return


# ---------------------------------------------------------------------------
# instrumented primitives
# ---------------------------------------------------------------------------


class WitnessLock:
    """Duck-typed Lock/RLock wrapper.  Provides the private Condition
    protocol (``_is_owned``/``_release_save``/``_acquire_restore``) by
    delegating to the inner lock, so a real ``threading.Condition`` built
    over a WitnessLock works unchanged -- ``wait()``'s internal
    release/reacquire bypasses the witness (the thread is blocked, its
    held-stack is frozen, and the stack stays consistent either side of
    the wait)."""

    def __init__(self, witness: Witness, name: str, inner=None):
        self._witness = witness
        self._name = name
        self._inner = inner if inner is not None else _REAL_LOCK()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        self._witness.before_acquire(self._name, id(self))
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._witness.on_acquired(self._name, id(self))
        return got

    def release(self):
        self._inner.release()
        self._witness.on_release(self._name, id(self))

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    def __repr__(self):
        return f"<WitnessLock {self._name} over {self._inner!r}>"

    # -- Condition protocol --------------------------------------------------

    def _is_owned(self):
        inner = self._inner
        if hasattr(inner, "_is_owned"):
            return inner._is_owned()
        if inner.acquire(False):
            inner.release()
            return False
        return True

    def _release_save(self):
        inner = self._inner
        if hasattr(inner, "_release_save"):
            return inner._release_save()
        inner.release()
        return None

    def _acquire_restore(self, state):
        inner = self._inner
        if hasattr(inner, "_acquire_restore"):
            inner._acquire_restore(state)
        else:
            inner.acquire()


# ---------------------------------------------------------------------------
# creation-site naming + threading patch
# ---------------------------------------------------------------------------

_ASSIGN_RE = re.compile(
    r"([\w.\[\]'\"]+)\s*=\s*(?:threading\s*\.\s*)?(?:Lock|RLock|Condition)\(")


def _creation_name(depth: int = 2) -> Tuple[str, bool]:
    """(name, in_repro): name a lock by its creation site -- the
    assignment target when the source line is an assignment
    (``core/transport/broker.py:self._claim_lock``), file:line
    otherwise.  Two instances born at one site share a name: that is
    what makes the graph finite and same-site multi-instance holds
    detectable."""
    import linecache
    f = sys._getframe(depth)
    fname = f.f_code.co_filename
    norm = fname.replace("\\", "/")
    in_repro = "/repro_torch/" in norm and "/analysis/" not in norm
    if "/repro_torch/" in norm:
        short = norm.rsplit("/repro_torch/", 1)[1]
    else:
        short = os.path.basename(norm)
    line = linecache.getline(fname, f.f_lineno)
    # C-extension code (numpy's Cython BitGenerator, etc.) creates locks
    # with no Python frame of its own -- the nearest frame is whatever
    # repro line *called* it.  Only claim the lock when the source line
    # itself invokes the constructor.
    if not re.search(r"\b(Lock|RLock|Condition)\s*\(", line):
        return f"{short}:L{f.f_lineno}", False
    m = _ASSIGN_RE.search(line)
    target = m.group(1) if m else f"L{f.f_lineno}"
    return f"{short}:{target}", in_repro


_installed: Optional[Witness] = None


def install(witness: Witness) -> Witness:
    """Patch the ``threading`` lock factories.  Only locks created by
    ``src/repro_torch`` code (the calling frame) are wrapped; everything
    else gets the real primitive.  Idempotent per process; ``uninstall()``
    restores the originals (already-wrapped locks keep functioning)."""
    global _installed
    if _installed is not None:
        raise RuntimeError("witness already installed")
    _installed = witness

    def _lock():
        name, in_repro = _creation_name()
        if not in_repro:
            return _REAL_LOCK()
        return WitnessLock(witness, name, _REAL_LOCK())

    def _rlock():
        name, in_repro = _creation_name()
        if not in_repro:
            return _REAL_RLOCK()
        return WitnessLock(witness, name, _REAL_RLOCK())

    def _condition(lock=None):
        name, in_repro = _creation_name()
        if not in_repro:
            return _REAL_CONDITION(lock)
        if lock is None:
            # private RLock, named by the condition's creation site
            lock = WitnessLock(witness, name, _REAL_RLOCK())
        elif not isinstance(lock, WitnessLock):
            lock = WitnessLock(witness, name, lock)
        # a real Condition over the witness lock: enter/exit/notify go
        # through the witness, wait()'s release/reacquire bypasses it
        return _REAL_CONDITION(lock)

    threading.Lock = _lock
    threading.RLock = _rlock
    threading.Condition = _condition
    return witness


def uninstall() -> Optional[Witness]:
    global _installed
    threading.Lock = _REAL_LOCK
    threading.RLock = _REAL_RLOCK
    threading.Condition = _REAL_CONDITION
    w, _installed = _installed, None
    if w is not None:
        w.active = False
    return w


def installed() -> Optional[Witness]:
    return _installed


# ---------------------------------------------------------------------------
# known-good order file (analysis/lock_order.toml)
# ---------------------------------------------------------------------------


def _parse_string_arrays(text: str) -> Dict[str, List[str]]:
    """Tiny TOML-subset reader (Python 3.10 has no tomllib): sections,
    ``key = [`` multi-line arrays of double-quoted strings, comments."""
    out: Dict[str, List[str]] = {}
    section = ""
    key = None
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("[") and line.endswith("]"):
            section = line[1:-1].strip()
            key = None
            continue
        m = re.match(r"(\w+)\s*=\s*\[", line)
        if m:
            key = f"{section}.{m.group(1)}"
            out[key] = []
            line = line[m.end():]
        if key is None:
            continue
        for s in re.findall(r'"([^"]*)"', line):
            out[key].append(s)
        if line.split("#", 1)[0].rstrip().endswith("]"):
            key = None
    return out


def load_lock_order(path) -> Tuple[Set[Tuple[str, str]], Set[str]]:
    """Returns (known edges, allowed self-edge sites)."""
    text = Path(path).read_text()
    try:
        import tomllib
        data = tomllib.loads(text)
        pairs = data.get("edges", {}).get("pairs", [])
        selfs = data.get("self_edges", {}).get("allowed", [])
    except ModuleNotFoundError:
        arrays = _parse_string_arrays(text)
        pairs = arrays.get("edges.pairs", [])
        selfs = arrays.get("self_edges.allowed", [])
    edges = set()
    for p in pairs:
        a, _, b = p.partition(" -> ")
        if not b:
            raise ValueError(f"malformed edge {p!r} (want 'a -> b')")
        edges.add((a.strip(), b.strip()))
    return edges, set(s.strip() for s in selfs)


def read_sink(path) -> Tuple[Dict[Tuple[str, str], str], Dict[str, str]]:
    """Merge a sink file (possibly written by several processes) back
    into (edges, self_edges)."""
    edges: Dict[Tuple[str, str], str] = {}
    selfs: Dict[str, str] = {}
    p = Path(path)
    if not p.exists():
        return edges, selfs
    for line in p.read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        rec = json.loads(line)
        if "edge" in rec:
            edges.setdefault(tuple(rec["edge"]), rec.get("site", "?"))
        elif "self_edge" in rec:
            selfs.setdefault(rec["self_edge"], rec.get("site", "?"))
    return edges, selfs
