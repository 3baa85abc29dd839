"""fabriclint: AST passes encoding the dispatch fabric's concurrency
invariants.

Every regression class shipped so far was a concurrency invariant
violated silently -- an unguarded lazy init splitting the replication
FIFO, a leaked daemon thread, a non-idempotent op behind
reconnect-resend.  Each pass below encodes one such invariant as a
mechanical check over ``src/repro_torch/core/**``:

- **wait-needs-predicate** -- ``Condition.wait()`` must sit inside a
  ``while``-predicate loop (spurious wakeups, stolen notifies) or carry
  a timeout bound.
- **idempotent-retry-registry** -- a ``retry=True`` frame send may only
  name ops declared in
  ``repro_torch.analysis.idempotent_ops.IDEMPOTENT_OPS``
  (each with a one-line justification).  Sites whose header is built
  dynamically declare their op set with ``# fabriclint: retry-ops=a,b``.
- **guarded-lazy-init** -- an attribute assigned under
  ``if self._x is None`` must be inside a ``with <lock>:`` block, or two
  racing threads each build (and one leaks) the resource.
- **thread-lifecycle** -- ``Thread(daemon=True).start()`` requires a
  reachable stop/sentinel/join path (a stop/close/shutdown method or a
  ``join`` in the same class; a stop-flag or sentinel check in the
  target function for module-level spawns).
- **monotonic-deadlines** -- no ``time.time()`` in fabric code; leases,
  stragglers and timeouts use ``repro_torch.utils.timing.now()`` (monotonic),
  immune to wall-clock steps.
- **frame-header-hygiene** -- wire headers are plain dicts with string
  keys and primitive values; envelope payload bytes ride the frame body
  and are relayed verbatim, never re-pickled (single-pickle-per-hop).
- **span-name-registry** -- every ``obs.span``/``obs.counter``/... call
  in fabric code names a literal declared in
  ``repro_torch.observability.names``; an undeclared or dynamic name
  silently
  fragments the merged timeline and the metrics rollup.  This pass alone
  also reads ``src/repro_torch/{apps,models}`` (``SPAN_TARGETS``), whose
  layer spans and counters the benchmark's readers key on by name.

False positives are suppressed in place with a justified pragma::

    pickle.loads(payload)   # fabriclint: skip=frame-header-hygiene -- why

Findings not suppressed and not in the port's own baseline,
``src/repro_torch/analysis/baseline.json`` (which starts empty), fail
``--check``; the baseline only ratchets down (``--update-baseline``
rewrites it to the current finding set).
"""
from __future__ import annotations

import argparse
import ast
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set

from repro_torch.analysis.idempotent_ops import IDEMPOTENT_OPS
from repro_torch.observability.names import METRIC_NAMES, SPAN_NAMES

REPO_ROOT = Path(__file__).resolve().parents[3]
# the fabric's concurrency surface: the dispatch core plus the serving
# subsystem (the shard's serve loop, heartbeat thread, and lease
# bookkeeping live under the same invariants)
DEFAULT_TARGETS = (REPO_ROOT / "src" / "repro_torch" / "core",
                   REPO_ROOT / "src" / "repro_torch" / "serving")
DEFAULT_TARGET = DEFAULT_TARGETS[0]      # kept for callers by name
# read by the span-name-registry pass only: app and model code carries
# layer spans and counters, not the fabric's concurrency
SPAN_TARGETS = (REPO_ROOT / "src" / "repro_torch" / "apps",
                REPO_ROOT / "src" / "repro_torch" / "models")
DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.json"

# relay modules: code that forwards envelopes it must not re-pickle
RELAY_MODULES = ("transport/broker.py", "transport/proc.py",
                 "transport/local.py", "cluster/federation.py")

_SKIP_RE = re.compile(r"#\s*fabriclint:\s*skip=([\w-]+)\s*--\s*\S")
_RETRY_OPS_RE = re.compile(r"#\s*fabriclint:\s*retry-ops=([\w,\s]+)")
_LOCKISH_RE = re.compile(r"lock|cond|mutex", re.IGNORECASE)
_STOPPISH_RE = re.compile(r"stop|cancel|shutdown|done|sentinel",
                          re.IGNORECASE)


@dataclass(frozen=True)
class Finding:
    pass_name: str
    file: str                   # repo-relative path
    line: int
    message: str

    def render(self) -> str:
        return f"{self.pass_name} {self.file}:{self.line} {self.message}"

    def key(self) -> tuple:
        # line numbers drift with unrelated edits; identity is
        # (pass, file, message)
        return (self.pass_name, self.file, self.message)


# ---------------------------------------------------------------------------
# per-file context
# ---------------------------------------------------------------------------


def _terminal_name(node: ast.AST) -> Optional[str]:
    """`self._meta_lock` -> '_meta_lock', `q.cond` -> 'cond', `ev` -> 'ev'."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _is_threading_ctor(node: ast.AST, kinds: Sequence[str]) -> bool:
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
            and f.value.id == "threading" and f.attr in kinds:
        return True
    return isinstance(f, ast.Name) and f.id in kinds


class FileCtx:
    """One parsed file plus the derived name sets the passes share."""

    def __init__(self, path: Path, rel: str, source: str):
        self.path = path
        self.rel = rel
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=str(path))
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                child._fl_parent = node          # type: ignore[attr-defined]
        # names assigned from threading.Condition(...) / Lock / RLock
        # anywhere in the module -- cheap local "type inference"
        self.condition_names: Set[str] = set()
        self.lock_names: Set[str] = set()
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Assign):
                continue
            is_cond = _is_threading_ctor(node.value, ("Condition",))
            is_lock = is_cond or _is_threading_ctor(
                node.value, ("Lock", "RLock"))
            if not is_lock:
                continue
            for tgt in node.targets:
                name = _terminal_name(tgt)
                if name:
                    self.lock_names.add(name)
                    if is_cond:
                        self.condition_names.add(name)

    def ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        cur = getattr(node, "_fl_parent", None)
        while cur is not None:
            yield cur
            cur = getattr(cur, "_fl_parent", None)

    def enclosing(self, node: ast.AST, *types) -> Optional[ast.AST]:
        for anc in self.ancestors(node):
            if isinstance(anc, types):
                return anc
        return None

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def suppressed(self, pass_name: str, lineno: int) -> bool:
        """A `# fabriclint: skip=<pass> -- <reason>` pragma on the line
        or the line above suppresses; the reason text is mandatory."""
        for ln in (lineno, lineno - 1):
            m = _SKIP_RE.search(self.line_text(ln))
            if m and m.group(1) == pass_name:
                return True
        return False

    def retry_ops_pragma(self, node: ast.Call) -> Optional[List[str]]:
        """`# fabriclint: retry-ops=a,b,c` near a dynamic-header retry
        site names the ops that can flow through it."""
        end = getattr(node, "end_lineno", node.lineno) or node.lineno
        for ln in range(node.lineno - 1, end + 1):
            m = _RETRY_OPS_RE.search(self.line_text(ln))
            if m:
                return [op.strip() for op in m.group(1).split(",")
                        if op.strip()]
        return None


# ---------------------------------------------------------------------------
# passes
# ---------------------------------------------------------------------------

_FN_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
              ast.ClassDef)


def _find(ctx: FileCtx, pass_name: str, node: ast.AST,
          message: str) -> Finding:
    return Finding(pass_name, ctx.rel, node.lineno, message)


def pass_wait_needs_predicate(ctx: FileCtx) -> List[Finding]:
    """A bare ``cond.wait()`` outside a while-predicate loop loses
    wakeups forever: spurious wakeups and notify_all races mean a single
    wait can return with the predicate still false."""
    out = []
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "wait"):
            continue
        recv = _terminal_name(node.func.value)
        if recv not in ctx.condition_names:
            continue                    # Event.wait etc: no predicate needed
        timeout_args = list(node.args) + [
            kw.value for kw in node.keywords if kw.arg == "timeout"]
        bounded = any(
            not (isinstance(a, ast.Constant) and a.value is None)
            for a in timeout_args)
        if bounded:
            continue
        in_while = False
        for anc in ctx.ancestors(node):
            if isinstance(anc, ast.While):
                in_while = True
                break
            if isinstance(anc, _FN_SCOPES):
                break
        if not in_while:
            out.append(_find(
                ctx, "wait-needs-predicate", node,
                f"Condition.wait() on {recv!r} is not inside a while-"
                "predicate loop and has no timeout bound; a spurious "
                "wakeup or stolen notify blocks it forever"))
    return out


def _header_ops(node: ast.Call) -> Optional[List[Finding]]:
    """Extract constant 'op' values from dict-literal args; None when no
    literal header is present."""
    ops = []
    exprs = list(node.args) + [kw.value for kw in node.keywords
                               if kw.arg != "retry"]
    found_header = False
    for arg in exprs:
        if not isinstance(arg, ast.Dict):
            continue
        for k, v in zip(arg.keys, arg.values):
            if isinstance(k, ast.Constant) and k.value == "op":
                found_header = True
                if isinstance(v, ast.Constant) and isinstance(v.value, str):
                    ops.append(v.value)
                else:
                    ops.append(None)    # dynamic op inside a literal header
    return ops if found_header else None


def pass_idempotent_retry_registry(ctx: FileCtx) -> List[Finding]:
    """reconnect-resend may double-apply an op that landed before the
    connection died; only ops argued idempotent in IDEMPOTENT_OPS (one
    justification line each) may be sent with ``retry=True``."""
    out = []
    registry_hint = ("declare it in repro_torch/analysis/idempotent_ops.py "
                     "with "
                     "a one-line idempotency justification, or drop "
                     "retry=True")
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        retry_kw = next((kw for kw in node.keywords if kw.arg == "retry"),
                        None)
        if retry_kw is None or not (
                isinstance(retry_kw.value, ast.Constant)
                and retry_kw.value.value is True):
            continue                    # retry=retry forwarding etc
        ops = _header_ops(node)
        if ops is None:
            ops = ctx.retry_ops_pragma(node)
        if ops is None:
            out.append(_find(
                ctx, "idempotent-retry-registry", node,
                "retry=True with a dynamic header: name the ops that flow "
                "through this site with '# fabriclint: retry-ops=a,b'"))
            continue
        for op in ops:
            if op is None:
                out.append(_find(
                    ctx, "idempotent-retry-registry", node,
                    "retry=True header has a non-literal 'op' value; "
                    "use '# fabriclint: retry-ops=a,b' to name it"))
            elif op not in IDEMPOTENT_OPS:
                out.append(_find(
                    ctx, "idempotent-retry-registry", node,
                    f"op {op!r} is sent with retry=True but is not in "
                    f"the IDEMPOTENT_OPS registry; {registry_hint}"))
    return out


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def pass_guarded_lazy_init(ctx: FileCtx) -> List[Finding]:
    """`if self._x is None: self._x = ...` without a lock lets two
    threads each build the resource -- one copy leaks while callers keep
    using both (the PR-5 split-replication-FIFO bug class)."""
    out = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.If):
            continue
        lazy = set()
        for cmp_ in ast.walk(node.test):
            if (isinstance(cmp_, ast.Compare)
                    and len(cmp_.ops) == 1
                    and isinstance(cmp_.ops[0], ast.Is)
                    and isinstance(cmp_.comparators[0], ast.Constant)
                    and cmp_.comparators[0].value is None):
                attr = _self_attr(cmp_.left)
                if attr:
                    lazy.add(attr)
        if not lazy:
            continue
        assigned = set()
        for stmt in node.body:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Assign):
                    for tgt in sub.targets:
                        attr = _self_attr(tgt)
                        if attr in lazy:
                            assigned.add(attr)
        if not assigned:
            continue
        guarded = False
        for anc in ctx.ancestors(node):
            if isinstance(anc, _FN_SCOPES):
                break
            if isinstance(anc, ast.With):
                for item in anc.items:
                    name = _terminal_name(item.context_expr) or ""
                    if isinstance(item.context_expr, ast.Call):
                        name = _terminal_name(item.context_expr.func) or ""
                    if name in ctx.lock_names or _LOCKISH_RE.search(name):
                        guarded = True
        if not guarded:
            attrs = ", ".join(sorted(assigned))
            out.append(_find(
                ctx, "guarded-lazy-init", node,
                f"lazy init of self.{attrs} under 'is None' is not inside "
                "a 'with <lock>:' block; racing threads each build (and "
                "one leaks) the resource"))
    return out


def _names_in(node: ast.AST) -> Iterable[str]:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            yield sub.id
        elif isinstance(sub, ast.Attribute):
            yield sub.attr


def _has_stop_path(fn: ast.AST) -> bool:
    """Heuristic: the thread's loop consults a stop flag / Event, or
    bails on a sentinel (`if x is None: return/break`)."""
    for name in _names_in(fn):
        if _STOPPISH_RE.search(name):
            return True
    for sub in ast.walk(fn):
        if isinstance(sub, ast.If):
            sentinel = any(
                isinstance(c, ast.Compare) and isinstance(c.ops[0], ast.Is)
                and isinstance(c.comparators[0], ast.Constant)
                and c.comparators[0].value is None
                for c in ast.walk(sub.test) if isinstance(c, ast.Compare))
            if sentinel and any(isinstance(s, (ast.Return, ast.Break))
                                for st in sub.body for s in ast.walk(st)):
                return True
    return False


def _resolve_target_fn(ctx: FileCtx, call: ast.Call) -> Optional[ast.AST]:
    tgt = next((kw.value for kw in call.keywords if kw.arg == "target"),
               None)
    if not isinstance(tgt, ast.Name):
        return None
    scopes = [a for a in ctx.ancestors(call)
              if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef))]
    scopes.append(ctx.tree)
    for scope in scopes:
        body = scope.body if hasattr(scope, "body") else []
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and stmt.name == tgt.id:
                return stmt
    return None


def pass_thread_lifecycle(ctx: FileCtx) -> List[Finding]:
    """A daemon thread with no stop/sentinel/join path runs until the
    interpreter dies -- holding sockets, queues and locks its owner
    thinks are released (the PR-5 leaked-replication-thread bug class)."""
    out = []
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call)
                and _is_threading_ctor(node, ("Thread",))):
            continue
        daemon_kw = next(
            (kw for kw in node.keywords if kw.arg == "daemon"), None)
        if daemon_kw is None or not (
                isinstance(daemon_kw.value, ast.Constant)
                and daemon_kw.value.value is True):
            continue
        cls = ctx.enclosing(node, ast.ClassDef)
        if cls is not None:
            has_stop_method = any(
                isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
                and re.match(r"(stop|close|shutdown|terminate|__exit__)",
                             stmt.name)
                for stmt in cls.body)
            has_join = any(
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr == "join"
                for sub in ast.walk(cls))
            if has_stop_method or has_join:
                continue
            out.append(_find(
                ctx, "thread-lifecycle", node,
                f"daemon Thread in class {cls.name} has no reachable "
                "stop path: no stop/close/shutdown/__exit__ method and "
                "no join() anywhere in the class"))
            continue
        target_fn = _resolve_target_fn(ctx, node)
        if target_fn is not None and _has_stop_path(target_fn):
            continue
        out.append(_find(
            ctx, "thread-lifecycle", node,
            "daemon Thread outside a class: its target must consult a "
            "stop flag/Event or exit on a sentinel (None) item"))
    return out


def pass_monotonic_deadlines(ctx: FileCtx) -> List[Finding]:
    """Lease expiry, straggler detection and wait deadlines must come
    from a monotonic clock; time.time() jumps with NTP steps and DST,
    silently expiring (or immortalizing) leases."""
    out = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Attribute):
            continue
        base = node.value
        if isinstance(base, ast.Name) and base.id == "time" \
                and node.attr == "time":
            out.append(_find(
                ctx, "monotonic-deadlines", node,
                "wall-clock time.time() in fabric code; use "
                "repro_torch.utils.timing.now() (time.perf_counter, "
                "monotonic)"))
        if node.attr in ("now", "utcnow") and \
                _terminal_name(base) == "datetime":
            out.append(_find(
                ctx, "monotonic-deadlines", node,
                "wall-clock datetime in fabric code; use "
                "repro_torch.utils.timing.now() (monotonic) for deadlines"))
    return out


_HEADER_SINKS = {"request", "_send", "send_frame"}
_BLOB_MAKERS = {"dumps", "serialize", "dump"}


def pass_frame_header_hygiene(ctx: FileCtx) -> List[Finding]:
    """Wire headers are small plain dicts (string keys, primitive
    values) pickled once per hop; the envelope payload rides the frame
    body as opaque bytes.  Embedding serialized blobs in a header -- or
    unpickling payload bytes in relay code -- silently breaks the
    single-pickle-per-hop contract the fabric's overhead numbers and
    isolation rest on."""
    out = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        fname = _terminal_name(node.func)
        if fname not in _HEADER_SINKS:
            continue
        exprs = [a for a in node.args] + [kw.value for kw in node.keywords]
        for arg in exprs:
            if not isinstance(arg, ast.Dict):
                continue
            if not any(isinstance(k, ast.Constant) and k.value == "op"
                       for k in arg.keys):
                continue                # not a wire header
            for k in arg.keys:
                if k is None or not (isinstance(k, ast.Constant)
                                     and isinstance(k.value, str)):
                    out.append(Finding(
                        "frame-header-hygiene", ctx.rel,
                        (k or arg).lineno,
                        "wire header keys must be string literals "
                        "(plain dict of primitives)"))
            for v in arg.values:
                for sub in ast.walk(v):
                    bad = (isinstance(sub, ast.Call)
                           and _terminal_name(sub.func) in _BLOB_MAKERS) \
                        or isinstance(sub, ast.Lambda)
                    if bad:
                        out.append(Finding(
                            "frame-header-hygiene", ctx.rel, sub.lineno,
                            "serialized blob embedded in a wire header; "
                            "payload bytes ride the frame body, headers "
                            "stay primitive"))
    # the shm descriptor is a header field like any other: the value
    # stored under "shm" (frame header) or "_shm" (envelope meta) must
    # stay the flat {"name", "size"} dict create_segment hands back --
    # a serialized blob there would smuggle the payload back into the
    # header the lane exists to keep it out of
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        tgt = node.targets[0]
        if not (isinstance(tgt, ast.Subscript)
                and isinstance(tgt.slice, ast.Constant)
                and tgt.slice.value in ("shm", "_shm")):
            continue
        for sub in ast.walk(node.value):
            if (isinstance(sub, ast.Call)
                    and _terminal_name(sub.func) in _BLOB_MAKERS) \
                    or isinstance(sub, ast.Lambda):
                out.append(Finding(
                    "frame-header-hygiene", ctx.rel, sub.lineno,
                    "shm descriptor must stay a flat dict of primitives "
                    "(create_segment's {name, size}); payload bytes "
                    "belong in the segment, not its descriptor"))
    if ctx.rel.replace("\\", "/").endswith(RELAY_MODULES):
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("loads", "dumps")
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "pickle"):
                continue
            touches_payload = any(
                (isinstance(sub, ast.Name)
                 and sub.id in ("payload", "blob", "data"))
                or (isinstance(sub, ast.Attribute) and sub.attr == "data")
                for a in node.args for sub in ast.walk(a))
            if touches_payload:
                out.append(_find(
                    ctx, "frame-header-hygiene", node,
                    "relay code re-pickles envelope payload bytes; "
                    "envelopes are relayed verbatim "
                    "(single-pickle-per-hop)"))
    return out


# modules that OWN shm segments (may unlink; their reads cannot race an
# unlink because destruction is their own, locked decision).  Everyone
# else is a producer (creates, hands off, never unlinks post-handoff)
# or a consumer (maps and reads, never unlinks).
_SHM_OWNER_MODULES = ("transport/broker.py",)


def _catches_oserror(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True                     # bare except covers OSError
    names = {_terminal_name(sub) for sub in ast.walk(t)}
    return bool(names & {"OSError", "IOError", "FileNotFoundError",
                         "Exception", "BaseException"})


def pass_shm_segment_lifecycle(ctx: FileCtx) -> List[Finding]:
    """The shared-memory lane's ownership protocol (see transport/shm.py):
    producers create and hand off, the broker owns from receipt to
    envelope destruction, consumers only map and read.  This pass checks
    the call-site side of that contract -- a creator without an inline
    fallback turns an optimization into a correctness dependency, a
    consumer that unlinks destroys a segment the broker may redeliver,
    and an unguarded consumer read crashes on the benign expired-lease
    race instead of dropping the raced copy."""
    rel = ctx.rel.replace("\\", "/")
    if rel.endswith("transport/shm.py"):
        return []                       # the primitives themselves
    owner = rel.endswith(_SHM_OWNER_MODULES)
    out = []
    create_calls = []
    calls_sweep = False
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        fname = _terminal_name(node.func)
        if fname == "sweep_scope":
            calls_sweep = True
        elif fname == "create_segment":
            create_calls.append(node)
            guarded = any(
                isinstance(anc, ast.Try)
                and any(_catches_oserror(h) for h in anc.handlers)
                for anc in ctx.ancestors(node))
            if not guarded:
                out.append(_find(
                    ctx, "shm-segment-lifecycle", node,
                    "create_segment without an OSError fallback: the shm "
                    "lane is an optimization -- a full or missing "
                    "namespace must fall back to inline payloads, not "
                    "fail the send"))
        elif fname == "read_segment" and not owner:
            guarded = any(
                isinstance(anc, ast.Try)
                and any(_catches_oserror(h) for h in anc.handlers)
                for anc in ctx.ancestors(node))
            if not guarded:
                out.append(_find(
                    ctx, "shm-segment-lifecycle", node,
                    "consumer read_segment without an OSError guard: an "
                    "expired lease's other copy may be acked (segment "
                    "destroyed) under this reader -- drop the raced "
                    "copy, don't crash the consumer"))
        elif fname == "unlink_segment" and not owner:
            out.append(_find(
                ctx, "shm-segment-lifecycle", node,
                "unlink_segment outside the broker: segment ownership "
                "transfers with the frame -- a producer-side unlink "
                "after an ambiguous send destroys a delivered "
                "envelope's payload; leaks are reclaimed by the scope "
                "sweep instead"))
    if create_calls and not calls_sweep:
        out.append(_find(
            ctx, "shm-segment-lifecycle", create_calls[0],
            "module creates segments but never sweeps its scope: a "
            "producer that dies between create and handoff leaks the "
            "segment until sweep_scope runs at fabric teardown"))
    return out


# obs.<method> -> (index of the name argument, registry, registry label)
_OBS_NAME_SITES = {
    "span": (1, SPAN_NAMES, "SPAN_NAMES"),
    "instant": (1, SPAN_NAMES, "SPAN_NAMES"),
    "counter": (0, METRIC_NAMES, "METRIC_NAMES"),
    "gauge": (0, METRIC_NAMES, "METRIC_NAMES"),
    "histo": (0, METRIC_NAMES, "METRIC_NAMES"),
    "observe": (0, METRIC_NAMES, "METRIC_NAMES"),
    "layer": (0, SPAN_NAMES, "SPAN_NAMES"),
    "layer_at": (0, SPAN_NAMES, "SPAN_NAMES"),
}


def pass_span_name_registry(ctx: FileCtx) -> List[Finding]:
    """Span and metric names are the join keys of the whole
    observability plane: the report merges per-process sinks by name,
    and the Fig.-5 decomposition maps span names onto Timer components.
    A typo'd or dynamically built name doesn't error -- it just
    fragments the timeline into series nobody aggregates.  Every
    ``obs.span``/``obs.instant``/``obs.counter``/``obs.gauge``/
    ``obs.histo``/``obs.observe`` call site (the ``from repro_torch import
    observability as obs`` convention) must therefore name a literal
    declared in ``repro_torch.observability.names``."""
    out = []
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "obs"
                and node.func.attr in _OBS_NAME_SITES):
            continue
        idx, registry, label = _OBS_NAME_SITES[node.func.attr]
        name_arg = node.args[idx] if len(node.args) > idx else next(
            (kw.value for kw in node.keywords if kw.arg == "name"), None)
        if name_arg is None:
            continue                    # malformed call: TypeError at runtime
        if not (isinstance(name_arg, ast.Constant)
                and isinstance(name_arg.value, str)):
            out.append(_find(
                ctx, "span-name-registry", node,
                f"obs.{node.func.attr}() with a non-literal name: "
                "dynamic names fragment the merged timeline; use a "
                "literal declared in repro_torch/observability/names.py"))
        elif name_arg.value not in registry:
            out.append(_find(
                ctx, "span-name-registry", node,
                f"obs.{node.func.attr}({name_arg.value!r}) names an "
                f"undeclared {node.func.attr}; add it to {label} in "
                "repro_torch/observability/names.py (one-line description) "
                "so the report and rollups aggregate it"))
    return out


PASSES: Dict[str, Callable[[FileCtx], List[Finding]]] = {
    "wait-needs-predicate": pass_wait_needs_predicate,
    "idempotent-retry-registry": pass_idempotent_retry_registry,
    "guarded-lazy-init": pass_guarded_lazy_init,
    "thread-lifecycle": pass_thread_lifecycle,
    "monotonic-deadlines": pass_monotonic_deadlines,
    "frame-header-hygiene": pass_frame_header_hygiene,
    "shm-segment-lifecycle": pass_shm_segment_lifecycle,
    "span-name-registry": pass_span_name_registry,
}


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------


def iter_py_files(paths: Sequence[Path]) -> List[Path]:
    files = []
    for p in paths:
        if p.is_dir():
            files.extend(sorted(
                f for f in p.rglob("*.py") if "__pycache__" not in f.parts))
        else:
            files.append(p)
    return files


def run(paths: Sequence[Path],
        passes: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run the named passes (default: all) over ``paths``; suppression
    pragmas are honored here so callers see only live findings."""
    selected = {n: PASSES[n] for n in (passes or PASSES)}
    findings: List[Finding] = []
    for path in iter_py_files([Path(p) for p in paths]):
        try:
            rel = str(path.resolve().relative_to(REPO_ROOT))
        except ValueError:
            rel = str(path)
        ctx = FileCtx(path, rel, path.read_text())
        for name, fn in selected.items():
            findings.extend(
                f for f in fn(ctx) if not ctx.suppressed(name, f.line))
    findings.sort(key=lambda f: (f.file, f.line, f.pass_name))
    return findings


def run_default(passes: Optional[Sequence[str]] = None) -> List[Finding]:
    """The passes (default: all) over ``DEFAULT_TARGETS``, and
    span-name-registry, when selected, over ``SPAN_TARGETS`` too."""
    findings = run(DEFAULT_TARGETS, passes)
    if passes is None or "span-name-registry" in passes:
        findings += run(SPAN_TARGETS, ["span-name-registry"])
    findings.sort(key=lambda f: (f.file, f.line, f.pass_name))
    return findings


def load_baseline(path: Path) -> List[dict]:
    if not path.exists():
        return []
    return json.loads(path.read_text()).get("findings", [])


def save_baseline(path: Path, findings: Sequence[Finding]) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(
        {"comment": "fabriclint ratchet: entries here are grandfathered; "
                    "new findings fail --check.  Shrink, never grow.",
         "findings": [f.__dict__ for f in findings]},
        indent=2, sort_keys=True) + "\n")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.fabriclint",
        description="concurrency-invariant analyzer for the dispatch fabric")
    ap.add_argument("paths", nargs="*", type=Path,
                    help="files/dirs to analyze (default: "
                         "src/repro_torch/{core,serving}, and "
                         "src/repro_torch/{apps,models} for "
                         "span-name-registry)")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on findings not in the baseline (default "
                         "behavior; flag kept for explicit CI invocation)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline to the current finding set")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="baseline path (default: the port's "
                         "analysis/baseline.json "
                         "when analyzing the default target, none for "
                         "explicit paths)")
    ap.add_argument("--pass", dest="only_passes", action="append",
                    metavar="NAME", choices=sorted(PASSES),
                    help="run only this pass (repeatable)")
    args = ap.parse_args(argv)

    baseline_path = args.baseline
    if baseline_path is None and not args.paths:
        baseline_path = DEFAULT_BASELINE

    findings = (run(args.paths, args.only_passes) if args.paths
                else run_default(args.only_passes))

    if args.update_baseline:
        save_baseline(baseline_path or DEFAULT_BASELINE, findings)
        print(f"baseline updated: {len(findings)} finding(s)")
        return 0

    baseline_keys = {(b["pass_name"], b["file"], b["message"])
                     for b in load_baseline(baseline_path)} \
        if baseline_path else set()
    new = [f for f in findings if f.key() not in baseline_keys]
    old = [f for f in findings if f.key() in baseline_keys]

    for f in new:
        print(f.render())
    if old:
        print(f"note: {len(old)} baselined finding(s) remain "
              "(see analysis/baseline.json)")
    stale = baseline_keys - {f.key() for f in findings}
    if stale:
        print(f"note: {len(stale)} baseline entr(ies) no longer fire; "
              "run --update-baseline to ratchet down")
    if new:
        print(f"fabriclint: {len(new)} new finding(s)")
        return 1
    print(f"fabriclint: clean ({len(findings)} total, "
          f"{len(old)} baselined)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
