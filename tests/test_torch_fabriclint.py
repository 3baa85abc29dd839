"""fabriclint over the port's fabric: the cases of
``tests/test_fabriclint.py`` run through ``repro_torch.analysis.fabriclint``
(a copy of ``repro.analysis.fabriclint`` retargeted at
``src/repro_torch/{core,serving}``), on the same bad-code fixtures, plus the
port's own: ``--check`` over the port's fabric is clean with the port's
empty baseline, the span-name-registry pass reads ``apps/`` and ``models/``
too, and the port's idempotent-op registry is the reference's."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis import fabriclint as FL
from repro_torch.analysis.idempotent_ops import IDEMPOTENT_OPS

REPO = Path(__file__).resolve().parent.parent
FIXTURES = Path(__file__).resolve().parent / "fixtures" / "fabriclint"


def lint_source(src: str, pass_name: str, rel: str = "core/x.py"):
    ctx = FL.FileCtx(Path("<mem>"), rel, src)
    return [f for f in FL.PASSES[pass_name](ctx)
            if not ctx.suppressed(pass_name, f.line)]


# ---------------------------------------------------------------------------
# one pass at a time
# ---------------------------------------------------------------------------


class TestWaitNeedsPredicate:
    GOOD_WHILE = """
import threading
cond = threading.Condition()
def consume(items):
    with cond:
        while not items:
            cond.wait()
"""
    GOOD_TIMEOUT = """
import threading
cond = threading.Condition()
def tick(interval):
    with cond:
        cond.wait(interval)
"""
    BAD = """
import threading
cond = threading.Condition()
def consume(items):
    with cond:
        if not items:
            cond.wait()
"""

    def test_while_loop_ok(self):
        assert lint_source(self.GOOD_WHILE, "wait-needs-predicate") == []

    def test_timeout_bound_ok(self):
        assert lint_source(self.GOOD_TIMEOUT, "wait-needs-predicate") == []

    def test_bare_wait_flagged(self):
        fs = lint_source(self.BAD, "wait-needs-predicate")
        assert len(fs) == 1 and fs[0].line == 7

    def test_event_wait_not_flagged(self):
        src = """
import threading
stop = threading.Event()
def loop():
    stop.wait()
"""
        assert lint_source(src, "wait-needs-predicate") == []

    def test_while_in_outer_function_does_not_count(self):
        src = """
import threading
cond = threading.Condition()
def outer(items):
    while True:
        def inner():
            with cond:
                cond.wait()
        inner()
"""
        fs = lint_source(src, "wait-needs-predicate")
        assert len(fs) == 1


class TestIdempotentRetryRegistry:
    def test_registered_op_ok(self):
        src = 'def f(c):\n    c.request({"op": "snapshot"}, retry=True)\n'
        assert lint_source(src, "idempotent-retry-registry") == []

    def test_unregistered_op_flagged(self):
        src = 'def f(c):\n    c.request({"op": "put"}, retry=True)\n'
        fs = lint_source(src, "idempotent-retry-registry")
        assert len(fs) == 1 and "'put'" in fs[0].message

    def test_retry_forwarding_ignored(self):
        src = ('def f(c, retry):\n'
               '    c.request({"op": "put"}, retry=retry)\n')
        assert lint_source(src, "idempotent-retry-registry") == []

    def test_dynamic_header_needs_pragma(self):
        src = 'def f(c, h):\n    c.request(h, retry=True)\n'
        fs = lint_source(src, "idempotent-retry-registry")
        assert len(fs) == 1 and "retry-ops" in fs[0].message

    def test_retry_ops_pragma_resolves(self):
        src = ('def f(c, h):\n'
               '    # fabriclint: retry-ops=vs_get,vs_contains\n'
               '    c.request(h, retry=True)\n')
        assert lint_source(src, "idempotent-retry-registry") == []

    def test_retry_ops_pragma_still_checked_against_registry(self):
        src = ('def f(c, h):\n'
               '    # fabriclint: retry-ops=vs_put\n'
               '    c.request(h, retry=True)\n')
        fs = lint_source(src, "idempotent-retry-registry")
        assert len(fs) == 1 and "'vs_put'" in fs[0].message

    def test_registry_entries_have_justifications(self):
        for op, why in IDEMPOTENT_OPS.items():
            assert isinstance(why, str) and len(why.strip()) > 10, op


class TestGuardedLazyInit:
    BAD = """
class C:
    def get(self):
        if self._q is None:
            self._q = object()
        return self._q
"""
    GOOD = """
import threading
class C:
    def __init__(self):
        self._meta_lock = threading.RLock()
    def get(self):
        with self._meta_lock:
            if self._q is None:
                self._q = object()
            return self._q
"""

    def test_unguarded_flagged(self):
        fs = lint_source(self.BAD, "guarded-lazy-init")
        assert len(fs) == 1 and "_q" in fs[0].message

    def test_guarded_ok(self):
        assert lint_source(self.GOOD, "guarded-lazy-init") == []

    def test_or_condition_with_pid_check_still_flagged(self):
        src = """
import os
class C:
    def get(self):
        if self._q is None or self._pid != os.getpid():
            self._q = object()
        return self._q
"""
        assert len(lint_source(src, "guarded-lazy-init")) == 1

    def test_local_variable_not_flagged(self):
        src = """
def get(sock):
    if sock is None:
        sock = object()
    return sock
"""
        assert lint_source(src, "guarded-lazy-init") == []


class TestThreadLifecycle:
    def test_class_without_stop_flagged(self):
        src = """
import threading
class Leaky:
    def start(self):
        threading.Thread(target=self._loop, daemon=True).start()
"""
        fs = lint_source(src, "thread-lifecycle")
        assert len(fs) == 1 and "Leaky" in fs[0].message

    def test_class_with_stop_ok(self):
        src = """
import threading
class Fine:
    def start(self):
        threading.Thread(target=self._loop, daemon=True).start()
    def stop(self):
        pass
"""
        assert lint_source(src, "thread-lifecycle") == []

    def test_class_with_join_ok(self):
        src = """
import threading
class Fine:
    def run(self):
        t = threading.Thread(target=self._loop, daemon=True)
        t.start()
        t.join()
"""
        assert lint_source(src, "thread-lifecycle") == []

    def test_module_level_with_stop_flag_ok(self):
        src = """
import threading
def serve(stop):
    def loop():
        while not stop.is_set():
            pass
    threading.Thread(target=loop, daemon=True).start()
"""
        assert lint_source(src, "thread-lifecycle") == []

    def test_module_level_without_stop_flagged(self):
        src = """
import threading
def serve():
    def loop():
        while True:
            pass
    threading.Thread(target=loop, daemon=True).start()
"""
        assert len(lint_source(src, "thread-lifecycle")) == 1


class TestMonotonicDeadlines:
    def test_time_time_flagged(self):
        src = ("import time\n"
               "def expired(t0, lease):\n"
               "    return time.time() - t0 > lease\n")
        fs = lint_source(src, "monotonic-deadlines")
        assert len(fs) == 1 and "time.time()" in fs[0].message

    def test_perf_counter_ok(self):
        src = ("import time\n"
               "def stamp():\n"
               "    return time.perf_counter()\n")
        assert lint_source(src, "monotonic-deadlines") == []

    def test_sleep_ok(self):
        src = "import time\ndef nap():\n    time.sleep(0.1)\n"
        assert lint_source(src, "monotonic-deadlines") == []


class TestFrameHeaderHygiene:
    def test_pickled_blob_in_header_flagged(self):
        src = ('import pickle\n'
               'def f(c, x):\n'
               '    c.request({"op": "result", "v": pickle.dumps(x)})\n')
        fs = lint_source(src, "frame-header-hygiene")
        assert len(fs) == 1 and "blob" in fs[0].message

    def test_non_string_key_flagged(self):
        src = 'def f(c):\n    c.request({"op": "x", 1: "y"})\n'
        fs = lint_source(src, "frame-header-hygiene")
        assert len(fs) == 1 and "string literals" in fs[0].message

    def test_plain_header_ok(self):
        src = ('def f(c, topic, blob):\n'
               '    c.request({"op": "put", "topic": topic}, blob)\n')
        assert lint_source(src, "frame-header-hygiene") == []

    def test_relay_repickle_flagged(self):
        src = ('import pickle\n'
               'def relay(env):\n'
               '    return pickle.loads(env.data)\n')
        fs = lint_source(src, "frame-header-hygiene",
                         rel="src/repro_torch/core/transport/broker.py")
        assert len(fs) == 1 and "single-pickle-per-hop" in fs[0].message

    def test_repickle_outside_relay_modules_ok(self):
        src = ('import pickle\n'
               'def decode(payload):\n'
               '    return pickle.loads(payload)\n')
        assert lint_source(src, "frame-header-hygiene",
                           rel="src/repro_torch/core/value_server.py") == []

    def test_blob_under_shm_descriptor_key_flagged(self):
        src = ('import pickle\n'
               'def f(header, payload):\n'
               '    header["shm"] = pickle.dumps(payload)\n')
        fs = lint_source(src, "frame-header-hygiene")
        assert len(fs) == 1 and "descriptor" in fs[0].message

    def test_blob_under_meta_shm_key_flagged(self):
        src = ('import pickle\n'
               'def f(meta, payload):\n'
               '    meta["_shm"] = pickle.dumps(payload)\n')
        assert len(lint_source(src, "frame-header-hygiene")) == 1

    def test_plain_descriptor_assignment_ok(self):
        src = ('def f(header, desc):\n'
               '    header["shm"] = desc\n')
        assert lint_source(src, "frame-header-hygiene") == []


class TestShmSegmentLifecycle:
    def test_unguarded_create_flagged(self):
        src = ('from repro_torch.core.transport import shm\n'
               'def export(scope, data):\n'
               '    desc = shm.create_segment(scope, data)\n'
               '    shm.sweep_scope(scope)\n'
               '    return desc\n')
        fs = lint_source(src, "shm-segment-lifecycle")
        assert len(fs) == 1 and "fallback" in fs[0].message

    def test_guarded_create_with_sweep_ok(self):
        src = ('from repro_torch.core.transport import shm\n'
               'def export(scope, data):\n'
               '    try:\n'
               '        return shm.create_segment(scope, data)\n'
               '    except OSError:\n'
               '        return None\n'
               'def teardown(scope):\n'
               '    shm.sweep_scope(scope)\n')
        assert lint_source(src, "shm-segment-lifecycle") == []

    def test_create_without_scope_sweep_flagged(self):
        src = ('from repro_torch.core.transport import shm\n'
               'def export(scope, data):\n'
               '    try:\n'
               '        return shm.create_segment(scope, data)\n'
               '    except OSError:\n'
               '        return None\n')
        fs = lint_source(src, "shm-segment-lifecycle")
        assert len(fs) == 1 and "sweep" in fs[0].message

    def test_consumer_unlink_flagged(self):
        src = ('from repro_torch.core.transport import shm\n'
               'def consume(desc):\n'
               '    try:\n'
               '        data = shm.read_segment(desc)\n'
               '    except OSError:\n'
               '        return None\n'
               '    shm.unlink_segment(desc)\n'
               '    return data\n')
        fs = lint_source(src, "shm-segment-lifecycle")
        assert len(fs) == 1 and "ownership" in fs[0].message

    def test_unguarded_consumer_read_flagged(self):
        src = ('from repro_torch.core.transport import shm\n'
               'def consume(desc):\n'
               '    return shm.read_segment(desc)\n')
        fs = lint_source(src, "shm-segment-lifecycle")
        assert len(fs) == 1 and "raced" in fs[0].message

    def test_broker_owns_its_reads_and_unlinks(self):
        # in the owner module an unguarded read and an unlink are the
        # protocol, not violations
        src = ('from repro_torch.core.transport import shm\n'
               'def destroy(meta):\n'
               '    data = shm.read_segment(meta["_shm"])\n'
               '    shm.unlink_segment(meta["_shm"])\n'
               '    return data\n')
        assert lint_source(src, "shm-segment-lifecycle",
                           rel="src/repro_torch/core/transport/broker.py") == []

    def test_shm_module_itself_exempt(self):
        src = ('import os\n'
               'def unlink_segment(desc):\n'
               '    os.unlink(desc["name"])\n')
        assert lint_source(src, "shm-segment-lifecycle",
                           rel="src/repro_torch/core/transport/shm.py") == []


# ---------------------------------------------------------------------------
# pragmas
# ---------------------------------------------------------------------------


def test_skip_pragma_requires_reason():
    flagged = ('import time\n'
               '# fabriclint: skip=monotonic-deadlines\n'
               'def f():\n'
               '    return time.time()\n')
    # a bare skip with no `-- reason` does NOT suppress
    src_ok = ('import time\n'
              'def f():\n'
              '    # fabriclint: skip=monotonic-deadlines -- test clock\n'
              '    return time.time()\n')
    assert len(lint_source(flagged, "monotonic-deadlines")) == 1
    assert lint_source(src_ok, "monotonic-deadlines") == []


def test_skip_pragma_is_pass_specific():
    src = ('import time\n'
           'def f():\n'
           '    # fabriclint: skip=guarded-lazy-init -- wrong pass\n'
           '    return time.time()\n')
    assert len(lint_source(src, "monotonic-deadlines")) == 1


# ---------------------------------------------------------------------------
# the CLI on the bad-code fixtures (one per pass) and on the repo
# ---------------------------------------------------------------------------

FIXTURE_EXPECT = [
    ("bad_wait_no_predicate.py", "wait-needs-predicate", 16),
    ("bad_retry_unregistered.py", "idempotent-retry-registry", 8),
    ("bad_lazy_init_unguarded.py", "guarded-lazy-init", 15),
    ("bad_thread_leak.py", "thread-lifecycle", 11),
    ("bad_wallclock_deadline.py", "monotonic-deadlines", 8),
    ("bad_header_pickle.py", "frame-header-hygiene", 11),
    ("bad_shm_consumer_unlink.py", "shm-segment-lifecycle", 14),
    ("bad_span_undeclared.py", "span-name-registry", 10),
]


def run_cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.fabriclint", *args],
        capture_output=True, text=True, cwd=REPO,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})


@pytest.mark.parametrize("fname,pass_name,line", FIXTURE_EXPECT)
def test_cli_flags_fixture(fname, pass_name, line):
    path = FIXTURES / fname
    res = run_cli("--check", str(path))
    assert res.returncode != 0, res.stdout + res.stderr
    # pass name AND file:line in the output
    assert pass_name in res.stdout
    assert f"{fname}:{line}" in res.stdout


def test_cli_clean_on_repo():
    res = run_cli("--check")
    assert res.returncode == 0, res.stdout + res.stderr
    assert "clean" in res.stdout


def test_every_pass_has_a_fixture():
    assert {p for _, p, _ in FIXTURE_EXPECT} == set(FL.PASSES)


# ---------------------------------------------------------------------------
# baseline ratchet
# ---------------------------------------------------------------------------


def test_baseline_grandfathers_old_findings(tmp_path):
    bad = FIXTURES / "bad_wallclock_deadline.py"
    findings = FL.run([bad])
    assert findings
    baseline = tmp_path / "baseline.json"
    FL.save_baseline(baseline, findings)
    res = run_cli("--check", "--baseline", str(baseline), str(bad))
    assert res.returncode == 0, res.stdout
    assert "baselined" in res.stdout
    # a finding NOT in the baseline still fails
    res2 = run_cli("--check", "--baseline", str(baseline),
                   str(FIXTURES / "bad_thread_leak.py"))
    assert res2.returncode != 0


def test_update_baseline_writes_current_set(tmp_path):
    bad = FIXTURES / "bad_retry_unregistered.py"
    baseline = tmp_path / "b.json"
    res = run_cli("--update-baseline", "--baseline", str(baseline),
                  str(bad))
    assert res.returncode == 0
    data = json.loads(baseline.read_text())
    assert len(data["findings"]) == 1
    assert data["findings"][0]["pass_name"] == "idempotent-retry-registry"


def test_checked_in_baseline_is_empty():
    data = json.loads((REPO / "src" / "repro_torch" / "analysis" / "baseline.json").read_text())
    assert data["findings"] == []


# ---------------------------------------------------------------------------
# regression: the genuine defect fabriclint surfaced (unguarded lazy
# init of the prefetch resolver in ShardedValueServer) stays fixed
# ---------------------------------------------------------------------------


def test_shards_prefetch_lazy_init_is_guarded():
    # the static pass is the primary guard: remove the lock and this fails
    shards = REPO / "src" / "repro_torch" / "core" / "transport" / "shards.py"
    assert FL.run([shards], passes=["guarded-lazy-init"]) == []


def test_prefetch_builds_exactly_one_resolver_under_race(monkeypatch):
    import threading

    from repro_torch.core.transport import shards as shards_mod
    from repro_torch.core.transport.shards import ShardedValueServer

    vs = ShardedValueServer.__new__(ShardedValueServer)
    vs._init_client_state()
    monkeypatch.setattr(ShardedValueServer, "get",
                        lambda self, key: key, raising=True)

    created = []
    real_tpe = shards_mod.ThreadPoolExecutor

    class CountingExecutor(real_tpe):
        def __init__(self, *a, **k):
            created.append(self)
            super().__init__(*a, **k)

    monkeypatch.setattr(shards_mod, "ThreadPoolExecutor", CountingExecutor)

    n = 8
    barrier = threading.Barrier(n)
    futures = []
    fut_lock = threading.Lock()

    def go():
        barrier.wait()
        f = vs.prefetch("k")
        with fut_lock:
            futures.append(f)

    threads = [threading.Thread(target=go) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    try:
        # under the _meta_lock guard the race builds exactly one executor
        assert len(created) == 1
        assert [f.result(timeout=5) for f in futures] == ["k"] * n
    finally:
        vs._resolver.shutdown(wait=False)


# ---------------------------------------------------------------------------
# the port's own
# ---------------------------------------------------------------------------


def test_default_targets_are_the_ports_fabric():
    assert FL.DEFAULT_TARGETS == (REPO / "src" / "repro_torch" / "core",
                                  REPO / "src" / "repro_torch" / "serving")
    assert FL.DEFAULT_BASELINE == (REPO / "src" / "repro_torch" / "analysis"
                                   / "baseline.json")


def test_idempotent_ops_equal_the_reference():
    from repro.analysis.idempotent_ops import IDEMPOTENT_OPS as REF
    assert IDEMPOTENT_OPS == REF


def test_span_registry_reads_apps_and_models(monkeypatch):
    """span-name-registry, and only it, also reads the app and model code
    by default: an undeclared layer span in an ``apps/`` module fails."""
    assert FL.SPAN_TARGETS == (REPO / "src" / "repro_torch" / "apps",
                               REPO / "src" / "repro_torch" / "models")
    assert FL.run_default() == []
    monkeypatch.setattr(FL, "SPAN_TARGETS", (FIXTURES / "apps",))
    found = FL.run_default()
    assert [(f.pass_name, Path(f.file).name, f.line) for f in found] == [
        ("span-name-registry", "bad_layer_span_undeclared.py", 9)]
    assert "mpnn.predcit" in found[0].message
    assert FL.run_default(["thread-lifecycle"]) == []


def test_port_fabric_modules_lint_clean_one_by_one():
    """Every module of the port's fabric, the engine factory of
    ``serving/shard.py`` among them, with no finding and no baseline."""
    files = sorted(p for d in FL.DEFAULT_TARGETS for p in d.rglob("*.py"))
    assert files
    assert FL.run(files) == []
