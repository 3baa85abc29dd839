"""The port's lock-order witness: the cases of ``tests/test_lock_witness.py``
run through ``repro_torch.analysis.witness`` (a copy of
``repro.analysis.witness`` that claims the locks created under
``src/repro_torch``), against the port's own
``src/repro_torch/analysis/lock_order.toml``; plus the port's own: which
locks the witness claims, and the pytest plugin
``repro_torch.analysis.pytest_witness``."""
import json
import threading
from pathlib import Path

import pytest

from repro_torch.analysis import witness as W
from repro_torch.analysis.witness import (LockOrderError, Witness,
                                          WitnessLock, load_lock_order,
                                          read_sink)

REPO = Path(__file__).resolve().parent.parent
LOCK_ORDER = REPO / "src" / "repro_torch" / "analysis" / "lock_order.toml"


def run_in_thread(fn):
    box = {}

    def wrapper():
        try:
            box["result"] = fn()
        except BaseException as e:          # noqa: BLE001 - re-raised below
            box["error"] = e

    t = threading.Thread(target=wrapper)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive(), "witness thread hung"
    return box


# ---------------------------------------------------------------------------
# seeded AB/BA inversion: the satellite-mandated witness self-test
# ---------------------------------------------------------------------------


def test_seeded_ab_ba_inversion_fails_the_witness():
    w = Witness()
    a = WitnessLock(w, "fixture:A")
    b = WitnessLock(w, "fixture:B")
    with a:
        with b:                             # records A -> B
            pass

    def inverted():
        with b:
            with a:                         # would close B -> A -> B
                pass

    box = run_in_thread(inverted)
    assert isinstance(box.get("error"), LockOrderError)
    msg = str(box["error"])
    assert "fixture:A" in msg and "fixture:B" in msg

    # the witness fails on the *attempt*, before any deadlock: both locks
    # must be free again
    assert not a.locked() and not b.locked()


def test_inversion_detected_without_interleaving():
    # no concurrency at all: the graph alone carries the order
    w = Witness()
    a, b = WitnessLock(w, "X"), WitnessLock(w, "Y")
    with a, b:
        pass
    with pytest.raises(LockOrderError):
        with b, a:
            pass


def test_longer_cycle_detected():
    w = Witness()
    a, b, c = (WitnessLock(w, n) for n in "ABC")
    with a, b:
        pass
    with b, c:
        pass
    with pytest.raises(LockOrderError):     # C -> A closes A->B->C->A
        with c, a:
            pass


# ---------------------------------------------------------------------------
# wrapper semantics
# ---------------------------------------------------------------------------


def test_reentrant_rlock_records_no_self_edge():
    w = Witness()
    r = WitnessLock(w, "R", threading.RLock())
    with r, r:
        pass
    assert w.edges == {} and w.self_edges == {}


def test_same_site_two_instances_raises_unless_declared():
    w = Witness()
    c1 = WitnessLock(w, "site:cond")
    c2 = WitnessLock(w, "site:cond")
    with pytest.raises(LockOrderError, match="self_edges"):
        with c1, c2:
            pass

    w2 = Witness(allowed_self_edges={"site:cond"})
    c1 = WitnessLock(w2, "site:cond")
    c2 = WitnessLock(w2, "site:cond")
    with c1, c2:
        pass
    assert "site:cond" in w2.self_edges


def test_condition_over_witness_lock_wait_notify():
    # a real threading.Condition built on a WitnessLock must wait/notify
    # correctly (the witness supplies the private Condition protocol)
    w = Witness()
    lk = WitnessLock(w, "L")
    cond = threading.Condition(lk)
    state = []

    def waiter():
        with cond:
            while not state:
                cond.wait(5)
            return state[0]

    t = threading.Thread(target=waiter)
    t.start()
    with cond:
        state.append("done")
        cond.notify_all()
    t.join(timeout=10)
    assert not t.is_alive()


def test_nonblocking_acquire_failure_records_nothing():
    w = Witness()
    a, b = WitnessLock(w, "A"), WitnessLock(w, "B")
    with a:
        got = run_in_thread(lambda: b.acquire(False) and (b.release(),))
        assert "error" not in got
    # only the other thread touched b, with nothing held: no edges
    assert ("A", "B") not in w.edges or w.edges == {}


# ---------------------------------------------------------------------------
# sink + known-order file
# ---------------------------------------------------------------------------


def test_edges_stream_to_sink_eagerly(tmp_path):
    sink = tmp_path / "edges.jsonl"
    w = Witness(sink=str(sink))
    a, b = WitnessLock(w, "A"), WitnessLock(w, "B")
    with a, b:
        # written while still held: an os._exit here would lose nothing
        assert sink.exists() and "edge" in sink.read_text()
    edges, selfs = read_sink(sink)
    assert ("A", "B") in edges and selfs == {}


def test_read_sink_merges_duplicate_lines(tmp_path):
    sink = tmp_path / "edges.jsonl"
    rec = json.dumps({"edge": ["A", "B"], "site": "x.py:1"})
    sink.write_text(rec + "\n" + rec + "\n")
    edges, _ = read_sink(sink)
    assert edges == {("A", "B"): "x.py:1"}


def test_checked_in_lock_order_parses():
    edges, selfs = load_lock_order(LOCK_ORDER)
    # the documented claim -> cond coupling must stay on record
    assert ("core/transport/broker.py:self._claim_lock",
            "core/transport/broker.py:self.cond") in edges
    assert "core/transport/broker.py:self.cond" in selfs


def test_fallback_toml_parser_matches_format():
    # Python 3.10 has no tomllib; the subset parser must read the real file
    text = LOCK_ORDER.read_text()
    arrays = W._parse_string_arrays(text)
    assert arrays["edges.pairs"], "no edges parsed"
    assert all(" -> " in p for p in arrays["edges.pairs"])
    assert arrays["self_edges.allowed"]


# ---------------------------------------------------------------------------
# the real fabric under an installed witness
# ---------------------------------------------------------------------------


def test_local_fabric_edges_stay_inside_lock_order(tmp_path):
    if W.installed() is not None:
        pytest.skip("witness already installed session-wide")
    known_edges, allowed_self = load_lock_order(LOCK_ORDER)
    w = W.install(Witness(allowed_self_edges=allowed_self))
    try:
        # locks are instantiated per-object, so instances created now are
        # witnessed even though the modules were imported long ago
        from repro_torch.core.queues import ColmenaQueues
        from repro_torch.core.transport.base import Envelope
        from repro_torch.core.transport.local import LocalTransport

        t = LocalTransport()
        ch = t.channel("t", "requests")
        assert ch.put(Envelope(0.0, b"x", {}), claim="task-0")
        assert not ch.put(Envelope(0.0, b"x", {}), claim="task-0")
        assert len(ch.get_batch(4, timeout=0.5)) == 1
        t.snapshot()                        # multi-cond consistent cut

        q = ColmenaQueues(["t"])            # queues._lock/_all_done
        q.send_task(3, method="noop", topic="t")
        assert q.get_task("t", timeout=1) is not None
        assert not q.wait_until_done(timeout=0.05)
    finally:
        W.uninstall()
    assert set(w.edges) <= known_edges, (
        f"undeclared edges: {set(w.edges) - known_edges}")
    assert set(w.self_edges) <= allowed_self


# ---------------------------------------------------------------------------
# the port's own
# ---------------------------------------------------------------------------


def test_witness_claims_port_locks_only():
    """Locks born in ``src/repro_torch`` code are wrapped; those born in
    the JAX package's fabric are not (its own witness claims them)."""
    if W.installed() is not None:
        pytest.skip("witness already installed session-wide")
    w = W.install(Witness())
    try:
        from repro.core.transport.local import LocalTransport as RefLocal
        from repro_torch.core.transport.local import LocalTransport
        port, ref = LocalTransport(), RefLocal()
    finally:
        W.uninstall()
    assert isinstance(port._lock, WitnessLock)
    assert port._lock._name == "core/transport/local.py:self._lock"
    assert not isinstance(ref._lock, WitnessLock)
    assert w.edges == {}


def test_lock_order_matches_the_reference():
    """The port's fabric modules are copies, so their known-good order is
    the reference's."""
    assert load_lock_order(LOCK_ORDER) == load_lock_order(
        REPO / "analysis" / "lock_order.toml")


def test_pytest_plugin_passes_on_the_ports_fabric(tmp_path):
    """``-p repro_torch.analysis.pytest_witness --torch-lock-witness`` over
    a test that drives the port's local fabric: exit 0, and no undeclared
    edge reported."""
    import os
    import subprocess
    import sys

    test = tmp_path / "test_fabric_under_witness.py"
    test.write_text(
        "from repro_torch.core.queues import ColmenaQueues\n"
        "from repro_torch.core.transport.base import Envelope\n"
        "from repro_torch.core.transport.local import LocalTransport\n"
        "def test_fabric():\n"
        "    t = LocalTransport()\n"
        "    ch = t.channel('t', 'requests')\n"
        "    assert ch.put(Envelope(0.0, b'x', {}), claim='task-0')\n"
        "    assert len(ch.get_batch(4, timeout=0.5)) == 1\n"
        "    t.snapshot()\n"
        "    q = ColmenaQueues(['t'])\n"
        "    q.send_task(3, method='noop', topic='t')\n"
        "    assert q.get_task('t', timeout=1) is not None\n")
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "repro_torch.analysis.pytest_witness", "--torch-lock-witness",
         str(test)], capture_output=True, text=True, cwd=tmp_path,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")}, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "undeclared" not in res.stdout
