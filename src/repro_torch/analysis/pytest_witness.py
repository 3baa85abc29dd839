"""The port's opt-in lock-order witness as a pytest plugin: a copy of the
witness half of ``tests/conftest.py``, retargeted at ``repro_torch``.

    pytest -p repro_torch.analysis.pytest_witness --torch-lock-witness ...

installs ``repro_torch.analysis.witness`` for the whole session: every
Lock/RLock/Condition created by ``src/repro_torch`` code is wrapped,
per-thread acquisition chains are recorded, and a cycle fails the
acquiring test immediately. At session end the observed acquisition graph
is compared against the checked-in known-good order
(``src/repro_torch/analysis/lock_order.toml``); an edge not declared there
fails the session so new lock-order couplings land as an explicit,
reviewed diff. Forked children (broker, pool workers, shards) inherit the
witness and append their edges to a shared sink file, so edges seen only
inside a worker that exits via ``os._exit`` still count.
"""
import os
import tempfile

LOCK_ORDER_TOML = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "lock_order.toml")


def pytest_addoption(parser):
    parser.addoption(
        "--torch-lock-witness", action="store_true", default=False,
        help="instrument src/repro_torch locks and fail on lock-order "
             "cycles or acquisition edges missing from "
             "src/repro_torch/analysis/lock_order.toml")


def pytest_configure(config):
    if not config.getoption("--torch-lock-witness"):
        return
    from repro_torch.analysis import witness as W

    fd, sink = tempfile.mkstemp(prefix="lock-witness-", suffix=".jsonl")
    os.close(fd)
    _, allowed_self = W.load_lock_order(LOCK_ORDER_TOML)
    config._torch_witness = W.install(
        W.Witness(sink=sink, allowed_self_edges=allowed_self))
    config._torch_witness_sink = sink


def pytest_sessionfinish(session, exitstatus):
    config = session.config
    witness = getattr(config, "_torch_witness", None)
    if witness is None:
        return
    from repro_torch.analysis import witness as W

    W.uninstall()
    known_edges, allowed_self = W.load_lock_order(LOCK_ORDER_TOML)
    edges, self_edges = W.read_sink(config._torch_witness_sink)
    os.unlink(config._torch_witness_sink)

    new_edges = {e: s for e, s in edges.items() if e not in known_edges}
    new_self = {n: s for n, s in self_edges.items()
                if n not in allowed_self}
    if not new_edges and not new_self:
        return
    lines = ["lock-order witness: undeclared acquisition edges "
             "(add to src/repro_torch/analysis/lock_order.toml with "
             "review):"]
    for (a, b), site in sorted(new_edges.items()):
        lines.append(f'  "{a} -> {b}"  (first seen at {site})')
    for name, site in sorted(new_self.items()):
        lines.append(f'  self-edge "{name}"  (first seen at {site})')
    report = "\n".join(lines)
    tr = config.pluginmanager.get_plugin("terminalreporter")
    if tr is not None:
        tr.write_line(report, red=True)
    session.exitstatus = 3
