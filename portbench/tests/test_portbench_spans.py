"""The readers of the program's layer spans (``metrics/idle_engine.serve``,
``idle_loop.serve``, ``admit_poll_ms.serve``, ``queue_wait_ms.serve``,
``real_rows.serve``, ``idle_program.rescore``, ``edge_gib.rescore``,
``task_overhead_ms.train``): the three cells traced at test size on the CPU,
where the host-clock and counter readers read numbers and the device-trace
readers none; the device-trace readers on a hand-made ``DeviceTrace``; and
None where the ring dropped spans of the window or the program keeps no
ring."""
import time

import pytest

from portbench import run
from portbench.harness import spec
from portbench.harness.window import DeviceTrace, Window, read_idle

NEW = {"internlm2.docs": {"host": ["admit_poll_ms.serve",
                                   "queue_wait_ms.serve", "real_rows.serve"],
                          "device": ["idle_engine.serve", "idle_loop.serve"]},
       "mpnn.rescore": {"host": ["edge_gib.rescore"],
                        "device": ["idle_program.rescore"]},
       "mpnn.retrain": {"host": ["task_overhead_ms.train"], "device": []}}
MS = 1_000_000


@pytest.fixture
def obs():
    from repro_torch import observability

    observability.reset_layers()
    yield observability
    observability.reset_layers()


def reader(root, workload, name):
    return spec.metric_reader(spec.load_cell(root, workload, True), name)


@pytest.mark.parametrize("workload", sorted(NEW))
def test_cell_traced_reads_the_spans(root, obs, workload):
    line = run.run_cell(root, workload, 2**31 + 5, 2.0, True, device="cpu",
                        test_size=True)
    assert line["correct"], line["checks"]
    got = line["metrics"]
    for name in NEW[workload]["host"]:
        assert got[name]["value"] > 0, name
    for name in NEW[workload]["device"]:
        assert name not in got           # no device operation on the CPU
    if workload == "mpnn.rescore":
        # test size: 96 molecules x 4 members x 16^2 pairs x 16^2 x 4 B
        want = 96 * 4 * 256 * 256 * 4 / 2**30
        assert got["edge_gib.rescore"]["value"] == want
    if workload == "internlm2.docs":
        assert 0 < got["real_rows.serve"]["value"] <= 100


def _traced(obs):
    """A traced part of 100 ms with device operations at 0-10, 30-40 and
    70-100 ms (gaps 10-30 and 40-70), and the window around it."""
    base = time.perf_counter_ns()
    off = obs.clock_offset_ns()
    dev = [("k", base + off + a * MS, base + off + b * MS)
           for a, b in ((0, 10), (30, 40), (70, 100))]
    win = Window(1.0, trace=True, trace_seconds=0.1, on_cuda=False)
    win.t0 = (base - 900 * MS) / 1e9
    win.t_trace = (base / 1e9, (base + 100 * MS) / 1e9)
    return base, {"trace": DeviceTrace(0.1, dev, []), "win": win}


def test_device_readers_on_a_hand_made_trace(root, obs):
    base, ctx = _traced(obs)

    def at(name, a, b):
        obs.layer_at(name, base + a * MS, base + b * MS)

    at("engine.decode", 5, 20)            # 10 ms of the first gap
    at("serve.step", 0, 50)               # the rest of it, and 40-50
    at("serve.intake", 60, 65)            # 5 ms of the second gap
    at("engine.prefill", 62, 75)          # 62-70 under both kinds
    at("mpnn.predict", 35, 60)            # 40-60
    at("mpnn.rank", 200, 300)             # after the traced part
    engine = reader(root, "internlm2.docs", "idle_engine.serve")(ctx)
    loop = reader(root, "internlm2.docs", "idle_loop.serve")(ctx)
    program = reader(root, "mpnn.rescore", "idle_program.rescore")(ctx)
    assert engine == pytest.approx(100 * (10 + 8) / 100)
    assert loop == pytest.approx(100 * (10 + 10 + 2) / 100)
    assert program == pytest.approx(100 * 20 / 100)
    assert engine + loop <= read_idle(ctx)
    # no device operation, no span of the kind, no ring
    empty = dict(ctx, trace=DeviceTrace(0.1, [], []))
    assert reader(root, "internlm2.docs", "idle_engine.serve")(empty) is None
    obs.reset_layers()
    assert reader(root, "mpnn.rescore", "idle_program.rescore")(ctx) is None


def test_readers_give_none_where_the_ring_dropped_spans(root, obs,
                                                        monkeypatch):
    from repro_torch.observability import trace

    base, ctx = _traced(obs)
    monkeypatch.setattr(trace, "RING_SPANS", 4)
    obs.reset_layers()
    for i in range(8):                    # the first four ended in the window
        obs.layer_at("engine.decode", base + i * MS, base + (i + 1) * MS)
    assert obs.layer_dropped() == 4
    assert reader(root, "internlm2.docs", "idle_engine.serve")(ctx) is None
    obs.layer_at("serve.intake", base, base + MS, groups=1)
    ctx["untraced"] = []
    for name in ("admit_poll_ms.serve", "queue_wait_ms.serve",
                 "real_rows.serve"):
        assert reader(root, "internlm2.docs", name)(ctx) is None, name


def test_readers_give_none_without_the_ring(root, obs, monkeypatch):
    """A program that keeps no ring (before the layer spans) reads as
    nothing, and no reader raises."""
    _, ctx = _traced(obs)
    ctx["untraced"] = [(ctx["win"].t0, ctx["win"].t0 + 0.1, 4)]
    monkeypatch.delattr(obs, "layer_spans")
    for workload, kinds in NEW.items():
        for name in kinds["host"] + kinds["device"]:
            assert reader(root, workload, name)(ctx) is None, name
