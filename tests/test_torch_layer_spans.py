"""The port's layer spans (``repro_torch.observability``: ``layer``,
``layer_at``, the in-memory ring, ``clock_offset_ns``) and where the program
records them: the serve loop over the local transport, the engine, and the
surrogate's predict (with the edge-tensor bytes) and train. CPU only, no
JAX."""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import observability as obs
from repro_torch.observability import trace


@pytest.fixture
def ring():
    """An empty ring for the test, and an empty one after it."""
    obs.reset_layers()
    yield
    obs.reset_layers()


def _named(prefix=""):
    return [s for s in obs.layer_spans() if s.name.startswith(prefix)]


def test_nesting_and_parents_on_two_threads(ring):
    go = threading.Barrier(2)

    def work(i):
        go.wait(timeout=10)
        with obs.layer("serve.step", real=i) as outer:
            with obs.layer("engine.decode", rows=i) as inner:
                time.sleep(0.01)
            with obs.layer("engine.gather"):
                pass
        got[i] = (outer.sid, inner.sid)

    got = {}
    threads = [threading.Thread(target=work, args=(i,)) for i in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    spans = {s.sid: s for s in obs.layer_spans()}
    assert len(spans) == 6
    for i, (outer, inner) in got.items():
        assert spans[outer].parent == -1
        assert spans[outer].attrs == {"real": i}
        assert spans[inner].parent == outer
        assert spans[inner].attrs == {"rows": i}
        gather = [s for s in spans.values() if s.name == "engine.gather"
                  and s.parent == outer]
        assert len(gather) == 1
        assert spans[outer].t0 <= spans[inner].t0 <= spans[inner].t1
        assert spans[inner].t1 <= gather[0].t0 <= spans[outer].t1
    # oldest end first: each inner span before the span around it
    order = [s.sid for s in obs.layer_spans()]
    for outer, inner in got.values():
        assert order.index(inner) < order.index(outer)


def test_explicit_times_and_request_id(ring):
    with obs.layer("serve.admit") as around:
        obs.layer_at("infer_queue", 100, 250, rid="task-7")
    obs.layer_at("infer_queue", 300, 400, rid="task-8", bucket=16)
    a, outer, b = obs.layer_spans()
    assert (a.name, a.t0, a.t1, a.rid, a.parent) == (
        "infer_queue", 100, 250, "task-7", around.sid)
    assert outer.sid == around.sid and outer.parent == -1
    assert (b.t0, b.t1, b.rid, b.parent, b.attrs) == (
        300, 400, "task-8", -1, {"bucket": 16})
    assert len({a.sid, outer.sid, b.sid}) == 3


def test_ring_bound_and_drop_count(ring, monkeypatch):
    monkeypatch.setattr(trace, "RING_SPANS", 8)
    obs.reset_layers()
    for i in range(20):
        obs.layer_at("mpnn.rank", i, i + 1)
    held = obs.layer_spans()
    assert [s.t0 for s in held] == list(range(12, 20))
    assert obs.layer_dropped() == 12
    # the ring holds every span that ended after the oldest one held
    assert obs.layer_complete_since(13)
    assert not obs.layer_complete_since(12)
    obs.reset_layers()
    obs.layer_at("mpnn.rank", 0, 1)
    assert obs.layer_dropped() == 0 and obs.layer_complete_since(0)


def test_clock_offset_maps_onto_the_unix_clock(ring):
    off = obs.clock_offset_ns()
    assert obs.clock_offset_ns() == off          # once per process
    for _ in range(20):
        w0 = time.time_ns()
        with obs.layer("mpnn.rank"):
            time.sleep(0.001)
        w1 = time.time_ns()
        s = obs.layer_spans()[-1]
        # a few microseconds of slack for the pair the offset came from
        assert w0 - 50_000 <= s.t0 + off <= s.t1 + off <= w1 + 50_000


def _serve(engine, prompts, max_new):
    """A ServeLoop over the local transport in a thread; returns the
    results by task id."""
    from repro_torch.core.queues import ColmenaQueues
    from repro_torch.serving.shard import (ServeLoop, ServeSpec,
                                           send_shard_stop)

    spec = ServeSpec(topic="infer", max_batch=4, prompt_buckets=(16,),
                     max_batch_delay_ms=5, max_new_cap=8)
    queues = ColmenaQueues([], backend="local", serve_spec=spec,
                           trace=False)
    loop = ServeLoop(queues.transport, spec, engine=engine,
                     identity="infer@test")
    th = threading.Thread(target=loop.run, daemon=True)
    th.start()
    try:
        ids = [queues.send_inference(p, max_new=m)
               for p, m in zip(prompts, max_new)]
        got = {}
        deadline = time.perf_counter() + 120
        while len(got) < len(ids) and time.perf_counter() < deadline:
            for r in queues.get_results("infer", max_n=16, timeout=0.5):
                got[r.task_id] = r
    finally:
        send_shard_stop(queues.transport, "infer")
        th.join(timeout=30)
    assert not th.is_alive()
    return ids, got


def test_serve_loop_spans(ring):
    from repro_torch.configs.base import get_config
    from repro_torch.models import api
    from repro_torch.serving.engine import Engine

    cfg = get_config("internlm2-1.8b", reduced=True).replace(
        param_dtype="float32", compute_dtype="float32")
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    engine = Engine(cfg, params, max_new=8)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
               for n in (5, 9, 16, 12, 7, 3)]
    max_new = [3, 5, 2, 4, 1, 6]
    ids, got = _serve(engine, prompts, max_new)
    assert all(got[t].success and len(got[t].value) == m
               for t, m in zip(ids, max_new))

    queue = _named("infer_queue")
    assert sorted(s.rid for s in queue) == sorted(ids)
    assert all(s.t0 <= s.t1 for s in queue)
    intake, admit, step = (_named(f"serve.{k}")
                           for k in ("intake", "admit", "step"))
    assert intake and admit and step
    assert sum(s.attrs["requests"] for s in intake) == len(ids)
    assert sum(s.attrs["requests"] for s in admit) == len(ids)
    prefill, decode = _named("engine.prefill"), _named("engine.decode")
    assert len(prefill) == engine.stats["prefill_calls"]
    assert len(decode) == engine.stats["decode_steps"]
    assert sum(s.attrs["rows"] for s in admit) == sum(
        s.attrs["rows"] for s in prefill)
    # the rounds' rows are the decode calls' rows; each request is a real
    # row in the decode steps after its prefill's token, max_new - 1 of them
    assert sum(s.attrs["rows"] for s in step) == sum(
        s.attrs["rows"] for s in decode)
    assert sum(s.attrs["real"] for s in step) == sum(m - 1 for m in max_new)
    # the engine's calls run inside the loop's admit and step spans
    parents = {s.sid: s.name for s in admit + step}
    assert all(parents.get(s.parent) == "serve.admit" for s in prefill)
    assert all(parents.get(s.parent) == "serve.step" for s in decode)
    assert all(parents.get(s.parent) == "serve.admit" for s in queue)


def _space(n):
    from repro_torch.data import molecules
    space = molecules.MoleculeSpace(num_molecules=n, seed=3)
    return molecules, space, molecules.featurize(space, range(n))


def test_predict_edge_bytes_and_rank(ring, monkeypatch):
    from repro_torch.apps import electrolyte
    from repro_torch.configs import mpnn_surrogate

    cfg = mpnn_surrogate.reduced()
    _, _, feats = _space(40)
    sur = electrolyte.Surrogate(cfg, seed=0, device="cpu")
    N = np.asarray(feats["atoms"]).shape[1]
    per_mol = cfg.ensemble * N * N * cfg.hidden ** 2 * 4
    monkeypatch.setattr(electrolyte, "EDGE_BYTES_BUDGET", 7 * per_mol)
    params = {k: v.detach().numpy() for k, v in sur.model.state_dict().items()}
    sur.load_numpy(params, 0.5, 2.0)
    scores, order = electrolyte.rank_space(sur, feats)
    install, predict, rank = (_named(f"mpnn.{k}")
                              for k in ("install", "predict", "rank"))
    assert len(install) == len(predict) == len(rank) == 1
    assert predict[0].attrs == {"molecules": 40, "chunks": 6,
                                "edge_bytes": 40 * per_mol}
    assert predict[0].t1 <= rank[0].t0 and rank[0].parent == -1
    assert scores.shape == (40,) and sorted(order) == list(range(40))


def test_train_records_one_span(ring):
    from repro_torch.apps import electrolyte
    from repro_torch.configs import mpnn_surrogate

    molecules, space, feats = _space(12)
    y = molecules.oracle_batch(space, range(12))
    sur = electrolyte.Surrogate(mpnn_surrogate.reduced(), seed=0,
                                device="cpu")
    sur.train(feats, y, 1e-3, 3)
    train = _named("mpnn.train")
    assert [(s.attrs, s.parent) for s in train] == [
        ({"epochs": 3, "molecules": 12}, -1)]
    assert not _named("mpnn.predict")
