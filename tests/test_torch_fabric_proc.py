"""The port's multi-process Colmena fabric on the CPU: a ``proc`` broker
round trip, ``ColmenaQueues.connect``, a ``ProcessPoolTaskServer`` task, a
``ShardedValueServer`` put/get, a two-host ``ClusterLauncher`` on localhost,
a forked inference shard serving the port's reduced ``Engine`` (its tokens
equal an in-process ``generate``'s), and a short synapp run.

Every test body runs in a thread joined with a timeout, and every get, join
and ``infer`` has its own: a hang fails one test. Processes are torn down in
``finally``.
"""
import os
import threading
import time

import numpy as np
import pytest

from repro_torch.core import (ClusterLauncher, ClusterSpec, ColmenaQueues,
                              HostSpec, ProcessPoolTaskServer,
                              ShardedValueServer)
from repro_torch.core.transport import Envelope, make_transport

BODY_TIMEOUT = 45.0      # seconds a test body may take
GET_TIMEOUT = 20.0       # seconds one get, join or infer may take


def within(fn, timeout=BODY_TIMEOUT):
    """Run ``fn`` in a daemon thread; fail if it does not end in time and
    re-raise what it raised."""
    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as exc:     # noqa: BLE001
            box["error"] = exc

    th = threading.Thread(target=run, daemon=True, name="fabric-test-body")
    th.start()
    th.join(timeout)
    assert not th.is_alive(), f"test body still running after {timeout} s"
    if "error" in box:
        raise box["error"]
    return box.get("value")


def test_proc_broker_round_trip():
    def body():
        tr = make_transport("proc", lease_timeout=10.0)
        try:
            assert tr.name == "proc" and tr._proc.pid != os.getpid()
            ch = tr.channel("t", "requests")
            for i in range(3):
                ch.put(Envelope(time.monotonic(), bytes([i]) * 5, {"i": i}))
            got = []
            while len(got) < 3:
                batch = ch.get_batch(8, timeout=GET_TIMEOUT)
                assert batch, "broker returned nothing"
                got += batch
            ch.ack(flush=True)
            assert [e.meta["i"] for e in got] == [0, 1, 2]
            assert [e.data for e in got] == [bytes([i]) * 5
                                                for i in range(3)]
            assert ch.get_batch(8, timeout=0.05) == []
        finally:
            tr.close()
        assert tr._proc is None
    within(body)


def _double(x):
    return 2 * x


def _pid_and_sum(a):
    return os.getpid(), float(np.asarray(a).sum())


def test_connect_and_process_pool_task():
    """A pool on one queue object; a second ``ColmenaQueues`` dials the same
    broker with ``connect`` and sends the tasks."""
    def body():
        owner = ColmenaQueues(["t"], backend="proc", lease_timeout=10.0)
        pool = ProcessPoolTaskServer(owner, workers_per_topic=2)
        pool.register(_double, topic="t", name="double")
        client = None
        try:
            with pool:
                client = ColmenaQueues.connect(["t"], owner.transport.address,
                                               lease_timeout=10.0)
                for i in range(4):
                    client.send_task(i, method="double", topic="t")
                got = {}
                for _ in range(4):
                    r = client.get_result("t", timeout=GET_TIMEOUT)
                    assert r is not None and r.success, r and r.error
                    got[r.args[0]] = r.value
                    assert "/t/w" in r.worker and "/pid" in r.worker
                assert got == {i: 2 * i for i in range(4)}
                assert client.get_result("t", timeout=0.2) is None
        finally:
            if client is not None:
                client.transport.client.close()
            owner.shutdown()
    within(body)


def test_sharded_value_server_put_get_and_proxy():
    def body():
        vs = ShardedValueServer(2)
        queues = ColmenaQueues(["t"], backend="proc", value_server=vs,
                               proxy_threshold=1 << 10, lease_timeout=10.0)
        pool = ProcessPoolTaskServer(queues, workers_per_topic=1)
        pool.register(_pid_and_sum, topic="t", name="sum")
        try:
            keys = {vs.put(np.full(64, i, np.float32)): i for i in range(64)}
            assert sum(1 for s in vs.per_shard_stats() if s["puts"]) == 2
            for k, i in keys.items():
                np.testing.assert_array_equal(vs.get(k),
                                              np.full(64, i, np.float32))
            arr = np.random.default_rng(0).standard_normal(
                (32, 32)).astype(np.float32)       # 4 KiB: crosses as a proxy
            with pool:
                queues.send_task(arr, method="sum", topic="t")
                r = queues.get_result("t", timeout=GET_TIMEOUT)
            assert r is not None and r.success, r and r.error
            pid, total = r.value
            assert pid != os.getpid()
            assert total == pytest.approx(float(arr.sum()), rel=1e-6)
            assert r.input_size < arr.nbytes           # the proxy, not arr
        finally:
            queues.shutdown()
            vs.shutdown()
    within(body)


def _times_ten(x):
    time.sleep(0.02)
    return x * 10


def test_two_host_cluster_launcher():
    """Two simulated hosts on localhost, each a federated broker and a pool
    of two workers; the Thinker on h0. Every task completes once."""
    def body():
        spec = ClusterSpec([HostSpec("h0", pools={"t": 2}, thinker=True),
                            HostSpec("h1", pools={"t": 2})],
                           lease_timeout=10.0)
        with ClusterLauncher(spec, methods=[(_times_ten, {"topic": "t",
                                                          "name": "t"})]) as lc:
            queues = lc.connect()
            try:
                tids = {queues.send_task(i, method="t", topic="t"): i
                        for i in range(12)}
                got, hosts = {}, set()
                for _ in tids:
                    r = queues.get_result("t", timeout=GET_TIMEOUT)
                    assert r is not None and r.success, r and r.error
                    assert r.task_id not in got, "duplicate completion"
                    got[r.task_id] = r.value
                    hosts.add(r.worker.split("/", 1)[0])
                assert got == {t: 10 * i for t, i in tids.items()}
                assert hosts and hosts <= {"h0", "h1"}
                assert queues.get_result("t", timeout=0.2) is None
                assert queues.active_count == 0
            finally:
                queues.shutdown()
                queues.transport.client.close()
    within(body, timeout=60.0)


def test_inference_shard_serves_the_ports_engine():
    """A forked shard builds the port's reduced internlm2 ``Engine`` on the
    CPU and serves four 16-token prompts; its greedy tokens equal an
    in-process ``generate`` on the same seeded weights at the same padded
    shape (bucket 16, batch 4, reserve 16 + 4)."""
    from repro_torch.serving.shard import (InferenceClient, ServeSpec,
                                           default_engine_factory,
                                           send_shard_stop,
                                           start_inference_shard)
    max_new = 4
    factory = default_engine_factory("internlm2-1.8b", reduced=True, seed=3,
                                     max_new=max_new, device="cpu")

    def body():
        spec = ServeSpec(engine_factory=factory, max_batch=4,
                         prompt_buckets=(16,), max_batch_delay_ms=2000.0,
                         max_new_cap=max_new)
        queues = ColmenaQueues([], backend="proc", serve_spec=spec,
                               lease_timeout=10.0)
        shard = start_inference_shard(queues.transport.address, spec,
                                      lease_timeout=10.0)
        try:
            engine = factory()
            rng = np.random.default_rng(0)
            prompts = rng.integers(0, engine.cfg.vocab_size, size=(4, 16),
                                   dtype=np.int32)
            res = InferenceClient(queues).infer(prompts.tolist(),
                                                max_new=max_new,
                                                timeout=GET_TIMEOUT)
            assert all(r.success for r in res), [r.error for r in res]
            want = engine.generate(prompts, max_new=max_new)[:, 16:]
            assert np.array_equal(np.array([r.value for r in res]), want)
        finally:
            try:
                send_shard_stop(queues.transport, spec.topic)
            except (ConnectionError, OSError):
                pass
            shard.join(timeout=GET_TIMEOUT)
            if shard.is_alive():
                shard.terminate()
                shard.join(timeout=5)
            queues.shutdown()
        assert shard.exitcode == 0
    within(body, timeout=60.0)


def test_synapp_runs_on_the_proc_fabric():
    """The paper's overhead tool on the multi-process topology: two pool
    workers, a two-shard Value Server and one scorer shard ranking three
    candidates a task."""
    from repro_torch.apps.synapp import SynConfig, run_synapp

    def body():
        cfg = SynConfig(T=8, D=0.01, I=1 << 12, N=2, backend="proc",
                        vs_shards=2, proxy_threshold=1 << 10,
                        score_candidates=3, lease_timeout=10.0)
        return run_synapp(cfg)
    res = within(body)
    assert res["completed_total"] == 8 and res["n_results"] == 8
    assert res["scored"] == 8 * 3
    assert res["makespan"] > 0 and 0 < res["utilization"] <= 1
    assert res["medians"]["execute"] >= 0.01 * 0.9


def _child_matmul(q):
    import torch
    x = torch.randn(256, 256, generator=torch.Generator().manual_seed(0))
    q.put((torch.get_num_threads(), float((x @ x).sum())))


def test_forked_child_runs_torch_cpu_ops_after_a_parallel_parent():
    """torch's OpenMP pool does not survive fork: without the port's at-fork
    hook (one CPU thread in every forked child) this child hangs in its
    first matmul once the parent has run a parallel op."""
    import multiprocessing

    import torch
    x = torch.randn(512, 512)
    for _ in range(3):
        x = torch.tanh(x @ x)                 # parallel in the parent
    ctx = multiprocessing.get_context("fork")
    q = ctx.Queue()
    p = ctx.Process(target=_child_matmul, args=(q,), daemon=True)
    p.start()
    try:
        threads, total = q.get(timeout=GET_TIMEOUT)
    finally:
        p.join(timeout=GET_TIMEOUT)
        if p.is_alive():
            p.terminate()
    assert threads == 1 and np.isfinite(total)
