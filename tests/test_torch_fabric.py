"""The port's copy of the Colmena fabric against the JAX package's original:
every copied module's source equals the original's, with ``repro`` renamed
``repro_torch`` and the named deltas applied, and a few behaviours give the
same results in both packages."""
import importlib
import re
from pathlib import Path

import numpy as np
import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
PACKAGES = ["repro", "repro_torch"]

# Copied modules, relative to the package root.
COPIED = [
    "utils/__init__.py", "utils/timing.py",
    "observability/__init__.py", "observability/metrics.py",
    "observability/names.py", "observability/trace.py",
    "core/__init__.py", "core/message.py",
    "core/transport/__init__.py", "core/transport/base.py",
    "core/transport/local.py", "core/transport/ndcodec.py",
    "core/value_server.py", "core/queues.py", "core/streaming.py",
    "core/resources.py", "core/task_server.py", "core/thinker.py",
    "core/campaign.py",
    # the multi-process fabric
    "core/transport/frames.py", "core/transport/shm.py",
    "core/transport/broker.py", "core/transport/proc.py",
    "core/transport/shards.py", "core/process_pool.py",
    "observability/monitor.py", "observability/report.py",
    "core/cluster/__init__.py", "core/cluster/spec.py",
    "core/cluster/agent.py", "core/cluster/federation.py",
    "core/cluster/launcher.py",
    "serving/batcher.py", "serving/shard.py", "apps/synapp.py",
]

_NDCODEC_HOST_OLD = '''    """(host_ndarray, kind) for a codec-eligible value, else (None, None).
    jax is recognized only when already imported -- the codec must never
    be the thing that pulls a multi-hundred-MB runtime into a process
    that was not going to use it."""
    if isinstance(value, np.ndarray):
        return value, "np"
    jax = sys.modules.get("jax")
    if jax is not None and isinstance(value, getattr(jax, "Array", ())):
        try:
            host = np.from_dlpack(value)    # zero-copy on CPU backends
        except Exception:                   # noqa: BLE001
            host = np.asarray(value)
        return host, "jax"
    return None, None'''
_NDCODEC_HOST_NEW = '''    """(host_ndarray, kind) for a codec-eligible value, else (None, None).
    Only numpy arrays are eligible: a torch tensor falls back to pickle,
    so payloads leave the device as numpy before they are sent."""
    if isinstance(value, np.ndarray):
        return value, "np"
    return None, None'''
_NDCODEC_DECODE_OLD = '''    ``data``; ``kind == "jax"`` re-materializes a device array when jax
    is importable here (a consumer without jax still gets the host
    view -- same numbers, host memory)."""
    if not data.startswith(MAGIC):
        return pickle.loads(data)
    off = len(MAGIC) + _LEN.size
    hlen = _LEN.unpack_from(data, len(MAGIC))[0]
    meta = pickle.loads(data[off:off + hlen])
    arr = np.frombuffer(data, dtype=np.dtype(meta["dtype"]),
                        offset=off + hlen).reshape(meta["shape"])
    if meta["kind"] == "jax" and "jax" in sys.modules:
        import jax.numpy as jnp
        return jnp.asarray(arr)
    return arr'''
_NDCODEC_DECODE_NEW = '''    ``data``, whatever the frame's kind (a "jax" frame written by the
    JAX package decodes to the host view -- same numbers, host memory)."""
    if not data.startswith(MAGIC):
        return pickle.loads(data)
    off = len(MAGIC) + _LEN.size
    hlen = _LEN.unpack_from(data, len(MAGIC))[0]
    meta = pickle.loads(data[off:off + hlen])
    arr = np.frombuffer(data, dtype=np.dtype(meta["dtype"]),
                        offset=off + hlen).reshape(meta["shape"])
    return arr'''

_ENGINE_FACTORY_OLD = '''                           max_new: int = 32) -> Callable:
    """An engine factory for the reduced reference model.  Returned as a
    closure so the (heavy, jax-importing) build happens inside the shard
    process, never in the fabric process that declares the spec."""
    def build():
        import jax
        from repro_torch.configs.base import get_config
        from repro_torch.models import api
        from repro_torch.serving.engine import Engine
        cfg = get_config(arch, reduced=reduced)
        params = api.init_params(cfg, jax.random.PRNGKey(seed))
        return Engine(cfg, params, max_new=max_new)'''
_ENGINE_FACTORY_NEW = '''                           max_new: int = 32,
                           device: str = "cuda") -> Callable:
    """An engine factory for the reduced reference model.  Returned as a
    closure so the build happens inside the shard process, never in the
    fabric process that declares the spec: a child forked from a process
    that has initialised CUDA cannot use the card.  The weights are drawn
    on ``device`` (the card unless the caller asks for "cpu") from a
    ``torch.Generator`` seeded with ``seed``."""
    def build():
        import torch
        from repro_torch.configs.base import get_config
        from repro_torch.models import api
        from repro_torch.serving.engine import Engine
        cfg = get_config(arch, reduced=reduced)
        gen = torch.Generator(device=device).manual_seed(seed)
        params = api.init_params(cfg, gen, device=device)
        return Engine(cfg, params, max_new=max_new)'''

# module -> [(text of the renamed original, text of the copy, reason)]
# Not a delta of any copied module: ``repro_torch/__init__.py`` registers an
# at-fork hook that runs every forked child's torch CPU ops on one thread
# (torch's OpenMP pool does not survive fork; the fabric keeps `fork`).
DELTAS = {
    "core/__init__.py": [
        ("from repro_torch.core.message import",
         "from repro_torch.core import policies  # noqa: F401\n"
         "from repro_torch.core.message import",
         "the port's core package also holds the steering policies")],
    "core/transport/ndcodec.py": [
        ("import struct\nimport sys\n", "import struct\n",
         "sys served only the jax branches"),
        (_NDCODEC_HOST_OLD, _NDCODEC_HOST_NEW,
         "no jax branch: the port never sees a jax array"),
        (_NDCODEC_DECODE_OLD, _NDCODEC_DECODE_NEW,
         "no jax branch: a 'jax'-kind frame decodes to the host array")],
    "serving/shard.py": [
        (_ENGINE_FACTORY_OLD, _ENGINE_FACTORY_NEW,
         "the default engine is the port's, drawn from a seeded "
         "torch.Generator on the card unless the caller asks for the CPU")],
}


@pytest.mark.parametrize("rel", COPIED)
def test_copy_matches_original(rel):
    want = re.sub(r"\brepro\b", "repro_torch", (SRC / "repro" / rel).read_text())
    for old, new, reason in DELTAS.get(rel, []):
        assert want.count(old) == 1, f"{rel}: delta not found once ({reason})"
        want = want.replace(old, new)
    assert (SRC / "repro_torch" / rel).read_text() == want


def test_deltas_name_copied_modules():
    assert set(DELTAS) <= set(COPIED)


def _core(pkg):
    return importlib.import_module(f"{pkg}.core")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_task_round_trip(pkg):
    core = _core(pkg)
    queues = core.ColmenaQueues(["square"])
    server = core.TaskServer(queues, workers_per_topic=2)
    server.register(lambda x: x * x, topic="square", name="square")

    class Squarer(core.BaseThinker):
        def __init__(self, queues):
            super().__init__(queues)
            self.got = []

        @core.agent
        def submit(self):
            for i in range(6):
                self.queues.send_task(i, method="square", topic="square")

        @core.result_processor(topic="square")
        def collect(self, result):
            assert result.success, result.error
            self.got.append((result.args[0], result.value))
            if len(self.got) == 6:
                self.done.set()

    thinker = Squarer(queues)
    with server:
        thinker.run(timeout=30)
    assert sorted(thinker.got) == [(i, i * i) for i in range(6)]
    assert thinker.logger_lines == []


@pytest.mark.parametrize("pkg", PACKAGES)
def test_value_crosses_as_proxy(pkg):
    core = _core(pkg)
    vs = core.ValueServer()
    queues = core.ColmenaQueues(["echo"], value_server=vs,
                                proxy_threshold=1 << 10)
    server = core.TaskServer(queues, workers_per_topic=1)
    seen = []

    def echo(a):
        seen.append(type(a))
        return a * 2

    server.register(echo, topic="echo")
    arr = np.random.default_rng(0).standard_normal((64, 64)).astype(np.float32)
    proxied = core.value_server.proxy_tree({"a": arr, "b": 1}, vs, 1 << 10)
    assert isinstance(proxied["a"], core.Proxy) and proxied["b"] == 1
    assert proxied["a"].resolve(vs) is arr
    with server:
        queues.send_task(arr, method="echo", topic="echo")
        result = queues.get_result("echo", timeout=30)
    assert result is not None and result.success, result
    assert seen == [np.ndarray]
    assert isinstance(result.value, np.ndarray)
    np.testing.assert_array_equal(result.value, arr * 2)
    # the proxy_tree above, the task's input and the result's value
    assert vs.stats["puts"] == 3
    assert result.output_size < arr.nbytes


@pytest.mark.parametrize("pkg", PACKAGES)
def test_resource_reallocation(pkg):
    tracker = _core(pkg).ResourceTracker({"qc": 4, "ml": 0})
    assert tracker.acquire("qc", 3)
    assert tracker.reallocate("qc", "ml", 2) == 1      # one free, one deferred
    assert tracker.allocation("qc") == 3 and tracker.allocation("ml") == 1
    tracker.release("qc", 1)                           # the deferred one moves
    assert tracker.allocation("qc") == 2 and tracker.allocation("ml") == 2
    assert tracker.utilization() == {"qc": (2, 2), "ml": (0, 2)}
    assert not tracker.acquire("qc", 1, timeout=0.01)
    assert tracker.acquire("ml", 2, timeout=0.01)


@pytest.mark.parametrize("writer,reader", [("repro", "repro_torch"),
                                           ("repro_torch", "repro")])
def test_campaign_record_crosses_packages(writer, reader, tmp_path):
    src, dst = _core(writer), _core(reader)
    record = src.CampaignRecord(lambda d: d.get("ip"))
    for i, v in enumerate([9.5, 11.2, 10.1]):
        record.add(src.Observation(str(i), "qc", "ip", v, cost=6.0,
                                   time=0.5 * i))
    path = str(tmp_path / "record.json")
    record.save(path)
    back = dst.CampaignRecord(lambda d: d.get("ip"))
    assert back.restore(path) == 3
    assert back.value() == record.value() == 11.2
    assert back.cost() == record.cost() == 18.0
    assert ([vars(o) for o in back.observations()]
            == [vars(o) for o in record.observations()])
