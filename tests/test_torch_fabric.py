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

_OBS_INIT_LAYERS_OLD = """                                       obs_dir, sample_rate, sampled, span)
"""
_OBS_INIT_LAYERS_NEW = """                                       obs_dir, sample_rate, sampled, span)
from repro_torch.observability.trace import (LayerSpan, clock_offset_ns,
                                             layer, layer_at,
                                             layer_complete_since,
                                             layer_dropped, layer_spans,
                                             reset_layers)
"""
_OBS_ALL_OLD = """    "span",
]
"""
_OBS_ALL_NEW = """    "span",
    "LayerSpan", "clock_offset_ns", "layer", "layer_at",
    "layer_complete_since", "layer_dropped", "layer_spans", "reset_layers",
]
"""
_OBS_DOC_OLD = """  calibrated via the idempotent ``clock_sync`` broker op.
"""
_OBS_DOC_NEW = """  calibrated via the idempotent ``clock_sync`` broker op.  Beside them,
  the always-on in-memory ring of layer spans (``layer``, ``layer_at``,
  read back with ``layer_spans``; ``clock_offset_ns`` maps them onto
  the profiler's clock).
"""
_OBS_LINT_OLD = """literal at such a call site in ``core/**``/``serving/**`` must be
declared in ``observability.names``."""
_OBS_LINT_NEW = """literal at such a call site in ``core/**``/``serving/**`` (and
``apps/**``/``models/**``, ``obs.layer``/``obs.layer_at`` among them)
must be declared in ``observability.names``."""

_NAMES_LINT_OLD = """``core/**`` and ``serving/**`` may only use names declared here -- the
"""
_NAMES_LINT_NEW = """``core/**`` and ``serving/**`` (and, for this pass, ``apps/**`` and
``models/**``) may only use names declared here -- the
"""
_NAMES_SPANS_OLD = """    "observation_transit": "Thinker: observation envelope t_put to decode",
}
"""
_NAMES_SPANS_NEW = """    "observation_transit": "Thinker: observation envelope t_put to decode",
    # -- layer spans (always on, the in-memory ring of trace.layer) ------
    "serve.intake": "shard: ServeLoop._intake, the channel wait included "
                    "(requests drained, groups active)",
    "serve.admit": "shard: ServeLoop._admit (requests admitted, padded "
                   "rows)",
    "serve.step": "shard: ServeLoop._step, one decode round over every "
                  "group (real and padded rows of its decode calls)",
    "engine.prefill": "Engine.prefill_batch to its first tokens on the "
                      "host (rows, length)",
    "engine.decode": "Engine.decode_batch to its tokens on the host "
                     "(rows, pos)",
    "engine.gather": "Engine.gather_rows (rows)",
    "mpnn.install": "Surrogate.load_numpy",
    "mpnn.predict": "Surrogate.predict to its host copy (molecules, "
                    "chunks, edge_bytes)",
    "mpnn.rank": "rank_space: the host UCB and argsort after predict",
    "mpnn.train": "Surrogate.train, to the loss's host read (epochs, "
                  "molecules)",
}
"""
_NAMES_METRICS_OLD = """                            "the task was already cancelled",
}
"""
_NAMES_METRICS_NEW = """                            "the task was already cancelled",
    # -- models ----------------------------------------------------------
    "edge_bytes": "MPNNEnsemble.forward counter: bytes of the edge "
                  "tensors it allocated",
}
"""

_SHARD_ADMIT_OLD = '''    def _admit(self) -> None:
        """Prefill every micro-batch the batcher deems ready."""
'''
_SHARD_ADMIT_NEW = '''    def _admit(self) -> tuple:
        """Prefill every micro-batch the batcher deems ready.  Returns
        (requests admitted, padded rows prefilled)."""
        admitted = rows = 0
'''
_SHARD_QUEUE_OLD = """                obs.observe("infer_queue_delay", t_admit - req.enqueue_t)
"""
_SHARD_QUEUE_NEW = """                obs.observe("infer_queue_delay", t_admit - req.enqueue_t)
                obs.layer_at("infer_queue", round(req.enqueue_t * 1e9),
                             round(t_admit * 1e9), rid=req.task_id)
"""
_SHARD_COUNT_OLD = """                                                self.spec.max_new_cap)
            try:
"""
_SHARD_COUNT_NEW = """                                                self.spec.max_new_cap)
            admitted += len(mb.requests)
            rows += padded_b
            try:
"""
_SHARD_RETURN_OLD = """                self.groups.append(active)

    def _step(self) -> None:
"""
_SHARD_RETURN_NEW = """                self.groups.append(active)
        return admitted, rows

    def _step(self) -> None:
"""
_SHARD_LOOP_OLD = """            while not self.stop.is_set():
                self._intake()
                if self.stop.is_set():
                    break
                self._admit()
                self._step()
"""
_SHARD_LOOP_NEW = """            while not self.stop.is_set():
                # layer spans (obs.layer): always on, in memory
                drained = self.stats["requests"]
                with obs.layer("serve.intake",
                               groups=len(self.groups)) as sp:
                    self._intake()
                    sp.attrs["requests"] = self.stats["requests"] - drained
                if self.stop.is_set():
                    break
                with obs.layer("serve.admit") as sp:
                    sp.attrs["requests"], sp.attrs["rows"] = self._admit()
                # each group decodes once: its live rows, its padded rows
                with obs.layer("serve.step",
                               real=sum(len(a.group) for a in self.groups),
                               rows=sum(a.state.padded_b
                                        for a in self.groups)):
                    self._step()
"""
_LAYER_SPANS = "the port's layer spans (observability.trace.layer)"

# module -> (the first line of a section the port appends, reason): the
# copy is the original, with its deltas, up to that section
APPENDED = {
    "observability/trace.py": (
        "# layer spans: an always-on, bounded in-memory ring per process",
        "the ring of layer spans, which the JAX package does not have"),
}

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
         "torch.Generator on the card unless the caller asks for the CPU"),
        (_SHARD_ADMIT_OLD, _SHARD_ADMIT_NEW,
         "_admit returns what serve.admit records"),
        (_SHARD_QUEUE_OLD, _SHARD_QUEUE_NEW,
         "infer_queue goes to the ring for every request; " + _LAYER_SPANS),
        (_SHARD_COUNT_OLD, _SHARD_COUNT_NEW,
         "_admit counts what serve.admit records"),
        (_SHARD_RETURN_OLD, _SHARD_RETURN_NEW,
         "_admit returns what serve.admit records"),
        (_SHARD_LOOP_OLD, _SHARD_LOOP_NEW,
         "serve.intake, serve.admit, serve.step; " + _LAYER_SPANS)],
    "observability/__init__.py": [
        (_OBS_DOC_OLD, _OBS_DOC_NEW, _LAYER_SPANS),
        (_OBS_LINT_OLD, _OBS_LINT_NEW, "the lint's wider reach"),
        (_OBS_INIT_LAYERS_OLD, _OBS_INIT_LAYERS_NEW, _LAYER_SPANS),
        (_OBS_ALL_OLD, _OBS_ALL_NEW, _LAYER_SPANS)],
    "observability/names.py": [
        (_NAMES_LINT_OLD, _NAMES_LINT_NEW, "the lint's wider reach"),
        (_NAMES_SPANS_OLD, _NAMES_SPANS_NEW, _LAYER_SPANS),
        (_NAMES_METRICS_OLD, _NAMES_METRICS_NEW,
         "the MPNN's edge-tensor counter")],
    "observability/trace.py": [
        ("import atexit\nimport json\n",
         "import atexit\nimport itertools\nimport json\n", _LAYER_SPANS),
        ("import zlib\nfrom typing import Callable, Optional\n",
         "import zlib\nfrom collections import deque\n"
         "from typing import Callable, List, NamedTuple, Optional\n",
         _LAYER_SPANS)],
}


@pytest.mark.parametrize("rel", COPIED)
def test_copy_matches_original(rel):
    want = re.sub(r"\brepro\b", "repro_torch", (SRC / "repro" / rel).read_text())
    for old, new, reason in DELTAS.get(rel, []):
        assert want.count(old) == 1, f"{rel}: delta not found once ({reason})"
        want = want.replace(old, new)
    got = (SRC / "repro_torch" / rel).read_text()
    if rel in APPENDED:
        start = "\n\n# " + "-" * 71 + "\n" + APPENDED[rel][0] + "\n"
        assert got.count(start) == 1, f"{rel}: appended section not found"
        got = got[:got.index(start)]
    assert got == want


def test_deltas_name_copied_modules():
    assert set(DELTAS) <= set(COPIED)
    assert set(APPENDED) <= set(COPIED)


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
