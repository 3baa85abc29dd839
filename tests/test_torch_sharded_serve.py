"""The port's sharded prefill and decode programs (``launch/steps.py``'s
``build_program("prefill")``, ``shard_cache`` and ``build_program("decode")``)
held against the JAX package's own ``build_program("prefill")``,
``grow_cache`` and ``build_program("decode")`` on a (2, 4) ("data", "model")
mesh, in f32.

Every program runs a prompt of 64 tokens and 3 decode steps, each step fed
the same given token on both sides. The port's side is one world of 8
spawned gloo CPU ranks; the reference's side is this file run as a script
in a subprocess with 8 forced host devices and a mesh of Auto axes (the
harness of ``test_torch_distributed.py``); both run at once. The port runs
``attn_impl="kernel"``: its prefill attention and scans go through the
kernel wrappers, which run their plain versions on each rank's local shards
(``kernels/dispatch.py::run_local``); the reference runs its plain
attention. Held: the logits of prefill and of every step, every cache leaf
after the last step (rtol = atol = 1e-5; zamba2 at the 1e-4 at which the
suite holds it on one device), and the placement of every cache leaf
against ``cache_spec``.

The programs: reduced internlm2 in ``dp_tp``, ``fsdp_tp`` and ``dp_only``
with its 2 KV heads, which the model axis of 4 cannot shard (``cache_spec``
replicates the KV heads), and with ``num_kv_heads=4``, which it shards over
"model"; reduced zamba2, rwkv6 (its zero-initialised leaves drawn at
random), seamless-m4t-medium (random frames) and kimi-k2 with
``moe_impl="ep_a2a"`` (its decode, one position, falls back to the dropping
path on both sides), each in ``dp_tp``.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
MESH = (2, 4)
WORLD = MESH[0] * MESH[1]
B, S, STEPS = 8, 64, 3
F32 = {"param_dtype": "float32", "compute_dtype": "float32"}
TOL = 1e-5
# zamba2's f32 scans drift further: the suite holds it at 1e-4 against the
# JAX package on one device too (test_torch_zamba2.py)
ARCH_TOL = {"zamba2-1.2b": 1e-4}
REF_TIMEOUT_S = 600
LM = "internlm2-1.8b"
# (arch, mode, config overrides)
PROGRAMS = [
    (LM, "dp_tp", {}),
    (LM, "fsdp_tp", {}),
    (LM, "dp_only", {}),
    (LM, "dp_tp", {"num_kv_heads": 4}),
    ("zamba2-1.2b", "dp_tp", {}),
    ("rwkv6-3b", "dp_tp", {}),
    ("seamless-m4t-medium", "dp_tp", {}),
    ("kimi-k2-1t-a32b", "dp_tp", {"moe_impl": "ep_a2a"}),
]


def _ids(programs):
    return [f"{a}-{m}" + "".join(f"-{k}={v}" for k, v in o.items())
            for a, m, o in programs]


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _randomise_rwkv(params, seed):
    """The leaves the JAX initializer zeroes or sets to ones, drawn at
    random (as ``test_torch_rwkv6.py`` draws them)."""
    rng = np.random.default_rng(seed)
    tm = params["stack"]["rwkv"]["tmix"]
    cm = params["stack"]["rwkv"]["cmix"]
    for leaves, name in [(tm, n) for n in ("mu_r", "mu_k", "mu_v", "mu_g",
                                           "mu_w")] + [(cm, "mu_k")]:
        leaves[name] = rng.uniform(0, 1, leaves[name].shape).astype(
            np.float32)
    tm["w0"] = rng.uniform(-2, 1, tm["w0"].shape).astype(np.float32)
    tm["u"] = rng.standard_normal(tm["u"].shape).astype(np.float32)
    tm["ln_x"] = rng.uniform(0.5, 1.5, tm["ln_x"].shape).astype(np.float32)
    return params


def make_inputs(programs):
    """{(arch, mode, overrides): (params, batch, fed tokens)}."""
    import jax

    from repro.configs.base import get_config
    from repro.models import api

    out = {}
    for i, (arch, mode, over) in enumerate(programs):
        cfg = get_config(arch, reduced=True).replace(**F32, **over)
        params = _np(api.init_params(cfg, jax.random.PRNGKey(i)))
        if cfg.rwkv:
            params = _randomise_rwkv(params, i)
        rng = np.random.default_rng(100 + i)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S),
                                        dtype=np.int32)}
        if cfg.is_encdec:
            batch["frames"] = rng.standard_normal(
                (B, S, cfg.d_model)).astype(np.float32)
        feed = rng.integers(0, cfg.vocab_size, (B, STEPS), dtype=np.int32)
        out[_ids([(arch, mode, over)])[0]] = (params, batch, feed)
    return out


# ---------------------------------------------------------------------------
# the reference: this file as a script, with 8 host devices
# ---------------------------------------------------------------------------


def reference(in_path, out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.configs.base import ShapeConfig, ShardingConfig, get_config
    from repro.launch import steps
    from repro.models import api

    with open(in_path, "rb") as f:
        inp = pickle.load(f)
    mesh = jax.make_mesh(MESH, ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    out = {}
    with mesh:
        for (arch, mode, over), key in zip(inp["programs"],
                                           _ids(inp["programs"])):
            cfg = get_config(arch, reduced=True).replace(**F32, **over)
            params, batch, feed = inp["inputs"][key]
            sc = ShardingConfig(mode=mode)
            dec = ShapeConfig("d", "decode", S + STEPS, B)
            prefill, _ = steps.build_program(
                cfg, ShapeConfig("p", "prefill", S, B), mesh, sc=sc)
            decode, _ = steps.build_program(cfg, dec, mesh, sc=sc)
            logits, cache = prefill(params, batch)
            got = [np.asarray(logits)]
            # the jitted decode takes the cache on its in_shardings
            cache = jax.device_put(
                api.grow_cache(cfg, cache, S + STEPS),
                steps.input_shardings(cfg, dec, mesh, mode)["cache"])
            for t in range(STEPS):
                logits, cache = decode(params, cache, feed[:, t:t + 1],
                                       jnp.int32(S + t))
                got.append(np.asarray(logits))
            out[key] = {"logits": got, "cache": _np(cache)}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def run_both(tmp, programs):
    """The reference subprocess and the port's world, at once."""
    from repro_torch.launch import sharded

    inputs = make_inputs(programs)
    in_path, out_path = tmp / "inputs.pkl", tmp / "reference.pkl"
    with open(in_path, "wb") as f:
        pickle.dump({"programs": programs, "inputs": inputs}, f)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.Popen([sys.executable, __file__, str(in_path),
                             str(out_path)], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    payloads = [("serve", {"arch": arch, "config": {**F32, "attn_impl":
                                                    "kernel", **over},
                           "mesh": MESH, "mode": mode,
                           "params": inputs[key][0], "batch": inputs[key][1],
                           "tokens": inputs[key][2]})
                for (arch, mode, over), key in zip(programs, _ids(programs))]
    try:
        port = sharded.run_world(sharded.batch_job, WORLD, payloads,
                                 timeout_s=REF_TIMEOUT_S)
        log, _ = proc.communicate(timeout=REF_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, log[-4000:]
    with open(out_path, "rb") as f:
        ref = pickle.load(f)
    return ref, port


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    ref, port = run_both(tmp_path_factory.mktemp("serve"), PROGRAMS)
    keys = _ids(PROGRAMS)
    return {"ref": ref,
            "port": {k: port[0][i] for i, k in enumerate(keys)},
            "placed": {k: all(r[i]["placed"] for r in port)
                       for i, k in enumerate(keys)}}


def _close(got, want, key):
    tol = ARCH_TOL.get(key.split("-dp")[0].split("-fsdp")[0], TOL)
    np.testing.assert_allclose(got, np.asarray(want, np.float64), rtol=tol,
                               atol=tol)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


@pytest.mark.parametrize("key", _ids(PROGRAMS))
def test_sharded_prefill_and_decode_logits_match_reference(results, key):
    got, want = results["port"][key], results["ref"][key]
    assert len(got["logits"]) == len(want["logits"]) == 1 + STEPS
    for g, w in zip(got["logits"], want["logits"]):
        _close(g, w, key)


@pytest.mark.parametrize("key", _ids(PROGRAMS))
def test_sharded_cache_matches_reference(results, key):
    got = dict(_leaves(results["port"][key]["cache"]))
    want = dict(_leaves(results["ref"][key]["cache"]))
    assert list(got) == list(want)
    for path in want:
        assert got[path].shape == want[path].shape, path
        _close(got[path], want[path], key)


@pytest.mark.parametrize("key", _ids(PROGRAMS))
def test_sharded_cache_placements_follow_cache_spec(results, key):
    assert results["placed"][key]


def test_kv_cache_sharded_over_model_and_replicated():
    """The two internlm2 caches: 4 KV heads shard over "model", 2 do not."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import MeshShape

    mesh = MeshShape(MESH, ("data", "model"))
    shape = ShapeConfig("d", "decode", S + STEPS, B)
    for kv, want in ((2, None), (4, "model")):
        cfg = get_config(LM, reduced=True).replace(num_kv_heads=kv)
        spec = steps.input_shardings(cfg, shape, mesh)["cache"]["k"]
        assert tuple(spec) == (None, "data", None, want, None)


def test_remat_recompute_sees_the_forward_axis_env():
    """A rematerialised block's recompute runs under the forward's axis
    environment, also when autograd runs it on another thread (as it does
    on its device thread for CUDA tensors)."""
    import threading

    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.distributed import axisenv
    from repro_torch.models import transformer

    seen = []

    def block(x):
        seen.append(axisenv.current())
        return (x * 2).sin()

    cfg = get_config(LM, reduced=True).replace(remat="block")
    x = torch.randn(3, requires_grad=True)
    with axisenv.activation_axes(model="model", model_size=4):
        env = axisenv.current()
        y = transformer._ckpt(block, cfg, None)(x).sum()
    out = {}
    t = threading.Thread(target=lambda: out.update(g=torch.autograd.grad(
        y, x)))
    t.start()
    t.join(timeout=30)
    assert seen == [env, env]            # the forward and its recompute
    torch.testing.assert_close(out["g"][0], 2 * (2 * x).cos().detach())


if __name__ == "__main__":
    reference(sys.argv[1], sys.argv[2])
