"""The port's multi-device code held against the JAX package's own sharded
programs, on 8 ranks on a (2, 4) ("data", "model") mesh, in f32.

The port's side is one world of 8 spawned gloo CPU ranks
(``repro_torch.launch.sharded.run_world``). The reference's side is this
file run as a script in a subprocess with 8 forced host devices and a mesh
of Auto axes (``jax.make_mesh``'s default Explicit axes are refused by the
reference's ``with_sharding_constraint``); both run at once. The inputs,
JAX-initialised weights and numpy draws, go to both through a pickle.

Held here: ``moe_ep`` (kimi-k2, reduced) at capacity factors with drops and
without, the tokens that lost an assignment counted on both sides;
``psum_compressed`` over the "model" axis in its three methods, the error
feedback carried over two calls; and kimi-k2's ``moe_impl="ep_a2a"`` train
step through ``build_program`` in ``dp_tp``, 3 steps. The dense archs' train
steps are held in ``test_torch_sharded_train.py``, with this file's
helpers.
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
B, S = 8, 64
STEPS = 3
F32 = {"param_dtype": "float32", "compute_dtype": "float32"}
KIMI = "kimi-k2-1t-a32b"
CFS = (1.25, 0.5, 8.0)            # 8.0 drops nothing
METHODS = ("none", "bf16", "int8_ef")
TC = {"warmup_steps": 0}
# the train programs of this file: (arch, mode, config overrides)
TRAIN = [(KIMI, "dp_tp", {"moe_impl": "ep_a2a"})]
ATOL = 1e-5
MOMENT_ATOL = 5e-5      # of the tensor's largest |value|
ADAM_SHARE = 1e-3       # most weights that may need Adam's flip term
REF_TIMEOUT_S = 600


# ---------------------------------------------------------------------------
# inputs, made in the test process
# ---------------------------------------------------------------------------


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _params(arch, over):
    import jax

    from repro.configs.base import get_config
    from repro.models import api

    cfg = get_config(arch, reduced=True).replace(**F32, **over)
    return _np(api.init_params(cfg, jax.random.PRNGKey(0)))


def _batch(vocab, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(B, S + 1), dtype=np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def train_inputs(train):
    """{(arch, mode): (params, batch)} for each train program."""
    from repro.configs.base import get_config
    out = {}
    for i, (arch, mode, over) in enumerate(train):
        vocab = get_config(arch, reduced=True).vocab_size
        out[(arch, mode)] = (_params(arch, over), _batch(vocab, 10 + i))
    return out


def make_inputs():
    rng = np.random.default_rng(0)
    ffn = {k: v[0] for k, v in
           _params(KIMI, {})["stack"]["uniform"]["ffn"].items()}
    x = rng.standard_normal((B, S, ffn["router"].shape[0])).astype(np.float32)
    grads = [{"w": rng.standard_normal((WORLD, 6, 5)).astype(np.float32),
              "b": rng.standard_normal((WORLD, 7)).astype(np.float32)}
             for _ in range(2)]
    return {"ffn": ffn, "x": x, "grads": grads, "train": train_inputs(TRAIN)}


# ---------------------------------------------------------------------------
# the reference: this file as a script, with 8 host devices
# ---------------------------------------------------------------------------


def _ref_moe(inp, mesh):
    import jax

    from repro.configs.base import get_config
    from repro.distributed import axisenv
    from repro.models import moe

    out = {}
    for cf in CFS:
        cfg = get_config(KIMI, reduced=True).replace(
            **F32, moe_impl="ep_a2a", capacity_factor=cf)
        with axisenv.activation_axes(batch=("data",), batch_sizes=(2,),
                                     model="model", model_size=4, mesh=mesh):
            y, aux = jax.jit(lambda p, x: moe.moe_ffn(p, x, cfg))(
                inp["ffn"], inp["x"])
        out[cf] = {"y": np.asarray(y), "aux": float(aux)}
    return out


def _ref_psum(inp, mesh):
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.distributed.compat import shard_map
    from repro.optim import compress

    spec = P(("data", "model"))
    out = {}
    for method in METHODS:
        def body(g, e=None):
            g = jax.tree.map(lambda t: t[0], g)
            e = None if e is None else jax.tree.map(lambda t: t[0], e)
            m, ne = compress.psum_compressed(g, "model", method, e)
            lead = lambda t: jax.tree.map(lambda a: a[None], t)  # noqa: E731
            return lead(m), (None if ne is None else lead(ne))

        calls, errors = [], None
        for grads in inp["grads"]:
            if errors is None:
                out_specs = (spec, spec if method == "int8_ef" else None)
                fn = shard_map(lambda g: body(g), mesh=mesh, in_specs=(spec,),
                               out_specs=out_specs)
                means, errors = jax.jit(fn)(grads)
            else:
                fn = shard_map(body, mesh=mesh, in_specs=(spec, spec),
                               out_specs=(spec, spec))
                means, errors = jax.jit(fn)(grads, errors)
            calls.append({"means": _np(means),
                          "errors": None if errors is None else _np(errors)})
        out[method] = calls
    return out


def _ref_train(inp, mesh, train):
    import jax

    from repro.configs.base import (ShapeConfig, ShardingConfig,
                                    TrainConfig, get_config)
    from repro.launch import steps
    from repro.optim import adamw

    out = {}
    for arch, mode, over in train:
        cfg = get_config(arch, reduced=True).replace(**F32, **over)
        params, batch = inp["train"][(arch, mode)]
        jfn, _ = steps.build_program(
            cfg, ShapeConfig("t", "train", S, B), mesh,
            tc=TrainConfig(**TC), sc=ShardingConfig(mode=mode))
        state = {"params": params, "opt": adamw.init(params)}
        metrics = []
        for _ in range(STEPS):
            state, m = jfn(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        out[(arch, mode)] = {
            "metrics": metrics,
            "state": {"params": _np(state["params"]),
                      "m": _np(state["opt"].m), "v": _np(state["opt"].v)}}
    return out


def reference(in_path, out_path, parts):
    import jax
    from jax.sharding import AxisType

    with open(in_path, "rb") as f:
        inp = pickle.load(f)
    mesh = jax.make_mesh(MESH, ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    out = {}
    with mesh:
        if "moe" in parts:
            out["moe"] = _ref_moe(inp, mesh)
        if "psum" in parts:
            out["psum"] = _ref_psum(inp, mesh)
        out["train"] = _ref_train(inp, mesh, inp["train_programs"])
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def start_reference(tmp, inputs, parts):
    """Start this file as the reference in a subprocess; returns
    (process, output path)."""
    in_path, out_path = tmp / "inputs.pkl", tmp / "reference.pkl"
    with open(in_path, "wb") as f:
        pickle.dump(inputs, f)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.Popen(
        [sys.executable, __file__, str(in_path), str(out_path),
         ",".join(parts)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    return proc, out_path


def finish_reference(proc, out_path):
    try:
        log, _ = proc.communicate(timeout=REF_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, log[-4000:]
    with open(out_path, "rb") as f:
        return pickle.load(f)


def train_payloads(inputs, train):
    return [("train", {"arch": arch, "config": {**F32, **over},
                       "mesh": MESH, "mode": mode, "steps": STEPS, "tc": TC,
                       "params": inputs["train"][(arch, mode)][0],
                       "batch": inputs["train"][(arch, mode)][1]})
            for arch, mode, over in train]


def run_both(tmp, inputs, parts, payloads):
    """The reference subprocess and the port's world, at once."""
    from repro_torch.launch import sharded

    inputs = {**inputs, "train_programs": inputs.get("train_programs", [])}
    proc, out_path = start_reference(tmp, inputs, parts)
    try:
        port = sharded.run_world(sharded.batch_job, WORLD, payloads,
                                 timeout_s=REF_TIMEOUT_S)
    except BaseException:
        proc.kill()
        raise
    return finish_reference(proc, out_path), port


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    inputs = {**make_inputs(), "train_programs": TRAIN}
    payloads = (
        [("moe", {"arch": KIMI, "mesh": MESH, "ffn": inputs["ffn"],
                  "x": inputs["x"],
                  "config": {**F32, "moe_impl": "ep_a2a",
                             "capacity_factor": cf}}) for cf in CFS]
        + [("psum", {"mesh": MESH, "method": m, "grads": inputs["grads"]})
           for m in METHODS]
        + train_payloads(inputs, TRAIN))
    ref, port = run_both(tmp_path_factory.mktemp("dist"), inputs,
                         ("moe", "psum"), payloads)
    n = len(CFS)
    return {"ref": ref, "inputs": inputs,
            "moe": dict(zip(CFS, port[0][:n])),
            "psum": {m: [r[n + i] for r in port]
                     for i, m in enumerate(METHODS)},
            "train": {(a, m): port[0][n + len(METHODS) + i]
                      for i, (a, m, _) in enumerate(TRAIN)},
            "placed": {(a, m): all(r[n + len(METHODS) + i]["placed"]
                                   for r in port)
                       for i, (a, m, _) in enumerate(TRAIN)}}


# ---------------------------------------------------------------------------
# holds
# ---------------------------------------------------------------------------


def _lost(y, y_all):
    """Tokens whose output lost at least one expert assignment: those that
    differ from the output of the capacity that drops nothing."""
    return int((np.abs(y - y_all).max(-1) > 1e-4).sum())


@pytest.mark.parametrize("cf", CFS)
def test_moe_ep_matches_reference(results, cf):
    got, want = results["moe"][cf], results["ref"]["moe"][cf]
    np.testing.assert_allclose(got["y"], want["y"], rtol=0, atol=ATOL)
    assert abs(got["aux"] - want["aux"]) <= ATOL
    lost = _lost(got["y"], results["moe"][8.0]["y"])
    assert lost == _lost(want["y"], results["ref"]["moe"][8.0]["y"])
    if cf == 0.5:
        assert lost > 0          # this capacity drops assignments


def test_moe_ep_without_drops_is_the_dropping_path(results):
    """At capacity 8.0 nothing is dropped: the EP layer equals the port's
    single-process moe_dropping on the same weights."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models import moe

    cfg = get_config(KIMI, reduced=True).replace(**F32, capacity_factor=8.0)
    p = {k: torch.tensor(v) for k, v in results["inputs"]["ffn"].items()}
    y, aux = moe.moe_dropping(p, torch.tensor(results["inputs"]["x"]), cfg)
    np.testing.assert_allclose(results["moe"][8.0]["y"], y.numpy(), rtol=0,
                               atol=ATOL)


def _bf16_ulp(v):
    """One bf16 ulp at the scale of v (its largest magnitude)."""
    return 2.0 ** (np.floor(np.log2(np.abs(v).max())) - 7)


@pytest.mark.parametrize("method", METHODS)
def test_psum_compressed_matches_reference(results, method):
    ref = results["ref"]["psum"][method]
    for call in range(2):
        for rank in range(WORLD):
            got = results["psum"][method][rank][call]
            for name in ("w", "b"):
                want = ref[call]["means"][name][rank]
                tol = _bf16_ulp(want) if method == "bf16" else 1e-6
                np.testing.assert_allclose(got["means"][name], want, rtol=0,
                                           atol=tol)
                if method == "int8_ef":
                    # an error is g + e - q * scale, a difference of values
                    # at the gradient's scale: XLA's fused form of it (under
                    # jit, in shard_map) may round it once differently
                    scale = np.abs(results["inputs"]["grads"][call][name]
                                   ).max()
                    np.testing.assert_allclose(
                        got["errors"][name], ref[call]["errors"][name][rank],
                        rtol=0, atol=float(np.spacing(np.float32(scale))))
                else:
                    assert got["errors"] is None


def hold_train(results, arch, mode):
    got, want = results["train"][(arch, mode)], results["ref"]["train"][
        (arch, mode)]
    for t, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        for name in ("loss", "ce", "aux", "grad_norm", "lr", "tokens"):
            assert abs(g[name] - w[name]) <= ATOL, (t, name, g[name], w[name])
    from repro_torch.utils.trees import tree_flatten_with_paths

    # Adam's step for a gradient within a few eps of zero can flip sign
    # between two sums of the same terms in another order: such a weight
    # moves by up to 2 lr a step (as in test_torch_train.py)
    flip = 2 * sum(m["lr"] for m in want["metrics"])
    n_flip = n_params = 0
    for part in ("params", "m", "v"):
        gl = dict(tree_flatten_with_paths(got["state"][part]))
        wl = dict(tree_flatten_with_paths(want["state"][part]))
        assert list(gl) == list(wl)
        for key in wl:
            w, g = np.asarray(wl[key], np.float64), np.asarray(gl[key])
            err = np.abs(g - w)
            if part == "params":
                assert (err <= ATOL + flip).all(), (key, err.max())
                n_flip += int((err > ATOL).sum())
                n_params += w.size
            else:
                tol = ATOL * np.abs(w) + MOMENT_ATOL * np.abs(w).max()
                assert (err <= tol).all(), (part, key, (err - tol).max())
    assert n_flip <= ADAM_SHARE * n_params, (n_flip, n_params)
    assert results["placed"][(arch, mode)]


def test_kimi_ep_a2a_train_steps_match_reference(results):
    hold_train(results, KIMI, "dp_tp")


if __name__ == "__main__":
    reference(sys.argv[1], sys.argv[2], sys.argv[3].split(","))
