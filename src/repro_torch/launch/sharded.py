"""Worlds of ranks for the sharded programs, and the jobs they run.

``run_world(job, world_size, payload)`` spawns ``world_size`` ranks (the
``spawn`` start method: a forked child could not use the card), which meet
through a file in a fresh temp dir (no fixed port), join the default
process group over gloo (``distributed/comm.py``), run ``job(rank,
world_size, payload)`` and send back what it returns. Every rank is joined
with a timeout; when one fails or the time runs out the rest are killed and
``run_world`` raises with the failing rank's traceback. CPU ranks take one
torch thread each.

``init_ep_params`` draws the weights of expert-parallel serving on a mesh,
each rank only its own experts.

The jobs, each at an arch's reduced config on a ("data", "model") mesh of
``payload["mesh"]``:

- ``train_job``: the sharded train step (``steps.build_program``) for
  ``payload["steps"]`` steps from given params and batch; returns the
  metrics of every step, the whole params and moments after them (rank 0),
  and whether every leaf's placement equals its resolved spec
  (``placements_match``).
- ``moe_job``: one ``moe_ep`` layer on DTensors; returns the whole output
  and aux loss (rank 0).
- ``psum_job``: ``optim.compress.psum_compressed`` over the "model" axis
  group, twice, carrying the error feedback; returns every rank's means and
  errors.
- ``serve_job``: the sharded prefill (``build_program("prefill")``), then
  ``shard_cache`` and ``payload["tokens"]``' decode steps
  (``build_program("decode")``), one column of the given tokens a step;
  returns the logits of prefill and of every step, the whole cache after
  them (rank 0), and whether every cache leaf's placement equals its
  ``cache_spec``.
- ``batch_job``: a list of (job name, payload) in order, in one world.

Payloads and results are numpy (pickled across the queue). ``device``
"cuda" puts every rank on card 0 and stages DTensor's collectives through
the host (``comm.stage_cuda_collectives``).
"""
from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback

import numpy as np
import torch

from repro_torch.configs.base import (ShapeConfig, ShardingConfig,
                                      TrainConfig, get_config)
from repro_torch.utils.trees import whole


def _rank_main(rank, world_size, init, job, payload, results, device):
    try:
        import logging

        # DTensor logs a warning for every two-step redistribution
        logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
        from repro_torch.distributed import comm
        if device == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(0)
        comm.init_world(rank, world_size, init)
        if device == "cuda":
            comm.stage_cuda_collectives()
        out = job(rank, world_size, payload, device)
        import torch.distributed as dist
        dist.barrier()
        dist.destroy_process_group()
        results.put((rank, "ok", out))
    except Exception:                           # reported to the parent
        results.put((rank, "error", traceback.format_exc()))


def run_world(job, world_size: int, payload, *, device: str = "cpu",
              timeout_s: float = 300.0):
    """Run ``job`` on ``world_size`` spawned ranks; returns their results
    in rank order."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="world-") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world_size, init, job, payload,
                                   results, device), daemon=True)
                 for r in range(world_size)]
        for p in procs:
            p.start()
        out, deadline = {}, time.monotonic() + timeout_s
        try:
            while len(out) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"world of {world_size}: ranks "
                        f"{sorted(set(range(world_size)) - set(out))} did "
                        f"not finish in {timeout_s:.0f} s")
                try:
                    rank, status, value = results.get(timeout=min(left, 5.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if not p.is_alive() and r not in out]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} died with exit code "
                            f"{procs[dead[0]].exitcode}") from None
                    continue
                if status != "ok":
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                out[rank] = value
        finally:
            for p in procs:
                p.join(timeout=10 if len(out) == world_size else 0.1)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    return [out[r] for r in range(world_size)]


# ---------------------------------------------------------------------------
# Jobs
# ---------------------------------------------------------------------------


def _config(payload):
    cfg = get_config(payload["arch"], reduced=True)
    return cfg.replace(**payload.get("config", {}))


def _mesh(payload, device):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(payload["mesh"], ("data", "model"), device)


def _tensors(tree, device):
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree)).to(device)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def placements_match(tree, specs, mesh):
    from repro_torch.distributed.sharding import placements
    if isinstance(tree, dict):
        return all(placements_match(tree[k], specs[k], mesh) for k in tree)
    return tuple(tree.placements) == placements(specs, mesh)


def init_ep_params(cfg, mesh, seed: int, device):
    """Params for expert-parallel serving on ``mesh``: every weight whole
    and alike on each rank (drawn from ``seed``), except the stacked expert
    weights (logical axes (..., "experts", d, f)), of which each rank draws
    only its own E / tp experts, from a generator of its own, as DTensors
    sharded over "model". Nothing is drawn whole that a rank does not
    keep."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding as shd
    from repro_torch.models import api
    from repro_torch.models.layers import InitMaker, dtype_of

    tp = shd.axis_sizes(mesh)["model"]
    rank = mesh.get_local_rank("model")
    local = torch.Generator(device=device).manual_seed(seed * 1000 + 1 + rank)

    class Maker(InitMaker):
        def param(self, shape, axes=None, init="normal", scale=None,
                  fan_in=None):
            if not axes or len(axes) < 3 or axes[-3] != "experts":
                return super().param(shape, axes, init, scale, fan_in)
            i = len(axes) - 3
            shared, self.generator = self.generator, local
            try:
                t = super().param(shape[:i] + (shape[i] // tp,)
                                  + tuple(shape[i + 1:]), axes, init, scale,
                                  fan_in)
            finally:
                self.generator = shared
            spec = shd.P(*[("model" if j == i else None)
                           for j in range(len(shape))])
            return DTensor.from_local(t, mesh, shd.placements(spec, mesh),
                                      run_check=False)

    gen = torch.Generator(device=device).manual_seed(seed)
    return api.model_params(Maker(gen, dtype_of(cfg.param_dtype), device),
                            cfg)


def train_job(rank, world_size, payload, device):
    """payload: arch, config overrides, mesh, mode, steps, tc (a dict of
    TrainConfig fields), params (numpy tree), batch (numpy)."""
    from repro_torch.launch import steps
    from repro_torch.models import convert
    from repro_torch.optim import adamw

    cfg = _config(payload)
    mesh = _mesh(payload, device)
    sc = ShardingConfig(mode=payload["mode"])
    tc = TrainConfig(**payload.get("tc", {}))
    batch = _tensors(payload["batch"], device)
    B, S = batch["labels"].shape
    shape = ShapeConfig("train", "train", S, B)
    params = convert.lm_params_from_numpy(payload["params"], cfg, device)
    st_specs = steps.state_shardings(cfg, mesh, sc)
    state = steps.shard_tree({"params": params, "opt": adamw.init(params)},
                             st_specs, mesh)
    del params
    batch = steps.shard_tree(batch, steps.input_shardings(
        cfg, shape, mesh, sc.mode)["batch"], mesh)
    step, _ = steps.build_program(cfg, shape, mesh, tc=tc, sc=sc)
    metrics = []
    for _ in range(payload["steps"]):
        state, m = step(state, batch)
        metrics.append({k: float(whole(v)) for k, v in m.items()})
    placed = (placements_match(state["params"], st_specs["params"], mesh)
              and placements_match(state["opt"].m, st_specs["opt"].m, mesh)
              and placements_match(state["opt"].v, st_specs["opt"].v, mesh))
    full = steps.full_tree({"params": state["params"],
                            "m": state["opt"].m, "v": state["opt"].v})
    out = {"metrics": metrics, "placed": placed}
    if rank == 0:
        out["state"] = _numpy(full)
    return out


def moe_job(rank, world_size, payload, device):
    """payload: arch, config overrides, mesh, ffn (numpy tree of one MoE
    layer's router/wi_gate/wi_up/wo), x (B, S, D); in dp_tp."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed import axisenv
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.models import api, moe

    cfg = _config(payload)
    mesh = _mesh(payload, device)
    mode = "dp_tp"
    ffn = _tensors(payload["ffn"], device)
    x = _tensors(payload["x"], device)
    axes = api.param_specs(cfg)["stack"]["uniform"]["ffn"]
    specs = {k: shd.spec_for(axes[k][1:], tuple(ffn[k].shape), mesh, mode)
             for k in ffn}
    ffn = steps.shard_tree(ffn, specs, mesh)
    bax = shd.batch_axes(mesh, x.shape[0], mode)
    x = steps.shard_tree(x, shd.P(bax or None, None, None), mesh)
    sizes = shd.axis_sizes(mesh)
    with axisenv.activation_axes(batch=bax,
                                 batch_sizes=[sizes[a] for a in bax],
                                 model="model", model_size=sizes["model"],
                                 mesh=mesh), implicit_replication():
        y, aux = moe.moe_ffn(ffn, x, cfg)
    y, aux = y.full_tensor(), aux.full_tensor()
    return {"y": _numpy(y), "aux": float(aux)} if rank == 0 else {}


def psum_job(rank, world_size, payload, device):
    """payload: mesh, method, grads (a list of two numpy trees, each with a
    leading world_size axis: rank r takes row r)."""
    from repro_torch.optim import compress

    mesh = _mesh(payload, device)
    group = mesh.get_group("model")
    errors, out = None, []
    for grads in payload["grads"]:
        mine = _tensors({k: v[rank] for k, v in grads.items()}, device)
        means, errors = compress.psum_compressed(mine, group,
                                                 payload["method"], errors)
        out.append({"means": _numpy(means),
                    "errors": None if errors is None else _numpy(errors)})
    return out


def serve_job(rank, world_size, payload, device):
    """payload: arch, config overrides, mesh, mode, params (numpy tree),
    batch (numpy: the prompt's model inputs), tokens (B, n) int32: the
    token fed at each of the n decode steps."""
    from repro_torch.launch import steps
    from repro_torch.models import convert

    cfg = _config(payload)
    mesh = _mesh(payload, device)
    sc = ShardingConfig(mode=payload["mode"])
    batch = _tensors(payload["batch"], device)
    feed = _tensors(payload["tokens"], device)
    lead = batch["embeds"] if "embeds" in batch else batch["tokens"]
    B, S = lead.shape[:2]
    n = feed.shape[1]
    pre_shape = ShapeConfig("prefill", "prefill", S, B)
    dec_shape = ShapeConfig("decode", "decode", S + n, B)
    params = convert.lm_params_from_numpy(payload["params"], cfg, device)
    params = steps.shard_tree(
        params, steps.state_shardings(cfg, mesh, sc)["params"], mesh)
    in_specs = steps.input_shardings(cfg, pre_shape, mesh, sc.mode)
    batch = steps.shard_tree(batch, in_specs["batch"], mesh)
    prefill, _ = steps.build_program(cfg, pre_shape, mesh, sc=sc)
    decode, _ = steps.build_program(cfg, dec_shape, mesh, sc=sc)
    tok_spec = steps.input_shardings(cfg, dec_shape, mesh, sc.mode)["tokens"]
    with torch.no_grad():
        logits, cache = prefill(params, batch)
        out = [whole(logits)]
        cache = steps.shard_cache(cache, cfg, dec_shape, mesh)
        for t in range(n):
            tok = steps.shard_tree(feed[:, t:t + 1].contiguous(), tok_spec,
                                   mesh)
            logits, cache = decode(params, cache, tok, S + t)
            out.append(whole(logits))
    specs = steps.input_shardings(cfg, dec_shape, mesh, sc.mode)["cache"]
    res = {"placed": placements_match(cache, specs, mesh)}
    full = steps.full_tree(cache)
    if rank == 0:
        res["logits"] = [o.cpu().numpy() for o in out]
        res["cache"] = _numpy(full)
    return res


JOBS = {"train": train_job, "moe": moe_job, "psum": psum_job,
        "serve": serve_job}


def batch_job(rank, world_size, payload, device):
    """payload: [(job name, its payload), ...]; returns their results."""
    return [JOBS[name](rank, world_size, p, device) for name, p in payload]
