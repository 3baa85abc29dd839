"""Multi-pod dry run: every (arch x input-shape x mesh) cell's sharded
program, run once at production mesh size with no devices behind it. The
port of ``repro/launch/dryrun.py``.

For each cell this:
  1. brings up a fake world of ``mesh_chips`` ranks (256 single pod, 512
     multi-pod) over torch's fake process group, and builds the production
     ``DeviceMesh`` on it ((16, 16) or (2, 16, 16));
  2. builds the params, optimizer state, batch and cache as meta-device
     DTensors at their placements (``launch/steps.py``): nothing is
     allocated;
  3. runs ``steps.build_program``'s step once under a ``CollectiveRecorder``
     and a per-device ``DeviceFlopCounter`` (``launch/hlo_analysis.py``);
     the kernels' wrappers take their meta implementations, which add the
     kernels' operation counts (``kernels/dispatch.py``);
  4. records params, per-device FLOPs, collective traffic, the analytic HBM
     model (``launch/analytic.py``), roofline terms and the per-device
     argument bytes to JSON.

Prefill cells run with ``attn_impl="kernel"`` (the flash kernel's meta
implementation in place of thousands of chunked plain-attention ops a
layer); train cells with ``attn_impl="ref"``, whose backward autograd runs
and counts. Decode attention is plain in both. The port runs every layer
eagerly, so the count is of the full depth; ``probe_configs`` (needed by
the JAX dry run because XLA counts a scanned body once) serves only to
check, under ``probes=True``, that the full-depth count equals the
extrapolation from two shallow configs. The record's
``hlo_bytes_per_dev`` is null: XLA's "bytes accessed" has no counterpart
here. No peak memory is given for a meta run.

Usage (no card; each cell runs in this process, one fake world at a time):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b \\
      --shape train_4k --mesh single --out benchmarks/results/dryrun_torch
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs.base import (ARCH_IDS, SHAPES, ShardingConfig,
                                      TrainConfig, active_param_count,
                                      get_config, param_count,
                                      shape_applicable)
from repro_torch.distributed import sharding as shd
from repro_torch.launch import analytic, hlo_analysis, steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.optim import adamw

DEFAULT_OUT = "benchmarks/results/dryrun_torch"


def probe_configs(cfg):
    """Two shallow configs for cost extrapolation (the JAX dry run's):
        cost(full) = cost(p1) + (steps_full - 1) * (cost(p2) - cost(p1)).
    """
    if cfg.is_encdec:
        assert cfg.encoder_layers == cfg.num_layers
        c1 = cfg.replace(num_layers=1, encoder_layers=1, scan_unroll=True)
        c2 = cfg.replace(num_layers=2, encoder_layers=2, scan_unroll=True)
        return c1, c2, cfg.num_layers
    if cfg.family == "hybrid":
        ae = max(cfg.attn_every, 1)
        groups, tail = divmod(cfg.num_layers, ae)
        c1 = cfg.replace(num_layers=ae + tail, scan_unroll=True)
        c2 = cfg.replace(num_layers=2 * ae + tail, scan_unroll=True)
        return c1, c2, groups
    per = cfg.local_global_period or 1
    c1 = cfg.replace(num_layers=per, scan_unroll=True)
    c2 = cfg.replace(num_layers=2 * per, scan_unroll=True)
    return c1, c2, cfg.num_layers // per


def default_sharding(cfg, shape_name: str) -> ShardingConfig:
    """Per-cell default distribution config (the paper-faithful baseline
    uses plain DP+TP; big-model cells need FSDP to be honest about fit)."""
    if cfg.name.startswith("kimi") or cfg.name.startswith("qwen2-vl"):
        return ShardingConfig(mode="fsdp_tp", zero=1)
    return ShardingConfig(mode="dp_tp", zero=1)


class fake_world:
    """A fake process group of ``chips`` ranks (this process is rank 0) and
    the production ``DeviceMesh`` on it; destroyed on exit."""

    def __init__(self, mesh_shape):
        self.mesh_shape = mesh_shape

    def __enter__(self):
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh
        from torch.testing._internal.distributed.fake_pg import FakeStore

        sizes = self.mesh_shape.sizes
        n = 1
        for s in sizes:
            n *= s
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
        # a "cuda" mesh, so that DTensor picks the collectives it would on
        # the cards (on a "cpu" mesh it swaps all-to-all for all-gather);
        # the fake backend sets up no device
        return DeviceMesh("cuda", torch.arange(n).reshape(sizes),
                          mesh_dim_names=self.mesh_shape.axis_names)

    def __exit__(self, *exc):
        import torch.distributed as dist
        dist.destroy_process_group()
        return False


def _meta(tree, specs, mesh):
    """Meta-device DTensors of a (shape, dtype) tree at ``specs``'
    placements: each leaf holds rank 0's shard, allocating nothing."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    if isinstance(tree, dict):
        return {k: _meta(tree[k], specs[k], mesh) for k in tree}
    shape, dtype = tree
    pl = shd.placements(specs, mesh)
    local, _ = compute_local_shape_and_global_offset(shape, mesh, pl)
    t = torch.empty(local, dtype=dtype, device="meta")
    return DTensor.from_local(t, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def _program_args(cfg, shape, mesh, sc):
    """The step and its meta DTensor arguments; with the (shape, dtype)
    trees and specs of the arguments, for their per-device bytes."""
    step, args = steps.build_program(cfg, shape, mesh, tc=TrainConfig(),
                                     sc=sc)
    st = steps.state_shardings(cfg, mesh, sc)
    ins = steps.input_shardings(cfg, shape, mesh, sc.mode)
    if shape.kind == "train":
        state, batch = args
        specs = ({"params": st["params"], "m": st["opt"].m,
                  "v": st["opt"].v}, ins["batch"])
        trees = ({"params": state["params"], "m": state["opt"].m,
                  "v": state["opt"].v}, batch)
        meta = _meta(trees[0], specs[0], mesh)
        step_arg = _meta(((), torch.int32), shd.P(), mesh)
        call_args = ({"params": meta["params"],
                      "opt": adamw.AdamWState(step=step_arg, m=meta["m"],
                                              v=meta["v"])},
                     _meta(batch, ins["batch"], mesh))
        return step, call_args, trees, specs
    if shape.kind == "prefill":
        params, batch = args
        trees, specs = (params, batch), (st["params"], ins["batch"])
        return step, (_meta(params, st["params"], mesh),
                      _meta(batch, ins["batch"], mesh)), trees, specs
    params, cache, tokens, _ = args
    trees = (params, cache, tokens)
    specs = (st["params"], ins["cache"], ins["tokens"])
    # decode at the last slot: attention over the whole cache
    return step, (_meta(params, st["params"], mesh),
                  _meta(cache, ins["cache"], mesh),
                  _meta(tokens, ins["tokens"], mesh),
                  shape.seq_len - 1), trees, specs


def _run_program(cfg, shape, mesh, sc):
    """(per-device FLOPs, collective records, argument bytes per device,
    seconds) of one run of the cell's step."""
    step, args, trees, specs = _program_args(cfg, shape, mesh, sc)
    arg_bytes = sum(analytic._bytes_per_device(t, s, mesh)
                    for t, s in zip(trees, specs))
    rec = hlo_analysis.CollectiveRecorder()
    flops = hlo_analysis.DeviceFlopCounter()
    t0 = time.time()
    grad = torch.enable_grad() if shape.kind == "train" else torch.no_grad()
    with grad, rec, flops:
        step(*args)
    return flops.flops, rec.records, arg_bytes, time.time() - t0


def _cell_config(cfg, shape):
    impl = "kernel" if shape.kind == "prefill" else "ref"
    return cfg.replace(attn_impl=impl)


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             sc: ShardingConfig = None, probes: bool = False,
             cfg_overrides=None, reduced: bool = False):
    """Run one cell's sharded program on a fake world; returns the result
    record (raises on failure). ``reduced`` takes the arch's reduced config
    (tests).

    cfg_overrides: dict of ModelConfig fields for perf iterations
    (e.g. {"seq_parallel": True, "remat": "policy"})."""
    cfg = get_config(arch, reduced=reduced)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    shape = SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skip", "reason": reason}

    mesh_shape = make_production_mesh(multi_pod=multi_pod)
    chips = 1
    for s in mesh_shape.sizes:
        chips *= s
    sc = sc or default_sharding(cfg, shape_name)
    run_cfg = _cell_config(cfg, shape)
    with fake_world(mesh_shape) as mesh:
        flops_dev, records, arg_bytes, t_run = _run_program(
            run_cfg, shape, mesh, sc)
        probe_detail = None
        if probes:
            c1, c2, steps_full = probe_configs(run_cfg)
            f1, r1, _, _ = _run_program(c1, shape, mesh, sc)
            f2, r2, _, _ = _run_program(c2, shape, mesh, sc)
            lin = f1 + (steps_full - 1) * max(f2 - f1, 0.0)
            probe_detail = {
                "flops_probe1": f1, "flops_probe2": f2,
                "steps_full": steps_full, "flops_lin": lin,
                "lin_equals_full": abs(lin - flops_dev)
                <= 1e-9 * max(flops_dev, 1.0),
                "probe1": hlo_analysis.collective_stats(r1, chips).as_dict(),
                "probe2": hlo_analysis.collective_stats(r2, chips).as_dict()}

    coll = hlo_analysis.collective_stats(records, chips)
    wire_dev = coll.total_wire_bytes
    mem_model = analytic.analytic_hbm_bytes(cfg, shape, mesh_shape, sc)
    # no HLO bytes: the memory term is the analytic model's
    roof = hlo_analysis.roofline_terms(
        flops=flops_dev * chips, hbm_bytes=mem_model["total"] * chips,
        wire_bytes=wire_dev, chips=chips)
    mem_term = mem_model["total"] / hlo_analysis.HBM_BW
    roof["memory_analytic_s"] = mem_term
    terms = {"compute": roof["compute_s"], "memory": mem_term,
             "collective": roof["collective_s"]}
    roof["dominant_analytic"] = max(terms, key=terms.get)
    roof["step_lower_bound_analytic_s"] = max(terms.values())

    n_total = param_count(cfg)
    n_active = active_param_count(cfg)
    tokens = (shape.global_batch * shape.seq_len
              if shape.kind in ("train", "prefill")
              else shape.global_batch)          # decode: 1 new token/seq
    mult = 6.0 if shape.kind == "train" else 2.0
    model_flops = mult * n_active * tokens
    useful = model_flops / max(flops_dev * chips, 1.0)

    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "ok", "chips": chips, "reduced": reduced,
        "mesh_shape": dict(zip(mesh_shape.axis_names, mesh_shape.sizes)),
        "sharding": {"mode": sc.mode, "zero": sc.zero,
                     "microbatches": sc.microbatches,
                     "remat": sc.remat_override or cfg.remat},
        "attn_impl": run_cfg.attn_impl,
        "cfg_overrides": cfg_overrides or {},
        "params_total": n_total, "params_active": n_active,
        "tokens_per_step": tokens,
        "model_flops": model_flops,
        "hlo_flops_per_dev": flops_dev,
        "hlo_bytes_per_dev": None,
        "hlo_bytes_note": "no counterpart of XLA's bytes accessed: the "
                          "memory term is the analytic model's",
        "useful_flop_frac": useful,
        "collectives": coll.as_dict(),
        "collective_wire_bytes_per_dev": wire_dev,
        "collective_probe_detail": probe_detail,
        "analytic_hbm_bytes_per_dev": mem_model,
        "roofline": roof,
        "memory_analysis": {"argument_size_in_bytes": int(arg_bytes)},
        "t_run_s": t_run,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="ModelConfig override key=value (perf iterations)")
    ap.add_argument("--mode", default=None,
                    help="ShardingConfig mode override (dp_tp|fsdp_tp|dp_only)")
    ap.add_argument("--tag", default="",
                    help="suffix for output json files")
    ap.add_argument("--probes", action="store_true",
                    help="check the full-depth count against two shallow "
                         "probes (single-pod mesh only)")
    ap.add_argument("--reduced", action="store_true",
                    help="the archs' reduced configs")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        key, val = kv.split("=", 1)
        if val.lower() in ("true", "false"):
            val = val.lower() == "true"
        elif val.lstrip("-").isdigit():
            val = int(val)
        overrides[key] = val

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)

    n_ok = n_skip = n_fail = 0
    for arch in archs:
        for shape_name in shapes:
            for multi in meshes:
                tag = f"{arch}_{shape_name}_{'multi' if multi else 'single'}"
                if args.tag:
                    tag += "_" + args.tag
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[cached] {tag}")
                    continue
                try:
                    sc = None
                    if args.mode:
                        sc = dataclasses.replace(
                            default_sharding(get_config(arch), shape_name),
                            mode=args.mode)
                    rec = run_cell(arch, shape_name, multi, sc=sc,
                                   probes=args.probes and not multi,
                                   cfg_overrides=overrides or None,
                                   reduced=args.reduced)
                except Exception as e:
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": "multi" if multi else "single",
                           "status": "fail", "error": repr(e),
                           "traceback": traceback.format_exc()}
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                st = rec["status"]
                n_ok += st == "ok"
                n_skip += st == "skip"
                n_fail += st == "fail"
                if st == "ok":
                    r = rec["roofline"]
                    print(f"[ok]   {tag}: dom={r['dominant_analytic']} "
                          f"comp={r['compute_s']:.4f}s "
                          f"mem={r['memory_analytic_s']:.4f}s "
                          f"coll={r['collective_s']:.4f}s "
                          f"useful={rec['useful_flop_frac']:.2f} "
                          f"(run {rec['t_run_s']:.0f}s)", flush=True)
                elif st == "skip":
                    print(f"[skip] {tag}: {rec['reason']}", flush=True)
                else:
                    print(f"[FAIL] {tag}: {rec['error']}", flush=True)
    print(f"\ndry-run summary: ok={n_ok} skip={n_skip} fail={n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
