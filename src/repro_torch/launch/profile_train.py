"""Where a train step spends its time: step wall times with the stacked
layer weights unbound once a pass (the model's way) and indexed layer by
layer, then ``torch.profiler`` around one step.

    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        --arch internlm2-1.8b --full --batch 8 --seq 2048 --microbatches 2

Under autograd, the backward of ``stack[i]`` writes a zero tensor the size
of the whole stack with layer i's gradient in it, for every layer; the
backward of one ``unbind`` stacks the layers' gradients once. Both give the
same values. The script runs ``--warmup`` steps, then ``--steps`` timed
steps in each mode in the order unbind, index, index, unbind (host clock
after a sync; the medians are printed), then profiles one step in the
model's mode: the unprofiled wall time, the device busy time (the sum of
the kernels' durations on the one stream), the idle share and the kernels
that took the most device time, and the device time by kernel kind (f32
and bf16 GEMMs, reductions, copies, elementwise). ``--trace DIR`` also
writes a Chrome trace. On the CPU (``--device cpu``) it reports operator
CPU self time.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.base import (ShardingConfig, TrainConfig, get_config,
                                      model_flops_per_token)
from repro_torch.data.tokens import make_batch
from repro_torch.launch import steps
from repro_torch.launch.profile_serve import _report
from repro_torch.models import transformer


# Kernel kinds by name, first match wins: the f32 GEMMs are the plain
# attention's einsums (TF32 off), the bf16 GEMMs the projections and MLPs.
KINDS = (("f32 GEMM", ("sgemm", "f32f32")),
         ("bf16 GEMM", ("nvjet", "bf16_gemm", "gemm_bf16")),
         ("reduction", ("reduce_kernel",)),
         ("copy", ("copy_kernel", "CatArrayBatched", "index")),
         ("elementwise", ("elementwise_kernel",)))


def kinds(prof) -> dict:
    """Device ms by kernel kind."""
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        kind = next((k for k, pats in KINDS
                     if any(p in e.key for p in pats)), "other")
        out[kind] = out.get(kind, 0.0) + e.self_device_time_total / 1e3
    return out


def _indexed(tree, i):
    return {k: _indexed(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def indexed_layers(tree) -> list:
    """``transformer._layers`` by indexing each layer of the stack."""
    first = tree
    while isinstance(first, dict):
        first = next(iter(first.values()))
    return [_indexed(tree, i) for i in range(first.shape[0])]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--num-layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)

    on_cuda = torch.device(args.device).type == "cuda"
    cfg = get_config(args.arch, reduced=not args.full)
    if args.num_layers:
        cfg = cfg.replace(num_layers=args.num_layers)
    state = steps.init_state(
        cfg, torch.Generator(device=args.device).manual_seed(args.seed),
        args.device)
    step_fn = steps.make_train_step(
        cfg, TrainConfig(warmup_steps=0),
        ShardingConfig(microbatches=args.microbatches))
    n = [0]

    def step():
        batch = make_batch(cfg, "train", args.batch, args.seq, step=n[0],
                           seed=args.seed)
        n[0] += 1
        t0 = time.perf_counter()
        _, m = step_fn(state, {k: torch.from_numpy(v).to(args.device)
                               for k, v in batch.items()})
        float(m["loss"])                          # waits for the step
        return time.perf_counter() - t0

    for _ in range(args.warmup):
        step()
    model_layers = transformer._layers
    walls = {"unbind": [], "index": []}
    for mode in ("unbind", "index", "index", "unbind"):
        transformer._layers = model_layers if mode == "unbind" else indexed_layers
        try:
            walls[mode] += [step() for _ in range(args.steps)]
        finally:
            transformer._layers = model_layers
    flops = model_flops_per_token(cfg, args.seq, True) * args.batch * args.seq
    for mode, w in walls.items():
        ms = float(np.median(w)) * 1e3
        print(f"{mode}: {ms:.1f} ms a step (median of {len(w)}; "
              f"{min(w) * 1e3:.1f}-{max(w) * 1e3:.1f}), "
              f"{flops / ms / 1e9:.1f} model TFLOP/s")
    if on_cuda:
        print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if on_cuda else [])
    wall = step()
    with profile(activities=activities) as prof:
        step()
    _report("train step", prof, wall, 1, args.top, on_cuda)
    if on_cuda:
        by_kind = kinds(prof)
        busy = sum(by_kind.values())
        print("by kind: " + ", ".join(
            f"{k} {ms:.1f} ms ({100 * ms / busy:.1f}%)"
            for k, ms in sorted(by_kind.items(), key=lambda kv: -kv[1])))
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace, "train_step.json"))


if __name__ == "__main__":
    main()
