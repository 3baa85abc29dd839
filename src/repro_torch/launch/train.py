"""Training entry point: any ported arch, checkpoint/restart, metrics. The
port of ``repro/launch/train.py``; it trains on the card unless ``--device
cpu`` is given.

Checkpoints are written every ``--ckpt-every`` steps on a background thread
(after a finished host copy of the state); ``--resume`` restores the newest
valid checkpoint and the deterministic step-keyed data stream realigns.
Every logged step reports the loss, ce, gradient norm and lr, the ms per
step and tokens/s since the last log, the model TFLOP/s by the copied
``model_flops_per_token`` and, on the card, the ``mfu`` (that over the H100
SXM's dense bf16 peak) and the peak device memory.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
        --steps 50 --batch 8 --seq 128 --device cpu --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
        --full --steps 20 --batch 8 --seq 2048 --microbatches 2

Weights are seeded random ones at the config's widths (``--full``: the
published ones; ``--num-layers`` cuts the depth and keeps every width).
Training runs the plain attention and the plain scans (``attn_impl="ref"``,
the configs' default): the hand-written kernels have no backward, in either
package.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import (ShardingConfig, TrainConfig, get_config,
                                      model_flops_per_token)
from repro_torch.data.loader import PrefetchLoader
from repro_torch.data.tokens import make_batch
from repro_torch.launch import steps
# H100 SXM datasheet bf16 dense peak (H100 80GB HBM3, 700 W)
from repro_torch.launch.hlo_analysis import PEAK_FLOPS


def train(arch: str, *, reduced: bool = True, steps_total: int = 50,
          batch: int = 8, seq: int = 128, lr: float = 3e-4,
          ckpt_dir: str = None, ckpt_every: int = 20, resume: bool = False,
          microbatches: int = 1, log_every: int = 10, seed: int = 0,
          stop_after: int = None, print_fn=print, device="cuda",
          num_layers: int = None, step_ms: list = None):
    """stop_after: interrupt the run after this step (fault-injection /
    resume tests) without changing the LR schedule, which is always derived
    from steps_total. step_ms, when given, receives every step's wall ms
    (the host clock after the step's loss reached the host)."""
    cfg = get_config(arch, reduced=reduced)
    if num_layers:
        cfg = cfg.replace(num_layers=num_layers)
    tc = TrainConfig(lr=lr, warmup_steps=max(steps_total // 20, 1),
                     total_steps=steps_total, seed=seed)
    sc = ShardingConfig(microbatches=microbatches)
    device = torch.device(device)

    state = steps.init_state(
        cfg, torch.Generator(device=device).manual_seed(seed), device)
    start_step = 0
    manager = None
    if ckpt_dir:
        manager = CheckpointManager(ckpt_dir)
        if resume:
            s, restored = manager.restore(state)
            if s is not None:
                state, start_step = restored, s
                print_fn(f"resumed from checkpoint step {s}")

    step_fn = steps.make_train_step(cfg, tc, sc)

    def batch_fn(step):
        return make_batch(cfg, "train", batch, seq, step=step, seed=seed)

    flops_per_step = model_flops_per_token(cfg, seq, training=True) * batch * seq
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    loader = PrefetchLoader(batch_fn, start_step=start_step)
    losses = []
    stop_at = min(steps_total, stop_after) if stop_after else steps_total
    t0 = t_log = time.perf_counter()
    n_log = 0
    try:
        for step, host_batch in loader:
            if step >= stop_at:
                break
            t_step = time.perf_counter()
            tbatch = {k: torch.from_numpy(v).to(device)
                      for k, v in host_batch.items()}
            state, metrics = step_fn(state, tbatch)
            loss = float(metrics["loss"])
            losses.append(loss)
            now = time.perf_counter()
            if step_ms is not None:
                step_ms.append((now - t_step) * 1e3)
            n_log += 1
            if step % log_every == 0 or step == steps_total - 1:
                ms = (now - t_log) / n_log * 1e3
                tflops = flops_per_step / ms / 1e9
                card = ""
                if on_card:
                    peak = torch.cuda.max_memory_allocated(device) / 2**30
                    card = (f" mfu {tflops * 1e12 / PEAK_FLOPS:.4f} "
                            f"peak {peak:.2f} GiB")
                print_fn(f"step {step:5d} loss {loss:8.4f} "
                         f"ce {float(metrics['ce']):8.4f} "
                         f"gnorm {float(metrics['grad_norm']):7.3f} "
                         f"lr {float(metrics['lr']):.2e} "
                         f"{ms:9.1f} ms/step "
                         f"{batch * seq / ms * 1e3:9.0f} tok/s "
                         f"{tflops:8.3f} model TFLOP/s{card} "
                         f"({now - t0:.1f}s)")
                t_log, n_log = now, 0
            if manager and ckpt_every and step and step % ckpt_every == 0:
                manager.save(step, state)
    finally:
        loader.close()
        if manager:
            manager.wait()
    if manager:
        manager.save(stop_at, state, blocking=True)
    return state, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--full", action="store_true",
                    help="full published config (default: reduced)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--num-layers", type=int, default=None,
                    help="depth cut (widths unchanged)")
    args = ap.parse_args(argv)
    _, losses = train(args.arch, reduced=not args.full,
                      steps_total=args.steps, batch=args.batch, seq=args.seq,
                      lr=args.lr, microbatches=args.microbatches,
                      ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                      resume=args.resume, seed=args.seed,
                      log_every=args.log_every, device=args.device,
                      num_layers=args.num_layers)
    first = np.mean(losses[:5])
    last = np.mean(losses[-5:])
    print(f"loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")


if __name__ == "__main__":
    main()
