"""Where one warm serving request spends its time: ``torch.profiler`` around
the prefill and around the decode steps of the ``Engine``.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch internlm2-1.8b --full --batch 8 --prompt-len 2048 --max-new 32

(also ``--arch zamba2-1.2b``, ``--arch rwkv6-3b``, ``--arch gemma2-2b``,
``--arch seamless-m4t-medium`` (random encoder frames of the prompt's
length), or ``--arch llama4-scout-17b-a16e --num-layers 12`` and ``--arch
qwen2-vl-72b --num-layers 24``, the depths one card holds).

One request of the same shape runs first, unprofiled, to warm up; a second
one runs unprofiled to take the host wall time of the prefill and of the
decode steps; a third runs under the profiler. For each window the script
prints the unprofiled wall time, the device busy time (the sum of the
kernels' durations; they run on one stream), the idle share (one minus
busy over wall) and the kernels that took the most device time. On the CPU
(``--device cpu``) it reports the operators' CPU self time instead.
``--trace DIR`` also writes a Chrome trace of each profiled window.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.launch.serve import request_frames, serving_config
from repro_torch.models import api
from repro_torch.serving.engine import Engine


def _report(name, prof, wall_s, steps, top, on_cuda):
    # on the card, kernel rows only: an operator's self device time repeats
    # the time of the kernels it launched
    attr = "self_device_time_total" if on_cuda else "self_cpu_time_total"
    kind = DeviceType.CUDA if on_cuda else DeviceType.CPU
    rows = sorted((e for e in prof.key_averages() if e.device_type == kind),
                  key=lambda e: getattr(e, attr), reverse=True)
    busy_ms = sum(getattr(e, attr) for e in rows) / 1e3
    wall_ms = wall_s * 1e3
    idle = (f", device idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}"
            if on_cuda else "")
    print(f"{name}: wall {wall_ms:.2f} ms over {steps} call(s), "
          f"{'device' if on_cuda else 'CPU'} busy {busy_ms:.2f} ms{idle}")
    for e in rows[:top]:
        t = getattr(e, attr) / 1e3
        print(f"  {t:10.3f} ms {100 * t / max(busy_ms, 1e-9):5.1f}% "
              f"{e.count:6d}x  {e.key[:90]}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--trace", default=None,
                    help="directory for Chrome traces of the two windows")
    ap.add_argument("--num-layers", type=int, default=None,
                    help="depth cut (widths unchanged), e.g. 12 for "
                    "llama4-scout or 24 for qwen2-vl-72b on one 80 GB card")
    args = ap.parse_args(argv)

    on_cuda = torch.device(args.device).type == "cuda"
    cfg = serving_config(args.arch, args.full, args.num_layers)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    engine = Engine(cfg, api.init_params(cfg, gen, device=args.device),
                    max_new=args.max_new)
    rng = np.random.default_rng(args.seed)

    def prompts():
        return rng.integers(0, cfg.vocab_size,
                            size=(args.batch, args.prompt_len), dtype=np.int32)

    def frames():
        return request_frames(cfg, rng, args.batch, args.prompt_len)

    def request():
        """Host wall time of the prefill and of the decode steps; the
        engine's calls return host arrays, so the device is done. The
        inputs are drawn before the clock starts."""
        tokens, enc = prompts(), frames()
        t0 = time.perf_counter()
        _, state = engine.prefill_batch(
            tokens, reserve=args.prompt_len + args.max_new, frames=enc)
        t1 = time.perf_counter()
        for _ in range(args.max_new - 1):
            engine.decode_batch(state)
        return t1 - t0, time.perf_counter() - t1

    # warm-up: builds, allocator, handles
    engine.generate(prompts(), frames=frames())
    walls = request()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if on_cuda else [])
    tokens, enc = prompts(), frames()
    with profile(activities=activities) as prof_prefill:
        _, state = engine.prefill_batch(
            tokens, reserve=args.prompt_len + args.max_new, frames=enc)
    with profile(activities=activities) as prof_decode:
        for _ in range(args.max_new - 1):
            engine.decode_batch(state)
    for name, prof, wall, calls in (
            ("prefill", prof_prefill, walls[0], 1),
            ("decode", prof_decode, walls[1], args.max_new - 1)):
        _report(name, prof, wall, calls, args.top, on_cuda)
        if args.trace:
            os.makedirs(args.trace, exist_ok=True)
            prof.export_chrome_trace(os.path.join(args.trace, f"{name}.json"))


if __name__ == "__main__":
    main()
