"""Serving driver: batched generation with the KV-cache engine, on the card
unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --batch 4 --prompt-len 64 --max-new 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b --full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b --full

Weights are seeded random ones at the config's widths. Prefill attention
goes through ``ops.attention``, zamba2's Mamba2 scan through ``ops.ssd`` and
RWKV6's WKV scan through ``ops.wkv6``: the CUDA kernels on the card, their
plain versions on the CPU. A zamba2 or rwkv6 prompt longer than the scan
chunk (64 for rwkv6 and reduced zamba2, 128 for full zamba2) must be a
multiple of it.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.models import api
from repro_torch.serving.engine import Engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--requests", type=int, default=3,
                    help="number of batched request rounds")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=not args.full).replace(
        attn_impl="kernel")
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = api.init_params(cfg, gen, device=args.device)
    engine = Engine(cfg, params, max_new=args.max_new)

    rng = np.random.default_rng(args.seed)
    for r in range(args.requests):
        prompts = rng.integers(0, cfg.vocab_size,
                               size=(args.batch, args.prompt_len),
                               dtype=np.int32)
        out = engine.generate(prompts)
        print(f"round {r}: in {prompts.shape} -> out {out.shape}, "
              f"sample tail: {out[0, -8:].tolist()}")
    print(f"steady-state throughput: {engine.throughput():.1f} tok/s "
          f"(prefills={engine.stats['prefill_calls']}, "
          f"decode_steps={engine.stats['decode_steps']}, "
          f"compile {engine.stats['compile_wall']:.2f}s excluded)")


if __name__ == "__main__":
    main()
