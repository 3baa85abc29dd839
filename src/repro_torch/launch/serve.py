"""Serving driver: batched generation with the KV-cache engine, on the card
unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --batch 4 --prompt-len 64 --max-new 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b --full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b --full
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch llama4-scout-17b-a16e --full --num-layers 12
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b --full
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch seamless-m4t-medium --full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-72b \
        --full --num-layers 24

Weights are seeded random ones at the config's widths. Prefill attention
goes through ``ops.attention``, zamba2's Mamba2 scan through ``ops.ssd``,
RWKV6's WKV scan through ``ops.wkv6`` and the MoE archs' expert products
(prefill and decode) through ``ops.gmm``: the CUDA kernels on the card,
their plain versions on the CPU. A zamba2 or rwkv6 prompt longer than the
scan chunk (64 for rwkv6 and reduced zamba2, 128 for full zamba2) must be a
multiple of it. ``--num-layers`` cuts the depth and keeps every width:
llama4-scout's published 48 layers are about 199 GB in bf16, more than one
80 GB card holds, and 12 layers (50.3 GiB) fit; qwen2-vl-72b's 80 layers
are about 144 GB, and 24 (47 GB with the embeddings) fit. An enc-dec
model's encoder reads seeded random frames of the prompt's length (the
speech frontend is a stub, as in the JAX package).

The steady-state rate comes from the engine's layer spans
(``engine.prefill``, ``engine.decode``) of every round but the first, which
pays the kernel builds and the libraries' warm-up.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import observability as obs
from repro_torch.configs.base import get_config
from repro_torch.models import api
from repro_torch.serving.engine import Engine


def serving_config(arch: str, full: bool, num_layers=None):
    """The config served: published widths (``full``) or the reduced one,
    prefill attention and MoE expert products through the kernels, and the
    depth cut to ``num_layers`` if given."""
    cfg = get_config(arch, reduced=not full).replace(attn_impl="kernel")
    if cfg.is_moe:
        cfg = cfg.replace(moe_impl="gmm")
    if num_layers:
        cfg = cfg.replace(num_layers=num_layers)
    return cfg


def request_frames(cfg, rng, batch: int, length: int):
    """Seeded random encoder frames (B, length, D) for an enc-dec model, else
    None. Random, not the engine's default zeros: zero frames give zero
    cross K/V, and the cross-attention would compute nothing."""
    if not cfg.is_encdec:
        return None
    return rng.standard_normal((batch, length, cfg.d_model)).astype(np.float32)


def engine_tokens_per_s(since_ns: int) -> float:
    """Tokens/s of the engine's prefill and decode calls that started at
    or after ``since_ns`` (``time.perf_counter_ns()``): their rows over
    the summed length of their spans, each of which ends on the call's
    tokens on the host; 0 when there is none."""
    spans = [s for s in obs.layer_spans() if s.t0 >= since_ns
             and s.name in ("engine.prefill", "engine.decode")]
    ns = sum(s.t1 - s.t0 for s in spans)
    return sum(s.attrs["rows"] for s in spans) * 1e9 / ns if ns else 0.0


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
    ap.add_argument("--num-layers", type=int, default=None,
                    help="depth cut (widths unchanged), e.g. 12 for "
                    "llama4-scout or 24 for qwen2-vl-72b on one 80 GB card")
    args = ap.parse_args(argv)

    cfg = serving_config(args.arch, args.full, args.num_layers)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = api.init_params(cfg, gen, device=args.device)
    engine = Engine(cfg, params, max_new=args.max_new)

    rng = np.random.default_rng(args.seed)
    warm_ns = None
    for r in range(args.requests):
        prompts = rng.integers(0, cfg.vocab_size,
                               size=(args.batch, args.prompt_len),
                               dtype=np.int32)
        out = engine.generate(prompts, frames=request_frames(
            cfg, rng, args.batch, args.prompt_len))
        print(f"round {r}: in {prompts.shape} -> out {out.shape}, "
              f"sample tail: {out[0, -8:].tolist()}")
        if r == 0:
            warm_ns = time.perf_counter_ns()
    print(f"steady-state throughput: {engine_tokens_per_s(warm_ns):.1f} "
          f"tok/s (prefills={engine.stats['prefill_calls']}, "
          f"decode_steps={engine.stats['decode_steps']}, "
          f"round 0 excluded)")


if __name__ == "__main__":
    main()
