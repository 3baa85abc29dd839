"""Train a ~100M-parameter LM for a few hundred steps on the port, on the
CUDA device unless asked for the CPU: the port of
``examples/train_100m.py``.

The config is a scaled llama-family model (~129M params incl. embeddings),
the JAX example's. Demonstrates checkpoint/restart: interrupt and re-run
with --resume.

    PYTHONPATH=src python examples/train_100m_torch.py --steps 300
    PYTHONPATH=src python examples/train_100m_torch.py --steps 5 --seq 64 --device cpu
"""
import argparse
import sys
import types

import numpy as np

sys.path.insert(0, "src")

from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402

CONFIG_100M = ModelConfig(
    name="repro-100m",
    family="dense",
    num_layers=10,
    d_model=640,
    num_heads=10,
    num_kv_heads=5,
    d_ff=2560,
    vocab_size=50_000,
    head_dim=64,
    rope_theta=10_000.0,
    act="silu",
    remat="none",
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="build/repro_100m_ckpt")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    # register the config so launch.train can find it
    mod = types.ModuleType("repro_torch.configs.repro_100m")
    mod.CONFIG = CONFIG_100M
    mod.reduced = lambda: CONFIG_100M
    sys.modules["repro_torch.configs.repro_100m"] = mod
    if "repro-100m" not in base.PORTED:
        base.PORTED += ("repro-100m",)

    print(f"repro-100m: {base.param_count(CONFIG_100M)/1e6:.0f}M params")

    from repro_torch.launch.train import train
    _, losses = train("repro-100m", reduced=False, steps_total=args.steps,
                      batch=args.batch, seq=args.seq, lr=6e-4,
                      ckpt_dir=args.ckpt_dir, ckpt_every=50,
                      resume=args.resume, log_every=10, device=args.device)
    print(f"loss: {np.mean(losses[:5]):.4f} -> {np.mean(losses[-5:]):.4f}")


if __name__ == "__main__":
    main()
