"""Learning-rate schedules (pure functions of the step counter), computed in
f32 on the counter's device. The port of ``repro/optim/schedules.py``."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, lr, warmup_steps, total_steps, final_frac=0.1):
    step = torch.as_tensor(step).to(torch.float32)
    warm = lr * step / max(warmup_steps, 1)
    t = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = final_frac * lr + (1 - final_frac) * lr * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < warmup_steps, warm, cos)


def constant(step, *, lr, **_):
    return torch.full((), lr, dtype=torch.float32,
                      device=torch.as_tensor(step).device)
