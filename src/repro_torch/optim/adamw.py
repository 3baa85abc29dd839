"""AdamW with f32 moments over nested dicts of tensors: the port of
``repro/optim/adamw.py``, not ``torch.optim.AdamW`` (which keeps its
moments in the parameter's dtype and decays every parameter it is given).

Moments are f32 whatever the parameter dtype; weight decay is decoupled and
applies to parameters with ``ndim >= 2`` only; the update is computed in f32
and rounded to the parameter's dtype. Parameters and moments are updated IN
PLACE, where the JAX package's jitted step donates its state.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.utils.trees import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32
    m: dict                  # f32 tree like params
    v: dict                  # f32 tree like params


def init(params) -> AdamWState:
    zeros = lambda t: tree_map(                       # noqa: E731
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), t)
    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=zeros(params), v=zeros(params))


@torch.no_grad()
def update(grads, state: AdamWState, params, lr, tc: TrainConfig):
    """Returns (params, state), both updated in place. lr is a scalar
    (already scheduled)."""
    step = state.step + 1
    b1, b2 = tc.b1, tc.b2
    c1 = 1.0 - torch.pow(b1, step.float())
    c2 = 1.0 - torch.pow(b2, step.float())
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.m),
                          tree_leaves(state.v), tree_leaves(params)):
        g = g.float()
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g.square())
        delta = (m / c1) / ((v / c2).sqrt() + tc.eps)
        if p.dim() >= 2 and tc.weight_decay:
            delta = delta + tc.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    state.step.copy_(step)
    return params, state
