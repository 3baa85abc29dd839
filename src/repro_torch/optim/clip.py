"""Global-norm gradient clipping + non-finite guard. The port of
``repro/optim/clip.py``; both work in place on the gradient tensors (the
train step owns them) and return them."""
from __future__ import annotations

import torch

from repro_torch.utils.trees import tree_global_norm, tree_leaves, whole


def clip_by_global_norm(grads, max_norm: float):
    """Returns (clipped_grads, pre_clip_norm). The norm and the scale are
    f32; each gradient is scaled in f32 and rounded to its own dtype."""
    norm = tree_global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in tree_leaves(grads):
        g.mul_(scale)
    return grads, norm


def zero_nonfinite(grads):
    """Zero *every* gradient when any leaf is non-finite (skip-step guard);
    returns (grads, any_nonfinite flag). No host sync: the flag stays on
    the device."""
    leaves = tree_leaves(grads)
    if not leaves:
        return grads, torch.tensor(False)
    # a count of the non-finite entries, not ``all()``: a sharded leaf's
    # count is a partial sum that ``whole`` reduces over the ranks
    ok = torch.stack([whole((~torch.isfinite(g)).sum())
                      for g in leaves]).sum() == 0
    for g in leaves:
        g.masked_fill_(~ok, 0)
    return grads, ~ok
