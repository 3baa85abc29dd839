"""The train state and the train step on one device: the port of
``init_state`` and ``make_train_step`` of ``repro/launch/steps.py``.

    state = init_state(cfg, generator, device)   # {"params", "opt"}
    step = make_train_step(cfg, tc, sc)
    state, metrics = step(state, batch)

The step differentiates ``models.api.loss_fn`` with autograd. With
``sc.microbatches = k > 1`` the batch is split along its leading axis and
the gradients and metrics are summed over the microbatches in f32, each
divided by k (as the JAX step's ``acc_body`` does; without microbatches the
gradients keep the parameters' dtype, as in the JAX step). Then come the
non-finite guard, global-norm clipping, the schedule at the step before the
increment, and AdamW. The state is updated IN PLACE and returned, where the
JAX package's jitted step donates it. Metrics are 0-d f32 tensors on the
state's device: loss, ce, aux, tokens, grad_norm, lr, skipped.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ShardingConfig, TrainConfig
from repro_torch.models import api
from repro_torch.optim import adamw, clip, schedules
from repro_torch.utils.trees import tree_leaves, tree_map, tree_unflatten

METRICS = ("ce", "aux", "tokens", "loss")


def init_state(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
               device="cuda"):
    params = api.init_params(cfg, generator, device)
    return {"params": params, "opt": adamw.init(params)}


def _grads_of(params, cfg, batch):
    """(grads, metrics) of one (micro)batch: grads in the parameters'
    dtypes, metrics 0-d f32 tensors."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        live = [p.detach().requires_grad_(True) for p in leaves]
        loss, metrics = api.loss_fn(tree_unflatten(params, live), cfg, batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True,
                                    materialize_grads=True)
    metrics = {k: v.detach().float() for k, v in {**metrics, "loss": loss}.items()}
    return tree_unflatten(params, grads), metrics


def _split(batch, k):
    """The k microbatches of a batch, along its batch axis: the leading one,
    except for M-RoPE ``positions`` (3, B, S), which carries it on axis 1."""
    def resh(t, axis=0):
        b = t.shape[axis]
        assert b % k == 0, (b, k)
        t = t.reshape(tuple(t.shape[:axis]) + (k, b // k)
                      + tuple(t.shape[axis + 1:]))
        return t.movedim(axis, 0)

    split = {name: resh(t, 1 if name == "positions" else 0)
             for name, t in batch.items()}
    return [{name: t[i] for name, t in split.items()} for i in range(k)]


def make_train_step(cfg: ModelConfig, tc: TrainConfig,
                    sc: Optional[ShardingConfig] = None):
    sc = sc or ShardingConfig()

    def train_step(state, batch):
        params = state["params"]
        if sc.microbatches > 1:
            k = sc.microbatches
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            metrics = {name: torch.zeros((), dtype=torch.float32,
                                         device=tree_leaves(params)[0].device)
                       for name in METRICS}
            for mb in _split(batch, k):
                g, m = _grads_of(params, cfg, mb)
                for acc, gi in zip(tree_leaves(grads), tree_leaves(g)):
                    acc.add_(gi / k)
                for name in METRICS:
                    metrics[name] = metrics[name] + m[name] / k
                del g
        else:
            grads, metrics = _grads_of(params, cfg, batch)

        grads, nonfinite = clip.zero_nonfinite(grads)
        grads, gnorm = clip.clip_by_global_norm(grads, tc.grad_clip)
        opt = state["opt"]
        lr = schedules.warmup_cosine(
            opt.step, lr=tc.lr, warmup_steps=tc.warmup_steps,
            total_steps=tc.total_steps)
        adamw.update(grads, opt, params, lr, tc)
        metrics = {**metrics, "grad_norm": gnorm, "lr": lr,
                   "skipped": nonfinite.float()}
        return state, metrics

    return train_step
