"""The train state, the train step, the prefill and decode programs, and
their sharded forms: the port of ``repro/launch/steps.py``.

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

On a mesh (a torch ``DeviceMesh`` over the ranks of a process group)
``build_program(cfg, shape, mesh, tc=, sc=)`` gives the step every rank
runs, for the cell's kind:

- ``"train"``: ``step(state, batch)``; the params are DTensors placed by
  ``state_shardings`` (their ``tree_specs``, and the AdamW moments
  ``zero_spec`` under ZeRO-1), the batch is sharded by ``batch_axes``, and
  the same plain model and AdamW code runs on them;
- ``"prefill"``: ``prefill(params, batch, reserve=None)`` on the same
  params and batch placements; returns the last-position logits and a cache
  at the activations' placements (``axisenv.zeros``), with room for
  ``reserve`` positions;
- ``"decode"``: ``decode_step(params, cache, tokens, cur_len)`` on the
  cache placed leaf by leaf by ``cache_spec`` over ``cache_axes``, tokens
  by ``batch_axes`` and ``cur_len`` a Python int (replicated). The new K/V
  and states are written IN PLACE into each rank's shards of the DTensor
  cache, which comes back with the same placements (the JAX program donates
  it). ``shard_cache`` puts the cache prefill returns on these placements
  once, before the first step.

Each runs with the axis environment installed, so that the model's
``axisenv.constrain`` points pin activations as the JAX program's
``with_sharding_constraint`` does; DTensor's sharding propagation plays
GSPMD's part, and every gradient is brought to its parameter's placement.
``shard_tree`` and ``full_tree`` move trees between whole tensors and
DTensors.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ShardingConfig, TrainConfig
from repro_torch.distributed import axisenv
from repro_torch.distributed import sharding as shd
from repro_torch.models import api, layers
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
    # on a mesh: each gradient takes its parameter's placement (a replicated
    # parameter's partial sums over the data ranks are reduced here)
    grads = [g.redistribute(p.device_mesh, p.placements)
             if hasattr(g, "device_mesh") else g
             for g, p in zip(grads, leaves)]
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


# ---------------------------------------------------------------------------
# The sharded program
# ---------------------------------------------------------------------------


def _with_axisenv(fn, mesh, global_batch, mode="dp_tp"):
    """Wrap a step fn so that the model's sharding constraints resolve
    while it runs; plain tensors the step makes (positions, masks) count as
    replicated on the mesh."""
    from torch.distributed.tensor.experimental import implicit_replication

    sizes = shd.axis_sizes(mesh)
    bax = shd.batch_axes(mesh, global_batch, mode)
    # in dp_only mode no tensor axis lives on "model"
    model = "model" if "model" in sizes and mode != "dp_only" else None

    def wrapped(*args, **kw):
        with axisenv.activation_axes(batch=bax,
                                     batch_sizes=[sizes[a] for a in bax],
                                     model=model,
                                     model_size=sizes.get("model", 1),
                                     mesh=mesh, sharded=True), \
                implicit_replication():
            return fn(*args, **kw)
    return wrapped


_KV_AXES = {"k": ("layer", "batch", "seq", "kv_heads", "head_dim"),
            "v": ("layer", "batch", "seq", "kv_heads", "head_dim")}


def cache_axes(cfg: ModelConfig):
    """Logical axes of every cache leaf (mirrors ``api.init_cache``)."""
    if cfg.is_encdec:
        return {"self": dict(_KV_AXES), "cross": dict(_KV_AXES)}
    if cfg.rwkv:
        return {
            "tm_shift": ("layer", "batch", "seq", "embed"),
            "cm_shift": ("layer", "batch", "seq", "embed"),
            "state": ("layer", "batch", "heads", "head_dim", "head_dim2"),
        }
    if cfg.family == "hybrid":
        return {
            "mamba": {
                "conv": ("layer", "batch", "conv", "ssm_inner"),
                "ssm": ("layer", "batch", "ssm_heads", "head_dim", "state"),
            },
            "attn": dict(_KV_AXES),
        }
    return dict(_KV_AXES)


def batch_specs(cfg: ModelConfig, B: int, S: int, *, with_labels: bool):
    """(shape, dtype) of every model input of a full-sequence program."""
    cd = layers.dtype_of(cfg.compute_dtype)
    out = {}
    if cfg.family == "vlm":
        out["embeds"] = ((B, S, cfg.d_model), cd)
        out["positions"] = ((3, B, S), torch.int32)
    else:
        out["tokens"] = ((B, S), torch.int32)
    if cfg.is_encdec:
        out["frames"] = ((B, S, cfg.d_model), cd)
    if with_labels:
        out["labels"] = ((B, S), torch.int32)
    return out


def input_specs(cfg: ModelConfig, shape):
    """(shape, dtype) of every program input of this cell (nothing is
    allocated: a decode cache is laid out on the meta device)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"batch": batch_specs(cfg, B, S, with_labels=True)}
    if shape.kind == "prefill":
        return {"batch": batch_specs(cfg, B, S, with_labels=False)}
    if shape.kind == "decode":
        cache = tree_map(lambda t: (tuple(t.shape), t.dtype),
                         api.init_cache(cfg, B, S, enc_len=S, device="meta"))
        return {"cache": cache, "tokens": ((B, 1), torch.int32),
                "cur_len": ((), torch.int32)}
    raise ValueError(shape.kind)


def _batch_input_specs(specs, mesh, global_batch, mode="dp_tp"):
    bax = shd.batch_axes(mesh, global_batch, mode)
    lead = bax if bax else None

    def spec_of(name, s):
        if name == "positions":
            return shd.P(None, lead, None)
        return shd.P(lead, *([None] * (len(s[0]) - 1)))

    return {name: spec_of(name, s) for name, s in specs.items()}


def input_shardings(cfg: ModelConfig, shape, mesh, mode: str = "dp_tp"):
    """The spec of every program input (``sharding.placements`` turns one
    into DTensor placements)."""
    specs = input_specs(cfg, shape)
    if shape.kind in ("train", "prefill"):
        return {"batch": _batch_input_specs(specs["batch"], mesh,
                                            shape.global_batch, mode)}
    bax = shd.batch_axes(mesh, shape.global_batch, mode)
    lead = bax if bax else None
    return {
        "cache": _map_axes(lambda ax, s: shd.cache_spec(
            ax, s[0], mesh, shape.global_batch),
            cache_axes(cfg), specs["cache"]),
        "tokens": shd.P(lead, None),
        "cur_len": shd.P(),
    }


def _map_axes(fn, axes_tree, other):
    """fn over the leaves of two trees of nested dicts (a tuple is a
    leaf)."""
    if isinstance(axes_tree, dict):
        return {k: _map_axes(fn, axes_tree[k], other[k]) for k in axes_tree}
    return fn(axes_tree, other)


def abstract_state(cfg: ModelConfig):
    """(shape, dtype) of every leaf of the train state."""
    params = api.abstract_params(cfg)
    f32 = _map_axes(lambda s, _: (s[0], torch.float32), params, params)
    return {"params": params,
            "opt": adamw.AdamWState(step=((), torch.int32), m=f32, v=f32)}


def state_shardings(cfg: ModelConfig, mesh,
                    sc: Optional[ShardingConfig] = None):
    """The spec of every leaf of the train state: the params' resolved
    ``tree_specs``, and under ZeRO-1 (``sc.zero >= 1``) the AdamW moments
    sharded over "data" by ``zero_spec``."""
    sc = sc or ShardingConfig()
    abs_params = api.abstract_params(cfg)
    pspecs = shd.tree_specs(api.param_specs(cfg), abs_params, mesh, sc.mode)
    mspecs = _map_axes(
        lambda ps, ap: shd.zero_spec(ps, ap[0], mesh) if sc.zero >= 1 else ps,
        pspecs, abs_params)
    return {"params": pspecs,
            "opt": adamw.AdamWState(step=shd.P(), m=mspecs, v=mspecs)}


def shard_tree(tree, specs, mesh):
    """DTensors of whole tensors that every rank holds alike: each rank
    keeps a copy of its own shard of ``specs``' placements (no
    communication; the whole tensors are left as they were)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(tree, dict):
        return {k: shard_tree(tree[k], specs[k], mesh) for k in tree}
    if isinstance(tree, adamw.AdamWState):
        return adamw.AdamWState(*(shard_tree(t, s, mesh)
                                  for t, s in zip(tree, specs)))
    pl = shd.placements(specs, mesh)
    d = distribute_tensor(tree, mesh, pl, src_data_rank=None)
    return DTensor.from_local(d.to_local().clone(), mesh, pl, run_check=False,
                              shape=d.shape, stride=d.stride())


def full_tree(tree):
    """Whole tensors of a tree of DTensors (gathered on every rank)."""
    return tree_map(lambda t: t.full_tensor() if hasattr(t, "full_tensor")
                    else t, tree)


def make_prefill(cfg: ModelConfig):
    def prefill(params, batch, reserve=None):
        return api.prefill(params, cfg, batch, reserve=reserve)
    return prefill


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, cache, tokens, cur_len):
        return api.decode_step(params, cfg, cache, tokens, cur_len)
    return decode_step


def shard_cache(cache, cfg: ModelConfig, shape, mesh):
    """The cache ``prefill`` returned, on the decode placements of
    ``input_shardings(cfg, shape, mesh)["cache"]``, with room for
    ``shape.seq_len`` positions (``api.grow_cache``). Each leaf is
    redistributed once; the sequence axis is never sharded, so the growth
    is each rank's own."""
    from torch.distributed.tensor import DTensor

    specs = input_shardings(cfg, shape, mesh)["cache"]
    cache = api.grow_cache(cfg, cache, shape.seq_len)

    def place(t, spec):
        pl = shd.placements(spec, mesh)
        if not isinstance(t, DTensor):
            return shard_tree(t, spec, mesh)
        return t if tuple(t.placements) == pl else t.redistribute(mesh, pl)

    return _map_axes(lambda spec, t: place(t, spec), specs, cache)


def build_program(cfg: ModelConfig, shape, mesh, *,
                  tc: Optional[TrainConfig] = None,
                  sc: Optional[ShardingConfig] = None):
    """Returns (step, example args as (shape, dtype) trees) for the cell's
    kind (see the module docstring): the train step on
    ``shard_tree(state, state_shardings(...))`` and
    ``shard_tree(batch, input_shardings(...)["batch"])``; prefill on the
    params and batch placed alike; decode on those params and the cache of
    ``shard_cache``."""
    tc = tc or TrainConfig()
    sc = sc or ShardingConfig()
    specs = input_specs(cfg, shape)
    if shape.kind == "train":
        fn = _with_axisenv(make_train_step(cfg, tc, sc), mesh,
                           shape.global_batch, sc.mode)
        return fn, (abstract_state(cfg), specs["batch"])
    if shape.kind == "prefill":
        fn = _with_axisenv(make_prefill(cfg), mesh, shape.global_batch,
                           sc.mode)
        return fn, (api.abstract_params(cfg), specs["batch"])
    if shape.kind == "decode":
        fn = _with_axisenv(make_decode_step(cfg), mesh, shape.global_batch,
                           sc.mode)
        return fn, (api.abstract_params(cfg), specs["cache"],
                    specs["tokens"], specs["cur_len"])
    raise ValueError(shape.kind)
