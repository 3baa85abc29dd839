"""Analytic per-device HBM traffic model: the port of
``repro/launch/analytic.py``, with the same formulas for the train, prefill
and decode terms.

It computes a *minimum-traffic* estimate from first principles, assuming a
fused kernel and bf16 activations:

- every fusion-boundary activation tensor is written once and read once,
- attention / SSD / WKV internals cost zero HBM traffic (kernel-fused),
- parameters are read once per forward (and once more for the remat
  re-forward), gradients and Adam moments read+written once,
- decode reads the whole KV-cache share + writes one slot.

The model is about the minimum traffic; the dry run's roofline
(``launch/dryrun.py``) uses it for its memory term. Trees are the port's
``(shape, dtype)`` trees and spec tuples (``distributed/sharding.P``); the
mesh is a ``MeshShape`` or a ``DeviceMesh``, read through
``sharding.axis_sizes``.
"""
from __future__ import annotations

import math

from repro_torch.configs.base import ModelConfig, ShapeConfig, ShardingConfig
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps
from repro_torch.models import api


def _pairs(tree, specs):
    """(leaf, spec) over two trees of nested dicts, in key order."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _pairs(tree[k], specs[k])
    else:
        yield tree, specs


def _bytes_per_device(abs_tree, specs, mesh):
    """Sum of leaf bytes divided by each leaf's shard count. A leaf is
    ``(shape, dtype)`` or a tensor."""
    sizes = shd.axis_sizes(mesh)
    total = 0.0
    for leaf, spec in _pairs(abs_tree, specs):
        shape, dtype = ((leaf.shape, leaf.dtype) if hasattr(leaf, "dtype")
                        else leaf)
        n = math.prod(shape) if len(shape) else 1
        shards = 1
        for axis in spec:
            if axis is None:
                continue
            for a in (axis if isinstance(axis, tuple) else (axis,)):
                shards *= sizes[a]
        total += n * dtype.itemsize / shards
    return total


def _act_elems_per_token(cfg: ModelConfig, tp: int) -> float:
    """Fusion-boundary activation elements per token per layer, already
    divided by the tensor-parallel degree where the tensor is TP-sharded."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    qo, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    qo_tp = qo / tp if cfg.num_heads % tp == 0 else qo
    kv_tp = kv / tp if cfg.num_kv_heads % tp == 0 else kv

    if cfg.rwkv:
        f = cfg.d_ff / tp if cfg.d_ff % tp == 0 else cfg.d_ff
        return 7 * d + f
    if cfg.family == "hybrid":
        d_inner = cfg.ssm_expand * d
        di_tp = d_inner / tp if d_inner % tp == 0 else d_inner
        return 5.1 * di_tp + 2 * d
    f = cfg.d_ff / tp if cfg.d_ff % tp == 0 else cfg.d_ff
    if cfg.is_moe:
        k = cfg.num_experts_per_token
        ffn = 3 * k * f * cfg.capacity_factor + 2 * k * d
    else:
        ffn = 3 * f
    return 6 * d + 2 * qo_tp + 2 * kv_tp + ffn


def _abstract_cache(cfg: ModelConfig, shape: ShapeConfig):
    return api.init_cache(cfg, shape.global_batch, shape.seq_len,
                          enc_len=shape.seq_len, device="meta")


def analytic_hbm_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh,
                       sc: ShardingConfig) -> dict:
    """Per-device HBM bytes for one step of this cell's program."""
    sizes = shd.axis_sizes(mesh)
    tp = 1 if sc.mode == "dp_only" else shd.mesh_axis_size(mesh, "model")
    bax = shd.batch_axes(mesh, shape.global_batch, sc.mode)
    dp = 1
    for a in bax:
        dp *= sizes[a]

    abs_params = api.abstract_params(cfg)
    p_specs = shd.tree_specs(api.param_specs(cfg), abs_params, mesh, sc.mode)
    params_dev = _bytes_per_device(abs_params, p_specs, mesh)

    act_bpt = _act_elems_per_token(cfg, tp) * 2.0          # bf16
    layers = cfg.num_layers + cfg.encoder_layers
    vocab_tp = cfg.vocab_size / tp if cfg.vocab_size % tp == 0 \
        else cfg.vocab_size

    out = {}
    if shape.kind == "train":
        tokens_dev = shape.global_batch * shape.seq_len / dp
        # params: fwd read + remat re-read; grads r+w; m,v r+w (f32); p write
        remat_f = 2.0 if cfg.remat != "none" else 1.0
        opt_div = sizes.get("data", 1) if sc.zero >= 1 else 1
        p_traffic = params_dev * (remat_f + 1 + 2)          # reads+gradsrw+pw
        o_traffic = _bytes_per_device(abs_params, p_specs, mesh) / 2 * 8 \
            * 2 / opt_div                                   # m+v f32 r+w
        act = tokens_dev * act_bpt * layers * 3.0           # fwd w+r, bwd, remat
        logits = tokens_dev * vocab_tp * 2 * 4.0            # fwd w+r, bwd w+r
        embed = tokens_dev * cfg.d_model * 2 * 4.0
        out["total"] = p_traffic + o_traffic + act + logits + embed
        out.update(params=p_traffic, opt=o_traffic, act=act, logits=logits)
    elif shape.kind == "prefill":
        tokens_dev = shape.global_batch * shape.seq_len / dp
        cache_dev = _bytes_per_device(
            _abstract_cache(cfg, shape),
            steps_cache_shardings(cfg, shape, mesh), mesh)
        act = tokens_dev * act_bpt * layers * 1.0           # fwd w+r only
        logits = shape.global_batch / dp * vocab_tp * 2 * 2
        out["total"] = params_dev + act + cache_dev + logits
        out.update(params=params_dev, act=act, cache=cache_dev)
    else:  # decode
        cache_dev = _bytes_per_device(
            _abstract_cache(cfg, shape),
            steps_cache_shardings(cfg, shape, mesh), mesh)
        logits = shape.global_batch / dp * vocab_tp * 2 * 2
        out["total"] = params_dev + cache_dev + logits
        out.update(params=params_dev, cache=cache_dev)
    return out


def steps_cache_shardings(cfg, shape, mesh):
    """The spec of every cache leaf of this cell (``cache_spec`` over
    ``steps.cache_axes``)."""
    return steps._map_axes(
        lambda ax, t: shd.cache_spec(ax, tuple(t.shape), mesh,
                                     shape.global_batch),
        steps.cache_axes(cfg), _abstract_cache(cfg, shape))
