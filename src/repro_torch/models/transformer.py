"""Decoder-only transformer stacks: the port of the uniform dense stack, the
gemma2 local/global stack, the zamba2 hybrid stack and the RWKV6 stack of
``repro/models/transformer.py``, and the dense block that the enc-dec stacks
of ``models/encdec.py`` share.

The JAX package scans stacked (L, ...) parameters with ``lax.scan``; the port
keeps the same stacked layout and loops over layers in Python. The same
blocks serve the full-sequence forward (no cache), prefill (collect the
cache) and decode (write the cache at ``cur_len`` and attend over it, or
carry the recurrent states). Each pass unbinds the stacked parameters once:
under autograd, indexing layer i of a stack would make its backward write a
zero tensor the size of the whole stack for every layer.

With grad on, the full-sequence forward rematerialises the bodies the JAX
package wraps in ``_ckpt``: each dense/MoE block, each RWKV block, each
zamba2 group (and each Mamba2 block inside it and in the tail).
``cfg.remat`` picks how: "block" recomputes the whole body in the backward
pass, "policy" saves the matmul outputs and recomputes the rest (the
counterpart of ``dots_with_no_batch_dims_saveable``), "none" saves
everything.

The uniform stack takes the MoE FFN for the moe family, and every pass sums
the layers' load-balance losses. gemma2's stack runs periods of
``local_global_period`` layers, stacked (L/per, per, ...): every layer of a
period but the last attends within ``sliding_window``, the last globally;
its blocks add the post-norms (``post_norm``). Its KV cache stays stacked
over the L layers, layer g*per + i at index g*per + i.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import axisenv
from repro_torch.models import attention as attn
from repro_torch.models import mamba2, rwkv6
from repro_torch.models.layers import rmsnorm, rmsnorm_params, rope_cos_sin
from repro_torch.models.mlp import mlp, mlp_params
from repro_torch.models.moe import moe_ffn, moe_params


def dense_block_params(mk, cfg: ModelConfig, stacked=(), moe: bool = False,
                       cross: bool = False):
    p = {
        "ln1": rmsnorm_params(mk, cfg.d_model, stacked),
        "attn": attn.attention_params(mk, cfg, stacked),
        "ln2": rmsnorm_params(mk, cfg.d_model, stacked),
        "ffn": (moe_params(mk, cfg, stacked) if moe
                else mlp_params(mk, cfg, stacked)),
    }
    if cross:
        p["ln_cross"] = rmsnorm_params(mk, cfg.d_model, stacked)
        p["cross"] = attn.attention_params(mk, cfg, stacked, cross=True)
    if cfg.post_norm:
        p["ln1_post"] = rmsnorm_params(mk, cfg.d_model, stacked)
        p["ln2_post"] = rmsnorm_params(mk, cfg.d_model, stacked)
    return p


def rwkv_block_params(mk, cfg: ModelConfig, stacked=()):
    return {
        "ln1": rmsnorm_params(mk, cfg.d_model, stacked),
        "tmix": rwkv6.rwkv_time_mix_params(mk, cfg, stacked),
        "ln2": rmsnorm_params(mk, cfg.d_model, stacked),
        "cmix": rwkv6.rwkv_channel_mix_params(mk, cfg, stacked),
    }


def mamba_block_params(mk, cfg: ModelConfig, stacked=()):
    return {
        "ln": rmsnorm_params(mk, cfg.d_model, stacked),
        "mamba": mamba2.mamba_params(mk, cfg, stacked),
    }


def stack_params(mk, cfg: ModelConfig):
    if cfg.rwkv:
        return {"rwkv": rwkv_block_params(mk, cfg, stacked=(cfg.num_layers,))}
    if cfg.family == "hybrid":
        ae = max(cfg.attn_every, 1)
        groups, tail = divmod(cfg.num_layers, ae)
        p = {"mamba_main": mamba_block_params(mk, cfg, stacked=(groups, ae)),
             "shared_attn": dense_block_params(mk, cfg)}
        if tail:
            p["mamba_tail"] = mamba_block_params(mk, cfg, stacked=(tail,))
        return p
    if cfg.local_global_period:
        per = cfg.local_global_period
        assert cfg.num_layers % per == 0, (cfg.num_layers, per)
        return {"lg": dense_block_params(
            mk, cfg, stacked=(cfg.num_layers // per, per), moe=cfg.is_moe)}
    return {"uniform": dense_block_params(mk, cfg, stacked=(cfg.num_layers,),
                                          moe=cfg.is_moe)}


def _maybe_post(p, name, y, cfg):
    return rmsnorm(p[name], y, cfg.norm_eps) if cfg.post_norm else y


def _residual(h, cfg):
    """Between-block residual-stream sharding: batch over the data axes,
    and with ``seq_parallel`` the tokens over the model axis."""
    if cfg.seq_parallel:
        return axisenv.constrain(h, "batch", "seq", None)
    return axisenv.constrain(h, "batch", None, None)


def apply_dense_block(p, h, cfg: ModelConfig, *, cos, sin, window=None,
                      causal=True, cache=None, cur_len=None, enc_kv=None,
                      collect_cache=False):
    """Returns (h, cache, aux): the layer's fresh {k, v} when collecting,
    the updated layer cache when decoding, else None; aux is the MoE
    load-balance loss (None for a dense FFN). ``enc_kv``: this layer's
    cross K/V, for an enc-dec decoder block."""
    a_in = rmsnorm(p["ln1"], h, cfg.norm_eps)
    if collect_cache:
        q, k, v = attn.project_qkv(p["attn"], a_in, cfg, cos, sin)
        o = attn.attend(q, k, v, cfg=cfg, causal=causal, window=window)
        a_out = attn.output_proj(p["attn"], o, cfg)
        new_cache = {"k": k, "v": v}
    else:
        a_out, new_cache = attn.self_attention(
            p["attn"], a_in, cfg, cos=cos, sin=sin, causal=causal,
            window=window, cache=cache, cur_len=cur_len)
    h = _residual(h + _maybe_post(p, "ln1_post", a_out, cfg), cfg)
    if enc_kv is not None:
        c_in = rmsnorm(p["ln_cross"], h, cfg.norm_eps)
        h = _residual(h + attn.cross_attention(p["cross"], c_in, enc_kv, cfg),
                      cfg)
    m_in = rmsnorm(p["ln2"], h, cfg.norm_eps)
    aux = None
    if "router" in p["ffn"]:
        m_out, aux = moe_ffn(p["ffn"], m_in, cfg)
    else:
        m_out = mlp(p["ffn"], m_in, cfg)
    return (_residual(h + _maybe_post(p, "ln2_post", m_out, cfg), cfg),
            new_cache, aux)


def apply_rwkv_block(p, h, cfg: ModelConfig, cache=None):
    """cache: None or {"tm_shift", "state", "cm_shift"} of this layer;
    returns (h, the layer's new cache or None)."""
    tm_cache = cm_cache = None
    if cache is not None:
        tm_cache = {"shift": cache["tm_shift"], "state": cache["state"]}
        cm_cache = {"shift": cache["cm_shift"]}
    t_out, tm_new = rwkv6.rwkv_time_mix(
        p["tmix"], rmsnorm(p["ln1"], h, cfg.norm_eps), cfg, tm_cache)
    h = h + t_out
    c_out, cm_new = rwkv6.rwkv_channel_mix(
        p["cmix"], rmsnorm(p["ln2"], h, cfg.norm_eps), cfg, cm_cache)
    h = h + c_out
    new_cache = None
    if cache is not None:
        new_cache = {"tm_shift": tm_new["shift"], "state": tm_new["state"],
                     "cm_shift": cm_new["shift"]}
    return h, new_cache


def apply_mamba_block(p, h, cfg: ModelConfig, cache=None):
    m_out, new_cache = mamba2.mamba_block(
        p["mamba"], rmsnorm(p["ln"], h, cfg.norm_eps), cfg, cache)
    return h + m_out, new_cache


def _layers(tree) -> list:
    """The per-layer trees of a tree stacked over its leading axis."""
    if not isinstance(tree, dict):
        return tree.unbind(0)
    parts = {k: _layers(v) for k, v in tree.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


# Matmuls without batch dimensions (activations @ weights) lower to mm or
# addmm; the attention einsums, which have batch dimensions, lower to bmm.
_SAVED_BY_POLICY = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    del ctx, args, kwargs
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_POLICY
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _ckpt(fn, cfg: ModelConfig, cache):
    """``fn`` rematerialised as ``cfg.remat`` says, on the full-sequence
    forward with grad on; ``fn`` itself otherwise (prefill, decode, no
    grad, remat "none")."""
    if cfg.remat == "none" or cache is not None or not torch.is_grad_enabled():
        return fn
    kw = {}
    if cfg.remat == "policy":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_matmuls)
    elif cfg.remat != "block":
        raise ValueError(f"unknown remat {cfg.remat!r}")
    # the backward's recompute (on autograd's device thread for CUDA
    # tensors) runs under the forward's axis environment
    env = axisenv.current()

    def under_env(*args):
        with axisenv.installed(env):
            return fn(*args)

    return lambda *args: checkpoint(under_env, *args, use_reentrant=False,
                                    **kw)


def run_stack(params, h, cfg: ModelConfig, *, cos, sin, cache=None,
              cur_len=None, collect_cache=False, reserve=None):
    """Run the decoder stack. Returns (h, cache, aux), aux the sum of the
    layers' MoE load-balance losses (0 without MoE layers).

    collect_cache: build the cache from this full pass (prefill), with room
    for ``reserve`` positions (default: the sequence length; zeros past it).
    cache: a stacked cache to decode against; it is written in place."""
    if collect_cache:
        B, S = h.shape[:2]
        cache = init_cache(cfg, B, max(reserve or S, S), device=h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.rwkv:
        return _run_rwkv_stack(params["rwkv"], h, cfg, cache), cache, aux
    kw = dict(cos=cos, sin=sin, cur_len=cur_len, collect_cache=collect_cache)
    if cfg.family == "hybrid":
        return _run_zamba_stack(params, h, cfg, cache, **kw), cache, aux
    if cfg.local_global_period:
        h, aux = _run_local_global_stack(params["lg"], h, cfg, cache, aux,
                                         **kw)
    else:
        h, aux = run_dense_layers(params["uniform"], h, cfg, cache, aux, **kw)
    return h, cache, aux


def run_dense_layers(params, h, cfg, kv, aux, *, enc_kv=None, **kw):
    """The dense blocks stacked (L, ...) in ``params``, layer i against
    layer i of the stacked KV cache ``kv`` and, for an enc-dec decoder, of
    the stacked cross K/V ``enc_kv``. Returns (h, aux plus the layers' MoE
    load-balance losses)."""
    layer = _ckpt(functools.partial(_attention_layer, cfg=cfg, kv=kv,
                                    enc_kv=enc_kv, **kw), cfg, kv)
    for i, p in enumerate(_layers(params)):
        h, a = layer(p, h, i)
        if a is not None:
            aux = aux + a
    return h, aux


def _run_local_global_stack(params, h, cfg, kv, aux, **kw):
    """gemma2: periods of ``per`` blocks, params stacked (L/per, per, ...).
    Every block of a period attends within ``sliding_window`` but the last,
    which is global; block i of period g is layer g*per + i of the cache.
    Returns (h, aux plus the layers' MoE load-balance losses)."""
    per = cfg.local_global_period
    windows = [cfg.sliding_window] * (per - 1) + [None]
    layers = [functools.partial(_attention_layer, cfg=cfg, kv=kv,
                                window=w, **kw) for w in windows]

    def period(group_p, h, g):
        a_sum = None
        for i, p in enumerate(_layers(group_p)):
            h, a = layers[i](p, h, g * per + i)
            if a is not None:
                a_sum = a if a_sum is None else a_sum + a
        return h, a_sum

    period = _ckpt(period, cfg, kv)
    for g, group_p in enumerate(_layers(params)):
        h, a = period(group_p, h, g)
        if a is not None:
            aux = aux + a
    return h, aux


def _attention_layer(p, h, i, *, cfg, kv, cos, sin, cur_len, collect_cache,
                     window=None, enc_kv=None):
    """One dense block against layer ``i`` of the stacked KV cache ``kv``
    (None: no cache) and of the stacked cross K/V ``enc_kv`` (None: no
    cross-attention). Prefill writes the fresh K/V at positions [0, S);
    decode writes the new position in place. Returns (h, the layer's MoE
    load-balance loss or None)."""
    layer_kv = None
    if kv is not None and not collect_cache:
        layer_kv = {"k": kv["k"][i], "v": kv["v"][i]}
    layer_enc = None
    if enc_kv is not None:
        layer_enc = {"k": enc_kv["k"][i], "v": enc_kv["v"][i]}
    h, new_kv, aux = apply_dense_block(p, h, cfg, cos=cos, sin=sin,
                                       window=window, cache=layer_kv,
                                       cur_len=cur_len, enc_kv=layer_enc,
                                       collect_cache=collect_cache)
    if collect_cache:
        S = h.shape[1]
        kv["k"][i, :, :S] = new_kv["k"]
        kv["v"][i, :, :S] = new_kv["v"]
    return h, aux


def _run_rwkv_stack(params, h, cfg, cache):
    """RWKV6: a uniform stack of time-mix + channel-mix blocks. Cache:
    {tm_shift, cm_shift (layers, B, 1, D), state (layers, B, H, K, K)}.

    Prefill hands every block its zero states, as the JAX package does, so
    a prompt longer than one token runs the WKV scan and a one-token prompt
    the decode step; each block's new states are written into the cache in
    place, in prefill and in decode."""
    block = _ckpt(lambda p, h: apply_rwkv_block(p, h, cfg)[0], cfg, cache)
    for i, p in enumerate(_layers(params)):
        if cache is None:
            h = block(p, h)
            continue
        h, new = apply_rwkv_block(p, h, cfg,
                                  {name: t[i] for name, t in cache.items()})
        for name, t in cache.items():
            t[i].copy_(new[name])
    return h


def _run_zamba_stack(params, h, cfg, cache, **kw):
    """zamba2: groups of ``attn_every`` Mamba2 blocks, each followed by the
    SHARED attention block (same params, per-application KV cache), then a
    tail of Mamba2 blocks. Cache: {"mamba": {conv, ssm} stacked over the
    num_layers Mamba2 layers, "attn": {k, v} stacked over the groups}.

    Prefill hands every Mamba2 block its zero states, as the JAX package
    does, so a prompt longer than one token runs the SSD scan (not the
    decode step); the block's new states are written into the cache in
    place, in prefill and in decode."""
    ae = max(cfg.attn_every, 1)
    groups, tail = divmod(cfg.num_layers, ae)

    mamba_block = _ckpt(lambda p, h: apply_mamba_block(p, h, cfg)[0], cfg,
                        cache)

    def mamba(p, h, layer):
        if cache is None:
            return mamba_block(p, h)
        m = cache["mamba"]
        h, new = apply_mamba_block(
            p, h, cfg, {"conv": m["conv"][layer], "ssm": m["ssm"][layer]})
        m["conv"][layer].copy_(new["conv"])
        m["ssm"][layer].copy_(new["ssm"])
        return h

    kv = None if cache is None else cache["attn"]

    def group(group_p, h, g):
        for i, p in enumerate(_layers(group_p)):
            h = mamba(p, h, g * ae + i)
        return _attention_layer(params["shared_attn"], h, g, cfg=cfg, kv=kv,
                                **kw)[0]

    group = _ckpt(group, cfg, cache)
    for g, group_p in enumerate(_layers(params["mamba_main"])):
        h = group(group_p, h, g)
    if tail:
        for t, p in enumerate(_layers(params["mamba_tail"])):
            h = mamba(p, h, groups * ae + t)
    return h


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Decode cache for the decoder stack, stacked over layers (hybrid: the
    Mamba2 states over layers and the shared block's K/V over groups; RWKV6:
    the token shifts and WKV states, which do not grow with ``max_len``)."""
    if cfg.rwkv:
        return rwkv6.init_rwkv_cache(cfg, batch, cfg.num_layers,
                                     device=device)
    if cfg.family == "hybrid":
        groups = cfg.num_layers // max(cfg.attn_every, 1)
        return {
            "mamba": mamba2.init_mamba_cache(cfg, batch, cfg.num_layers,
                                             device=device),
            "attn": attn.init_kv_cache(cfg, batch, max_len, groups,
                                       device=device),
        }
    return attn.init_kv_cache(cfg, batch, max_len, cfg.num_layers,
                              device=device)


def positions_for(cfg: ModelConfig, batch: int, seq: int, offset=0,
                  device="cuda"):
    """(B, S) positions offset..offset+S-1; (3, B, S), the same on every
    axis, for M-RoPE."""
    pos = torch.arange(seq, device=device)[None, :] + offset
    pos = pos.expand(batch, seq)
    if cfg.mrope_sections is not None:
        pos = pos[None].expand(3, batch, seq)
    return pos


def rope_tables(cfg: ModelConfig, positions):
    if cfg.rwkv:
        return None, None
    return rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta,
                        cfg.mrope_sections)
