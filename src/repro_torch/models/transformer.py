"""Decoder-only transformer stacks: the port of the uniform dense stack, the
zamba2 hybrid stack and the RWKV6 stack of ``repro/models/transformer.py``.

The JAX package scans stacked (L, ...) parameters with ``lax.scan``; the port
keeps the same stacked layout and loops over layers in Python. The same
blocks serve the full-sequence forward (no cache), prefill (collect the
cache) and decode (write the cache at ``cur_len`` and attend over it, or
carry the recurrent states). The uniform stack takes the MoE FFN for the
moe family, and every pass sums the layers' load-balance losses. The gemma2
local/global stack and the enc-dec stacks wait for their slices (ROADMAP.md
section 1).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba2, rwkv6
from repro_torch.models.layers import rmsnorm, rmsnorm_params, rope_cos_sin
from repro_torch.models.mlp import mlp, mlp_params
from repro_torch.models.moe import moe_ffn, moe_params


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a config whose layers are not ported."""
    pending = [
        (cfg.is_encdec, "enc-dec stack", "the enc-dec and VLM slice"),
        (cfg.mrope_sections is not None, "M-RoPE", "the enc-dec and VLM slice"),
        (bool(cfg.local_global_period) or cfg.post_norm,
         "gemma2 local/global stack", "the gemma2 stack"),
    ]
    for hit, what, where in pending:
        if hit:
            raise NotImplementedError(
                f"{cfg.name}: the {what} is not ported yet; it waits for "
                f"{where} (ROADMAP.md section 1)")


def dense_block_params(mk, cfg: ModelConfig, stacked=(), moe: bool = False):
    return {
        "ln1": rmsnorm_params(mk, cfg.d_model, stacked),
        "attn": attn.attention_params(mk, cfg, stacked),
        "ln2": rmsnorm_params(mk, cfg.d_model, stacked),
        "ffn": (moe_params(mk, cfg, stacked) if moe
                else mlp_params(mk, cfg, stacked)),
    }


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
    check_supported(cfg)
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
    return {"uniform": dense_block_params(mk, cfg, stacked=(cfg.num_layers,),
                                          moe=cfg.is_moe)}


def apply_dense_block(p, h, cfg: ModelConfig, *, cos, sin, window=None,
                      causal=True, cache=None, cur_len=None,
                      collect_cache=False):
    """Returns (h, cache, aux): the layer's fresh {k, v} when collecting,
    the updated layer cache when decoding, else None; aux is the MoE
    load-balance loss (None for a dense FFN)."""
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
    h = h + a_out
    m_in = rmsnorm(p["ln2"], h, cfg.norm_eps)
    aux = None
    if "router" in p["ffn"]:
        m_out, aux = moe_ffn(p["ffn"], m_in, cfg)
    else:
        m_out = mlp(p["ffn"], m_in, cfg)
    return h + m_out, new_cache, aux


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


def _layer(tree, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def run_stack(params, h, cfg: ModelConfig, *, cos, sin, cache=None,
              cur_len=None, collect_cache=False, reserve=None):
    """Run the decoder stack. Returns (h, cache, aux), aux the sum of the
    layers' MoE load-balance losses (0 without MoE layers).

    collect_cache: build the cache from this full pass (prefill), with room
    for ``reserve`` positions (default: the sequence length; zeros past it).
    cache: a stacked cache to decode against; it is written in place."""
    check_supported(cfg)
    if collect_cache:
        B, S = h.shape[:2]
        cache = init_cache(cfg, B, max(reserve or S, S), device=h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.rwkv:
        return _run_rwkv_stack(params["rwkv"], h, cfg, cache), cache, aux
    kw = dict(cos=cos, sin=sin, cur_len=cur_len, collect_cache=collect_cache)
    if cfg.family == "hybrid":
        return _run_zamba_stack(params, h, cfg, cache, **kw), cache, aux
    for i in range(cfg.num_layers):
        h, a = _attention_layer(_layer(params["uniform"], i), h, cfg, cache,
                                i, **kw)
        if a is not None:
            aux = aux + a
    return h, cache, aux


def _attention_layer(p, h, cfg, kv, i, *, cos, sin, cur_len, collect_cache):
    """One dense block against layer ``i`` of the stacked KV cache ``kv``
    (None: no cache). Prefill writes the fresh K/V at positions [0, S);
    decode writes the new position in place. Returns (h, the layer's MoE
    load-balance loss or None)."""
    layer_kv = None
    if kv is not None and not collect_cache:
        layer_kv = {"k": kv["k"][i], "v": kv["v"][i]}
    h, new_kv, aux = apply_dense_block(p, h, cfg, cos=cos, sin=sin,
                                       cache=layer_kv, cur_len=cur_len,
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
    for i in range(cfg.num_layers):
        p = _layer(params, i)
        if cache is None:
            h = apply_rwkv_block(p, h, cfg)[0]
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

    def mamba(p, h, layer):
        if cache is None:
            return apply_mamba_block(p, h, cfg)[0]
        m = cache["mamba"]
        h, new = apply_mamba_block(
            p, h, cfg, {"conv": m["conv"][layer], "ssm": m["ssm"][layer]})
        m["conv"][layer].copy_(new["conv"])
        m["ssm"][layer].copy_(new["ssm"])
        return h

    kv = None if cache is None else cache["attn"]
    for g in range(groups):
        group_p = _layer(params["mamba_main"], g)
        for i in range(ae):
            h = mamba(_layer(group_p, i), h, g * ae + i)
        h = _attention_layer(params["shared_attn"], h, cfg, kv, g, **kw)[0]
    for t in range(tail):
        h = mamba(_layer(params["mamba_tail"], t), h, groups * ae + t)
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
    pos = torch.arange(seq, device=device)[None, :] + offset
    return pos.expand(batch, seq)


def rope_tables(cfg: ModelConfig, positions):
    if cfg.rwkv:
        return None, None
    return rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta,
                        cfg.mrope_sections)
