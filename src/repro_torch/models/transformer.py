"""Decoder-only transformer stack: the port of the uniform dense stack of
``repro/models/transformer.py``.

The JAX package scans stacked (L, ...) parameters with ``lax.scan``; the port
keeps the same stacked layout and loops over layers in Python. The same
block serves the full-sequence forward (no cache), prefill (collect the
cache) and decode (write the cache at ``cur_len`` and attend over it).
The gemma2 local/global stack, zamba2, RWKV6, MoE and enc-dec stacks wait
for their slices (ROADMAP.md section 1).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import rmsnorm, rmsnorm_params, rope_cos_sin
from repro_torch.models.mlp import mlp, mlp_params


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a config whose layers are not ported."""
    pending = [
        (cfg.rwkv, "RWKV6 stack", "the RWKV6 slice"),
        (cfg.family == "hybrid", "zamba2 stack", "the Mamba2 slice"),
        (cfg.is_moe, "MoE FFN", "the MoE slice"),
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


def dense_block_params(mk, cfg: ModelConfig, stacked=()):
    return {
        "ln1": rmsnorm_params(mk, cfg.d_model, stacked),
        "attn": attn.attention_params(mk, cfg, stacked),
        "ln2": rmsnorm_params(mk, cfg.d_model, stacked),
        "ffn": mlp_params(mk, cfg, stacked),
    }


def stack_params(mk, cfg: ModelConfig):
    check_supported(cfg)
    return {"uniform": dense_block_params(mk, cfg, stacked=(cfg.num_layers,))}


def apply_dense_block(p, h, cfg: ModelConfig, *, cos, sin, window=None,
                      causal=True, cache=None, cur_len=None,
                      collect_cache=False):
    """Returns (h, cache): the layer's fresh {k, v} when collecting, the
    updated layer cache when decoding, else None."""
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
    h = h + mlp(p["ffn"], rmsnorm(p["ln2"], h, cfg.norm_eps), cfg)
    return h, new_cache


def _layer(tree, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def run_stack(params, h, cfg: ModelConfig, *, cos, sin, cache=None,
              cur_len=None, collect_cache=False, reserve=None):
    """Run the decoder stack. Returns (h, cache).

    collect_cache: build the cache from this full pass (prefill), with room
    for ``reserve`` positions (default: the sequence length; zeros past it).
    cache: a stacked cache to decode against; it is written in place."""
    check_supported(cfg)
    blocks = params["uniform"]
    B, S = h.shape[:2]
    out_cache = None
    if collect_cache:
        out_cache = init_cache(cfg, B, max(reserve or S, S), device=h.device)
    for i in range(cfg.num_layers):
        layer_cache = None
        if cache is not None:
            layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}
        h, new_c = apply_dense_block(
            _layer(blocks, i), h, cfg, cos=cos, sin=sin, cache=layer_cache,
            cur_len=cur_len, collect_cache=collect_cache)
        if collect_cache:
            out_cache["k"][i, :, :S] = new_c["k"]
            out_cache["v"][i, :, :S] = new_c["v"]
    return h, (out_cache if collect_cache else cache)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Decode cache for the decoder stack, stacked over layers."""
    return attn.init_kv_cache(cfg, batch, max_len, cfg.num_layers,
                              device=device)


def positions_for(cfg: ModelConfig, batch: int, seq: int, offset=0,
                  device="cuda"):
    pos = torch.arange(seq, device=device)[None, :] + offset
    return pos.expand(batch, seq)


def rope_tables(cfg: ModelConfig, positions):
    return rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta,
                        cfg.mrope_sections)
