"""Public model API of the port: the language-model entry points of
``repro/models/api.py`` for every arch of the registry (the dense stack, the
gemma2 local/global stack, the MoE stack, the zamba2 hybrid stack, the RWKV6
stack and the enc-dec stack).

    params = init_params(cfg, generator, device)   # nested dict of tensors
    specs = param_specs(cfg)                       # logical axes, same tree
    logits, aux = forward(params, cfg, batch)      # full sequence
    logits, cache = prefill(params, cfg, batch)    # last-position logits
    logits, cache = decode_step(params, cfg, cache, tokens, cur_len)
    loss, metrics = loss_fn(params, cfg, batch)   # training

batch: {"tokens": (B,S) integers} or {"embeds": (B,S,D)} for the
stub-frontend archs (vlm, audio), "positions" optional ((B,S), or (3,B,S)
for M-RoPE; default 0..S-1 on every axis), "frames" (B,S_enc,D) for the
enc-dec encoder, and "labels", "loss_mask" for the loss. The parameter tree
has the JAX package's names, shapes and layouts (``tok``, ``final_norm``,
``stack/uniform`` stacked over layers; gemma2 ``stack/lg`` stacked over
(periods, period); zamba2 ``stack/mamba_main`` stacked over (groups,
attn_every), ``stack/mamba_tail`` and ``stack/shared_attn``; RWKV6
``stack/rwkv``; enc-dec ``stack/{encoder,enc_norm,decoder}``). The enc-dec
cache is {"self": the decoder's KV cache, "cross": the cross K/V of every
decoder layer}; the cross K/V are built once in prefill and pass through
decode and ``grow_cache`` unchanged.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, transformer
from repro_torch.models.layers import (InitMaker, ShapeMaker, SpecMaker,
                                       dtype_of, embed, embedding_params,
                                       rmsnorm, rmsnorm_params,
                                       softmax_cross_entropy, unembed)


def model_params(mk, cfg: ModelConfig):
    return {
        "tok": embedding_params(mk, cfg),
        "final_norm": rmsnorm_params(mk, cfg.d_model),
        "stack": (encdec.encdec_stack_params(mk, cfg) if cfg.is_encdec
                  else transformer.stack_params(mk, cfg)),
    }


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cuda"):
    """Seeded random parameters drawn on ``device`` (default: the card).
    ``generator`` must live on ``device``; None draws from a generator
    seeded with 0."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    mk = InitMaker(generator, dtype_of(cfg.param_dtype), device)
    return model_params(mk, cfg)


def abstract_params(cfg: ModelConfig):
    """The (shape, dtype) of every parameter, allocating nothing."""
    return model_params(ShapeMaker(dtype_of(cfg.param_dtype)), cfg)


def param_specs(cfg: ModelConfig):
    """The logical-axis tuple of every parameter (the same tree)."""
    return model_params(SpecMaker(), cfg)


def _embed_input(params, cfg, batch):
    if batch.get("embeds") is not None:
        h = batch["embeds"].to(dtype_of(cfg.compute_dtype))
    else:
        h = embed(params["tok"], batch["tokens"], cfg)
    B, S = h.shape[:2]
    pos = batch.get("positions")
    if pos is None:
        pos = transformer.positions_for(cfg, B, S, device=h.device)
    cos, sin = transformer.rope_tables(cfg, pos)
    return h, cos, sin


def _encode(params, cfg, batch, dtype):
    """The enc-dec encoder over batch["frames"], then every decoder layer's
    cross K/V: {k, v} of (L, B, S_enc, KVH, hd)."""
    frames = batch["frames"].to(dtype)
    B, S_enc = frames.shape[:2]
    ecos, esin = transformer.rope_tables(
        cfg, transformer.positions_for(cfg, B, S_enc, device=frames.device))
    enc_out = encdec.encode(params["stack"], frames, cfg, cos=ecos, sin=esin)
    return encdec.cross_kv(params["stack"], enc_out, cfg)


def forward(params, cfg: ModelConfig, batch):
    """Full-sequence logits (B,S,V) and the auxiliary loss: the sum over
    layers of the MoE load-balance loss (0 without MoE layers)."""
    h, cos, sin = _embed_input(params, cfg, batch)
    if cfg.is_encdec:
        h, _, aux = encdec.run_decoder(params["stack"], h, cfg, cos=cos,
                                       sin=sin,
                                       enc_kv=_encode(params, cfg, batch,
                                                      h.dtype))
    else:
        h, _, aux = transformer.run_stack(params["stack"], h, cfg, cos=cos,
                                          sin=sin)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return unembed(params["tok"], h, cfg), aux


def loss_fn(params, cfg: ModelConfig, batch):
    """(loss, {"ce", "aux", "tokens"}): the f32 cross-entropy of the
    next-token labels (over ``loss_mask`` where given), plus
    ``router_aux_coef`` times the summed load-balance loss for MoE."""
    logits, aux = forward(params, cfg, batch)
    ce, count = softmax_cross_entropy(logits, batch["labels"],
                                      batch.get("loss_mask"))
    loss = ce
    if cfg.is_moe:
        loss = loss + cfg.router_aux_coef * aux
    metrics = {"ce": ce, "aux": aux, "tokens": count}
    return loss, metrics


def prefill(params, cfg: ModelConfig, batch, reserve: Optional[int] = None):
    """Full-sequence pass that also builds the decode cache. Returns
    (last-position logits (B,V), cache). The (self-attention) KV cache has
    room for ``reserve`` positions (default: the sequence length, as in the
    JAX package, where ``grow_cache`` pads it afterwards); positions past S
    are zeros."""
    h, cos, sin = _embed_input(params, cfg, batch)
    if cfg.is_encdec:
        ekv = _encode(params, cfg, batch, h.dtype)
        h, self_kv, _ = encdec.run_decoder(params["stack"], h, cfg, cos=cos,
                                           sin=sin, enc_kv=ekv,
                                           collect_cache=True, reserve=reserve)
        cache = {"self": self_kv, "cross": ekv}
    else:
        h, cache, _ = transformer.run_stack(params["stack"], h, cfg, cos=cos,
                                            sin=sin, collect_cache=True,
                                            reserve=reserve)
    h = rmsnorm(params["final_norm"], h[:, -1:], cfg.norm_eps)
    return unembed(params["tok"], h, cfg)[:, 0], cache


def decode_step(params, cfg: ModelConfig, cache, tokens, cur_len):
    """One decode step. tokens (B,1); cur_len: positions already in the
    cache (int). Returns (logits (B,V), cache); the cache is updated in
    place and returned."""
    B = tokens.shape[0]
    pos = transformer.positions_for(cfg, B, 1, offset=cur_len,
                                    device=tokens.device)
    h = embed(params["tok"], tokens, cfg)
    cos, sin = transformer.rope_tables(cfg, pos)
    if cfg.is_encdec:
        h, _, _ = encdec.run_decoder(params["stack"], h, cfg, cos=cos,
                                     sin=sin, enc_kv=cache["cross"],
                                     cache=cache["self"], cur_len=cur_len)
    else:
        h, cache, _ = transformer.run_stack(params["stack"], h, cfg, cos=cos,
                                            sin=sin, cache=cache,
                                            cur_len=cur_len)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return unembed(params["tok"], h, cfg)[:, 0], cache


def grow_cache(cfg: ModelConfig, cache, new_capacity: int):
    """Pad the attention KV cache with zeros along the sequence axis (axis 2)
    to ``new_capacity``; a cache that is already large enough is returned as
    it is; a DTensor cache is padded shard by shard. The Mamba2 conv and SSM
    states, the RWKV6 token shifts and WKV states and the enc-dec cross K/V
    do not grow with the sequence and pass through."""
    def pad(t):
        cap = t.shape[2]
        if cap >= new_capacity:
            return t
        if hasattr(t, "device_mesh"):
            # a DTensor: the sequence axis is never sharded, so each rank
            # pads its own shard and the placements stay as they are
            from torch.distributed.tensor import DTensor
            assert not any(p.is_shard(2) for p in t.placements), t.placements
            shape = t.shape[:2] + (new_capacity,) + t.shape[3:]
            return DTensor.from_local(
                pad(t.to_local()), t.device_mesh, t.placements,
                run_check=False, shape=shape,
                stride=torch.empty(shape, device="meta").stride())
        out = t.new_zeros(t.shape[:2] + (new_capacity,) + t.shape[3:])
        out[:, :, :cap] = t
        return out

    def pad_kv(kv):
        return {"k": pad(kv["k"]), "v": pad(kv["v"])}

    if cfg.is_encdec:
        return {"self": pad_kv(cache["self"]), "cross": cache["cross"]}
    if cfg.rwkv:
        return cache
    if cfg.family == "hybrid":
        return {"mamba": cache["mamba"], "attn": pad_kv(cache["attn"])}
    return pad_kv(cache)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int = 0,
               device="cuda"):
    """An empty decode cache; for enc-dec with zero cross K/V of ``enc_len``
    encoder positions."""
    if cfg.is_encdec:
        shape = (cfg.num_layers, batch, enc_len, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        dt = dtype_of(cfg.compute_dtype)
        return {"self": transformer.init_cache(cfg, batch, max_len,
                                               device=device),
                "cross": {"k": torch.zeros(shape, dtype=dt, device=device),
                          "v": torch.zeros(shape, dtype=dt, device=device)}}
    return transformer.init_cache(cfg, batch, max_len, device=device)
