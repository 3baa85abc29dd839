"""Encoder-decoder transformer (the seamless-m4t backbone). The port of
``repro/models/encdec.py``.

The modality frontend is a stub, as in the JAX package: the encoder takes
precomputed frame embeddings (B, S_enc, D). The encoder is a stack of dense
blocks with non-causal self-attention; the decoder a causal stack whose
blocks add a cross-attention sub-layer against the encoder output. The
cross K/V of every decoder layer are computed once from the encoder output
(``cross_kv``); decode carries {self-KV cache, cross K/V}.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import rmsnorm, rmsnorm_params
from repro_torch.models.transformer import (_ckpt, _layers, apply_dense_block,
                                            dense_block_params, init_cache,
                                            run_dense_layers)


def encdec_stack_params(mk, cfg: ModelConfig):
    return {
        "encoder": dense_block_params(mk, cfg, stacked=(cfg.encoder_layers,)),
        "enc_norm": rmsnorm_params(mk, cfg.d_model),
        "decoder": dense_block_params(mk, cfg, stacked=(cfg.num_layers,),
                                      cross=True),
    }


def encode(params, frames, cfg: ModelConfig, *, cos, sin):
    """frames (B, S_enc, D) -> encoder output (B, S_enc, D)."""
    def block(p, h):
        return apply_dense_block(p, h, cfg, cos=cos, sin=sin, causal=False)[0]

    block = _ckpt(block, cfg, None)
    h = frames
    for p in _layers(params["encoder"]):
        h = block(p, h)
    return rmsnorm(params["enc_norm"], h, cfg.norm_eps)


def cross_kv(params, enc_out, cfg: ModelConfig):
    """Every decoder layer's cross K/V: {k, v} of (L, B, S_enc, KVH, hd)."""
    kvs = [attn.encode_cross_kv(p["cross"], enc_out, cfg)
           for p in _layers(params["decoder"])]
    return {name: torch.stack([kv[name] for kv in kvs]) for name in ("k", "v")}


def run_decoder(params, h, cfg: ModelConfig, *, cos, sin, enc_kv, cache=None,
                cur_len=None, collect_cache=False, reserve=None):
    """The decoder stack with cross-attention against ``enc_kv`` (leaves
    (L, B, S_enc, ...)). Returns (h, self-attention cache, aux) as
    ``transformer.run_stack`` does: ``collect_cache`` builds the cache with
    room for ``reserve`` positions, a given ``cache`` is written in place."""
    if collect_cache:
        B, S = h.shape[:2]
        cache = init_cache(cfg, B, max(reserve or S, S), device=h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    h, aux = run_dense_layers(params["decoder"], h, cfg, cache, aux,
                              enc_kv=enc_kv, cos=cos, sin=sin, cur_len=cur_len,
                              collect_cache=collect_cache)
    return h, cache, aux
