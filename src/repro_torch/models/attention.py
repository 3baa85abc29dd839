"""Attention: GQA projections, the chunked plain attention, self- and
cross-attention and the KV cache. The port of ``repro/models/attention.py``.

``mha_reference`` is the plain blockwise online-softmax attention: it never
materialises the full (Sq, Sk) score matrix beyond one chunk pair, skips
fully masked KV chunks when the offset is a Python int, and supports GQA,
causal masking with a query offset, static windows, logit softcap and a
valid-length mask (decode against a partly filled cache).

``attend`` sends a call to the flash-attention kernel exactly where the JAX
``attend`` sends it to the Pallas kernel: ``cfg.attn_impl == "kernel"``, a
static (int) ``q_offset``, no ``valid_len`` and more than one query
position, i.e. prefill and full-sequence forward. ``ops.attention`` then
launches the CUDA kernel for CUDA tensors and takes its plain version for
CPU tensors. Decode (one query position against the cache, with
``valid_len``) stays on ``mha_reference``'s Sq <= 8 path, as in the JAX
package: it is a GEMV-like pass over the cache where a kernel of this kind
buys nothing. Cross-attention (non-causal, Sq != Sk) follows the same rule:
the kernel in prefill and the full-sequence forward, ``mha_reference`` in
decode.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import axisenv
from repro_torch.kernels import dispatch
from repro_torch.models.layers import _lead, apply_rope, dtype_of, rmsnorm_head

NEG_INF = -1e30


def attention_params(mk, cfg: ModelConfig, stacked=(), cross: bool = False):
    """Projection weights for one attention module (self or cross; a cross
    module has no qk-norm)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nh, nkv = cfg.num_heads, cfg.num_kv_heads
    lead = _lead(stacked)
    p = {
        "wq": mk.param(stacked + (d, nh, hd),
                       lead + ("embed", "heads", "head_dim"), fan_in=d),
        "wk": mk.param(stacked + (d, nkv, hd),
                       lead + ("embed", "kv_heads", "head_dim"), fan_in=d),
        "wv": mk.param(stacked + (d, nkv, hd),
                       lead + ("embed", "kv_heads", "head_dim"), fan_in=d),
        "wo": mk.param(stacked + (nh, hd, d),
                       lead + ("heads", "head_dim", "embed"), fan_in=nh * hd),
    }
    if cfg.qk_norm and not cross:
        p["q_norm"] = mk.param(stacked + (hd,), lead + ("head_dim",),
                               init="ones")
        p["k_norm"] = mk.param(stacked + (hd,), lead + ("head_dim",),
                               init="ones")
    return p


# ---------------------------------------------------------------------------
# Plain attention
# ---------------------------------------------------------------------------


def _chunk_alive(causal: bool, window: Optional[int],
                 q0: int, q1: int, k0: int, k1: int) -> bool:
    """Whether a (q-chunk, kv-chunk) pair holds a live position. Positions
    are absolute; the ranges are [q0, q1) and [k0, k1)."""
    if causal and k0 > q1 - 1:
        return False
    if window is not None and q0 - (k1 - 1) >= window:
        return False
    return True


def _mask(qpos, kpos, causal, window, valid_len):
    mask = torch.ones(len(qpos), len(kpos), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= qpos[:, None] - kpos[None, :] < window
    if valid_len is not None:
        mask &= kpos[None, :] < valid_len
    return mask


def mha_reference(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None,
                  softcap: Optional[float] = None, q_offset=0,
                  valid_len=None, chunk_q: int = 1024, chunk_k: int = 1024):
    """q (B,Sq,H,hd); k/v (B,Sk,KVH,hd) -> (B,Sq,H,hd) in q's dtype.

    q_offset is an int or a 0-d integer tensor (decode); valid_len, when
    given, masks KV positions >= valid_len. GQA repeats K/V to the full head
    count, one chunk at a time."""
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    assert H % KVH == 0, (H, KVH)
    G = H // KVH
    static_offset = isinstance(q_offset, int)
    dev = q.device

    qf = q.float() * hd ** -0.5
    kf, vf = k.float(), v.float()
    kpos_all = torch.arange(Sk, device=dev)

    def kv_chunk(t, k0, k1):
        c = t[:, k0:k1]
        return c if G == 1 else c.repeat_interleave(G, dim=2)  # (B,ck,H,hd)

    def pv(p, vc):
        return torch.einsum("bhij,bjhd->bihd", p, vc)

    def scores(qc, kc, qpos, kpos):
        s = torch.einsum("bihd,bjhd->bhij", qc, kc)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        return torch.where(_mask(qpos, kpos, causal, window, valid_len),
                           s, NEG_INF)

    # decode fast path: tiny Sq, one pass over the whole cache
    if Sq <= 8:
        qpos = torch.arange(Sq, device=dev) + q_offset
        p = torch.softmax(scores(qf, kv_chunk(kf, 0, Sk), qpos, kpos_all), -1)
        return pv(p, kv_chunk(vf, 0, Sk)).to(q.dtype)

    cq, ck = min(chunk_q, Sq), min(chunk_k, Sk)
    assert Sq % cq == 0 and Sk % ck == 0, "seq must divide chunk sizes"
    q_base = q_offset if static_offset else 0
    out_chunks = []
    for iq in range(Sq // cq):
        q0 = q_base + iq * cq
        qc = qf[:, iq * cq:(iq + 1) * cq]
        qpos = torch.arange(iq * cq, (iq + 1) * cq, device=dev) + q_offset
        m = torch.full((B, H, cq), NEG_INF, device=dev)
        l = torch.zeros(B, H, cq, device=dev)
        acc = torch.zeros(B, cq, H, hd, device=dev)
        for ik in range(Sk // ck):
            k0, k1 = ik * ck, (ik + 1) * ck
            if static_offset and not _chunk_alive(causal, window, q0, q0 + cq,
                                                  k0, k1):
                continue
            s = scores(qc, kv_chunk(kf, k0, k1), qpos, kpos_all[k0:k1])
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = (acc * corr.transpose(1, 2)[..., None]
                   + pv(p, kv_chunk(vf, k0, k1)))
            m = m_new
        out_chunks.append(acc / l.transpose(1, 2).clamp_min(1e-30)[..., None])
    return torch.cat(out_chunks, dim=1).to(q.dtype)


def _local_kv(q, k, v):
    """K/V for attention on each rank's heads: where the model axis shards
    q's heads but the K/V heads are too few to shard, K/V repeated to q's
    heads and sharded alike (as ``mha_reference`` repeats them)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(q, DTensor) or not isinstance(k, DTensor):
        return k, v
    mesh = q.device_mesh
    uneven = any(pq.is_shard(2) and not pk.is_shard(2)
                 and k.shape[2] % mesh.size(m)
                 for m, (pq, pk) in enumerate(zip(q.placements, k.placements)))
    if not uneven:
        return k, v
    G = q.shape[2] // k.shape[2]
    return tuple(axisenv.constrain(t.repeat_interleave(G, dim=2),
                                   "batch", None, "model", None) for t in (k, v))


def attend(q, k, v, *, cfg: ModelConfig, causal=True, window=None,
           q_offset=0, valid_len=None):
    """Dispatch between the flash-attention kernel and ``mha_reference``
    (see the module docstring for which calls take the kernel). On a mesh
    either runs on each rank's batch rows and heads
    (``kernels/dispatch.run_local``)."""
    if (cfg.attn_impl == "kernel" and isinstance(q_offset, int)
            and valid_len is None and q.shape[1] > 1):
        from repro_torch.kernels.flash_attention import ops as fa_ops
        k, v = _local_kv(q, k, v)
        return fa_ops.attention(q, k, v, causal=causal, window=window,
                                softcap=cfg.attn_logit_softcap,
                                q_offset=q_offset)
    if dispatch.sharded(q, k, v):
        heads = {"batch": 0, "heads": 2}
        return dispatch.run_local(
            "attention", lambda *t: attend(*t, cfg=cfg, causal=causal,
                                           window=window, q_offset=q_offset,
                                           valid_len=valid_len),
            (q, *_local_kv(q, k, v)), (heads,) * 3, {"ndim": 4, **heads})
    return mha_reference(
        q, k, v, causal=causal, window=window,
        softcap=cfg.attn_logit_softcap, q_offset=q_offset,
        valid_len=valid_len, chunk_q=cfg.attn_chunk, chunk_k=cfg.attn_chunk)


# ---------------------------------------------------------------------------
# Projections, the attention step and the cache
# ---------------------------------------------------------------------------


def _proj(x, w):
    """x (B,S,D) @ w (D,N,hd) -> (B,S,N,hd)."""
    D, N, hd = w.shape
    w = w.reshape(D, N * hd)
    uneven = axisenv.resolve("model", N) is None
    if uneven:
        # on a mesh whose model axis cannot shard N heads, the views to
        # and from heads (of y, and of w's gradient) need N*hd whole
        w = axisenv.constrain(w, None, None)
    y = x @ w
    if uneven:
        y = axisenv.constrain(y, "batch", *([None] * (y.ndim - 1)))
    return y.view(*x.shape[:-1], N, hd)


def project_qkv(params, x, cfg: ModelConfig, cos=None, sin=None):
    """x (B,S,D) -> q (B,S,H,hd), k/v (B,S,KVH,hd); applies qk-norm and rope.
    The JAX package fuses the K and V matmuls along a new leading axis; two
    matmuls give the same values."""
    cd = dtype_of(cfg.compute_dtype)
    q = _proj(x, params["wq"].to(cd))
    k = _proj(x, params["wk"].to(cd))
    v = _proj(x, params["wv"].to(cd))
    q = axisenv.constrain(q, "batch", None, "model", None)
    k = axisenv.constrain(k, "batch", None, "kv", None)
    v = axisenv.constrain(v, "batch", None, "kv", None)
    if "q_norm" in params:
        q = rmsnorm_head(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm_head(params["k_norm"], k, cfg.norm_eps)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def output_proj(params, o, cfg: ModelConfig):
    H, hd, D = params["wo"].shape
    w = params["wo"].to(dtype_of(cfg.compute_dtype)).reshape(H * hd, D)
    o = axisenv.constrain(o, "batch", None, "model", None)
    o = o.reshape(*o.shape[:2], H * hd)
    if axisenv.resolve("model", H) is None:
        # H heads too few to shard: the gradients' views back to heads
        # need the H*hd axis whole
        o = axisenv.constrain(o, "batch", None, None)
        w = axisenv.constrain(w, None, None)
    out = o @ w
    return axisenv.constrain(out, "batch",
                             "seq" if cfg.seq_parallel else None, None)


def self_attention(params, x, cfg: ModelConfig, *, cos, sin, causal=True,
                   window=None, cache=None, cur_len=None):
    """One self-attention application. Returns (out (B,Sq,D), cache).

    cache: None (full sequence) or {k, v} of (B, S_max, KVH, hd). The new
    tokens are written at [cur_len, cur_len + Sq) IN PLACE (the JAX package
    returns an updated copy; the values are the same), and attention sees
    positions < cur_len + Sq."""
    q, k_new, v_new = project_qkv(params, x, cfg, cos, sin)
    if cache is None:
        o = attend(q, k_new, v_new, cfg=cfg, causal=causal, window=window)
        return output_proj(params, o, cfg), None
    start = int(cur_len)
    cache["k"][:, start:start + x.shape[1]] = k_new
    cache["v"][:, start:start + x.shape[1]] = v_new
    k = axisenv.constrain(cache["k"], "batch", None, "kv", None)
    v = axisenv.constrain(cache["v"], "batch", None, "kv", None)
    o = attend(q, k, v, cfg=cfg, causal=True,
               window=window, q_offset=cur_len,
               valid_len=start + x.shape[1])
    return output_proj(params, o, cfg), cache


def cross_attention(params, x, enc_kv, cfg: ModelConfig):
    """Decoder cross-attention against the encoder's precomputed
    ``enc_kv = {k, v}`` of (B, S_enc, KVH, hd): no rope, no mask."""
    q = _proj(x, params["wq"].to(dtype_of(cfg.compute_dtype)))
    o = attend(q, enc_kv["k"], enc_kv["v"], cfg=cfg, causal=False)
    return output_proj(params, o, cfg)


def encode_cross_kv(params, enc_out, cfg: ModelConfig):
    """One decoder layer's cross K/V from the encoder output (B, S_enc, D)."""
    cd = dtype_of(cfg.compute_dtype)
    return {"k": _proj(enc_out, params["wk"].to(cd)),
            "v": _proj(enc_out, params["wv"].to(cd))}


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, layers: int,
                  dtype=None, device="cuda"):
    """KV cache stacked over layers: {k, v} of (L, B, S_max, KVH, hd) (under
    an axis environment, a DTensor at the activations' placements)."""
    dt = dtype or dtype_of(cfg.compute_dtype)
    shape = (layers, batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    axes = (None, "batch", None, "kv", None)
    return {"k": axisenv.zeros(shape, *axes, dtype=dt, device=device),
            "v": axisenv.zeros(shape, *axes, dtype=dt, device=device)}
