"""Plain float32 reference of a dense decoder-only language model of the
InternLM2 kind (arXiv:2403.17297): token embedding; per layer a pre-norm
(RMSNorm) grouped-query self-attention with rotary position embeddings
(split-half convention, angles taken in float64) and a pre-norm SwiGLU MLP,
each added to the residual stream; a final RMSNorm and an untied output
head. No cache, no batching, no kernel: one sequence at a time, layer by
layer, with each layer's weights cast to float32 as it is reached and the
attention taken in blocks of queries.

The weights are the tree the benchmark drew and handed to the program (the
port's layout: ``tok/{embed,unembed}``, ``final_norm/scale``,
``stack/uniform/{ln1,attn,ln2,ffn}`` stacked over layers). The reference
reads it and nothing the program computed from it.

``quant="fp8"`` is the control: every operand of every projection, of the
MLP and of the output head is rounded to float8 e4m3 first (activations with
one scale a token, weights with one scale an output column), the step
below the configuration's bfloat16.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale along ``dim``'s slices."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _matmul(x, w, quant):
    """x (S, K) @ w (K, N) in float32, its operands rounded first under
    the control."""
    if quant == "fp8":
        x, w = _fp8(x, -1), _fp8(w, 0)
    return x @ w


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rope(x, pos, theta):
    """x (S, heads, hd), rotated by position, split-half pairs."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=x.device) / hd)
    ang = pos.double()[:, None] * inv
    c, s = ang.cos().float()[:, None], ang.sin().float()[:, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _attention(q, k, v, block):
    """Causal GQA: q (S, H, hd), k/v (S, KVH, hd) -> (S, H * hd)."""
    S, H, hd = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1).transpose(0, 1)      # (H, S, hd)
    v = v.repeat_interleave(G, dim=1).transpose(0, 1)
    out = []
    for s0 in range(0, S, block):
        qb = q[s0:s0 + block].transpose(0, 1) * hd ** -0.5  # (H, b, hd)
        kk = k[:, :s0 + qb.shape[1]]
        sc = qb @ kk.transpose(1, 2)                        # (H, b, s)
        qpos = torch.arange(s0, s0 + qb.shape[1], device=q.device)
        kpos = torch.arange(kk.shape[1], device=q.device)
        sc = sc.masked_fill(kpos[None, None, :] > qpos[None, :, None],
                            -math.inf)
        p = torch.softmax(sc, dim=-1)
        out.append((p @ v[:, :kk.shape[1]]).transpose(0, 1).reshape(
            qb.shape[1], H * hd))
    return torch.cat(out)


@torch.no_grad()
def logits(params: dict, cfg: dict, tokens, start: int, *, quant=None,
           block: int = 1024) -> torch.Tensor:
    """tokens (S,) -> float32 logits (S - start, V) of positions start..S-1,
    each the prediction of the token after it."""
    dev = params["tok"]["embed"].device
    tokens = torch.as_tensor(tokens, device=dev).long()
    S = tokens.shape[0]
    d, H, KVH = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"]
    hd = cfg["head_dim"] or d // H
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    pos = torch.arange(S, device=dev)
    stack = params["stack"]["uniform"]
    h = params["tok"]["embed"][tokens].float()
    for l in range(cfg["num_layers"]):
        def w(*path):
            t = stack
            for p in path:
                t = t[p]
            return t[l].float()

        x = _rmsnorm(h, w("ln1", "scale"), eps)
        q = _matmul(x, w("attn", "wq").reshape(d, H * hd), quant)
        k = _matmul(x, w("attn", "wk").reshape(d, KVH * hd), quant)
        v = _matmul(x, w("attn", "wv").reshape(d, KVH * hd), quant)
        q = _rope(q.view(S, H, hd), pos, theta)
        k = _rope(k.view(S, KVH, hd), pos, theta)
        o = _attention(q, k, v.view(S, KVH, hd), block)
        h = h + _matmul(o, w("attn", "wo").reshape(H * hd, d), quant)
        x = _rmsnorm(h, w("ln2", "scale"), eps)
        g = _matmul(x, w("ffn", "wi_gate"), quant)
        u = _matmul(x, w("ffn", "wi_up"), quant)
        h = h + _matmul(F.silu(g) * u, w("ffn", "wo"), quant)
    x = _rmsnorm(h[start:], params["final_norm"]["scale"].float(), eps)
    return _matmul(x, params["tok"]["unembed"].float(), quant)
