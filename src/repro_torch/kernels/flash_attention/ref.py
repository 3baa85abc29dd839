"""Plain PyTorch version of the flash-attention kernel: full-softmax
attention that materialises the (Sq, Sk) score matrix. The port's copy of
``repro/kernels/flash_attention/ref.py::attention_reference``."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_reference(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None, q_offset: int = 0):
    """q (B,Sq,H,hd); k/v (B,Sk,KVH,hd) -> (B,Sq,H,hd) in q's dtype."""
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    ke = k.repeat_interleave(G, dim=2) if G > 1 else k
    ve = v.repeat_interleave(G, dim=2) if G > 1 else v
    s = torch.einsum("bihd,bjhd->bhij", q.float() * hd ** -0.5, ke.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= qpos[:, None] - kpos[None, :] < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhij,bjhd->bihd", p, ve.float())
    return o.to(q.dtype)
