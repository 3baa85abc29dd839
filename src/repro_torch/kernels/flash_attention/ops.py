"""Dispatching wrapper for flash attention."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_reference


def attention(q, k, v, *, impl: str | None = None, causal: bool = True,
              window: Optional[int] = None, softcap: Optional[float] = None,
              q_offset: int = 0):
    """q (B,Sq,H,hd); k/v (B,Sk,KVH,hd) -> (B,Sq,H,hd) in q's dtype.

    impl="kernel" launches the CUDA kernel and raises on CPU tensors
    or when an input takes part in a gradient (``kernels/dispatch.py``);
    impl="ref" is the plain version; None picks the kernel for CUDA tensors
    and the plain version for CPU tensors."""
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)
    if dispatch.sharded(q, k, v):
        heads = {"batch": 0, "heads": 2}
        return dispatch.run_local(
            "flash_attention", lambda *t: attention(*t, impl=impl, **kw),
            (q, k, v), (heads,) * 3, {"ndim": 4, **heads})
    impl = dispatch.resolve(impl, "flash_attention", q, k, v)
    if impl == "kernel":
        q, k, v = (t if t.stride(-1) == 1 else t.contiguous()
                   for t in (q, k, v))
        return flash_attention.flash_attention_cuda(q, k, v, **kw)
    if impl == "ref":
        return attention_reference(q, k, v, **kw)
    if impl == "meta":
        B, Sq, H, hd = q.shape
        dispatch.add_flops(4 * hd * B * H * live_pairs(
            Sq, k.shape[1], causal, window, q_offset))
        return torch.empty_like(q)
    raise ValueError(f"unknown impl {impl!r}")


def live_pairs(Sq, Sk, causal, window, q_offset) -> int:
    """(query, key) pairs the mask keeps: the work the attention must do
    (4 hd operations each, the bound's count)."""
    qpos = np.arange(Sq, dtype=np.int64) + q_offset
    hi = np.minimum(qpos + 1, Sk) if causal else np.full(Sq, Sk)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())
