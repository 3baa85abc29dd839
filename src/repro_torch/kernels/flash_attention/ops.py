"""Dispatching wrapper for flash attention."""
from __future__ import annotations

from typing import Optional

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
    impl = dispatch.resolve(impl, "flash_attention", q, k, v)
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)
    if impl == "kernel":
        q, k, v = (t if t.stride(-1) == 1 else t.contiguous()
                   for t in (q, k, v))
        return flash_attention.flash_attention_cuda(q, k, v, **kw)
    if impl == "ref":
        return attention_reference(q, k, v, **kw)
    raise ValueError(f"unknown impl {impl!r}")
