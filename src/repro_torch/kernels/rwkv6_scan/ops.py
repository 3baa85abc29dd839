"""Dispatching wrapper for the RWKV6 WKV scan."""
from __future__ import annotations

from repro_torch.kernels import dispatch
from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.kernels.rwkv6_scan.ref import (wkv6_chunked, wkv6_naive,
                                                wkv6_step)

__all__ = ["wkv6", "wkv6_step"]


def wkv6(r, k, v, log_w, u, initial_state=None, *, impl: str | None = None,
         chunk: int = 64):
    """r/k/log_w (B,L,H,K); v (B,L,H,V); u (H,K); initial_state (B,H,K,V)
    or None -> (y (B,L,H,V) in r's dtype, final state f32).

    impl="kernel" launches the CUDA kernel and raises on CPU tensors
    or when an input takes part in a gradient (``kernels/dispatch.py``);
    "ref" is the plain chunked version and "naive" the step-by-step one;
    None picks the kernel for CUDA tensors and "ref" for CPU tensors."""
    impl = dispatch.resolve(impl, "rwkv6_scan", r, k, v, log_w, u, initial_state)
    if impl == "kernel":
        return rwkv6_scan.wkv6_cuda(r, k, v, log_w, u, initial_state,
                                    chunk=chunk)
    if impl == "ref":
        return wkv6_chunked(r, k, v, log_w, u, initial_state, chunk=chunk)
    if impl == "naive":
        return wkv6_naive(r, k, v, log_w, u, initial_state)
    raise ValueError(f"unknown impl {impl!r}")
