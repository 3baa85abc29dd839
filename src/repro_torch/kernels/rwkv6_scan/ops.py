"""Dispatching wrapper for the RWKV6 WKV scan."""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.kernels.rwkv6_scan import ref
from repro_torch.kernels.rwkv6_scan.ref import wkv6_chunked, wkv6_naive

__all__ = ["wkv6", "wkv6_step"]


def wkv6(r, k, v, log_w, u, initial_state=None, *, impl: str | None = None,
         chunk: int = 64):
    """r/k/log_w (B,L,H,K); v (B,L,H,V); u (H,K); initial_state (B,H,K,V)
    or None -> (y (B,L,H,V) in r's dtype, final state f32).

    impl="kernel" launches the CUDA kernel and raises on CPU tensors
    or when an input takes part in a gradient (``kernels/dispatch.py``);
    "ref" is the plain chunked version and "naive" the step-by-step one;
    None picks the kernel for CUDA tensors and "ref" for CPU tensors."""
    if dispatch.sharded(r, k, v, log_w, u, initial_state):
        heads = {"batch": 0, "heads": 2}
        return dispatch.run_local(
            "rwkv6_scan", lambda *t: wkv6(*t, impl=impl, chunk=chunk),
            (r, k, v, log_w, u, initial_state),
            (heads, heads, heads, heads, {"heads": 0},
             {"batch": 0, "heads": 1}),
            ({"ndim": 4, **heads}, {"ndim": 4, "batch": 0, "heads": 1}))
    impl = dispatch.resolve(impl, "rwkv6_scan", r, k, v, log_w, u, initial_state)
    if impl == "kernel":
        return rwkv6_scan.wkv6_cuda(r, k, v, log_w, u, initial_state,
                                    chunk=chunk)
    if impl == "ref":
        return wkv6_chunked(r, k, v, log_w, u, initial_state, chunk=chunk)
    if impl == "naive":
        return wkv6_naive(r, k, v, log_w, u, initial_state)
    if impl == "meta":
        B, L, H, K = r.shape
        V = v.shape[-1]
        Q = min(chunk, L)
        # per (b, h, chunk): the carry-in, the causal halves of the decayed
        # r k^T and of A v, the rank-Q state update
        dispatch.add_flops(B * H * (L // Q) * (
            2 * Q * K * V + Q * Q * K + Q * Q * V + 2 * Q * K * V))
        return (v.new_empty((B, L, H, V), dtype=r.dtype),
                v.new_empty((B, H, K, V), dtype=torch.float32))
    raise ValueError(f"unknown impl {impl!r}")


def wkv6_step(r_t, k_t, v_t, log_w_t, u, state):
    """One decode step (``ref.wkv6_step``); on DTensors, on each rank's
    local batch rows and heads."""
    if dispatch.sharded(r_t, k_t, v_t, log_w_t, u, state):
        heads = {"batch": 0, "heads": 1}
        return dispatch.run_local(
            "rwkv6_scan step", ref.wkv6_step,
            (r_t, k_t, v_t, log_w_t, u, state),
            (heads, heads, heads, heads, {"heads": 0}, heads),
            ({"ndim": 3, **heads}, {"ndim": 4, **heads}))
    return ref.wkv6_step(r_t, k_t, v_t, log_w_t, u, state)
