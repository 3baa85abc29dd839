"""Dispatching wrapper for the Mamba2 SSD scan."""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.mamba2_ssd import mamba2_ssd
from repro_torch.kernels.mamba2_ssd import ref
from repro_torch.kernels.mamba2_ssd.ref import ssd_chunked, ssd_naive

__all__ = ["ssd", "ssd_step"]


def ssd(x, log_a, b, c, initial_state=None, *, impl: str | None = None,
        chunk: int = 128):
    """x (B,L,H,P); log_a (B,L,H); b/c (B,L,G,N); initial_state (B,H,P,N)
    or None -> (y (B,L,H,P) in x's dtype, final state f32).

    impl="kernel" launches the CUDA kernel and raises on CPU tensors
    or when an input takes part in a gradient (``kernels/dispatch.py``);
    "ref" is the plain chunked version and "naive" the step-by-step one;
    None picks the kernel for CUDA tensors and "ref" for CPU tensors."""
    if dispatch.sharded(x, log_a, b, c, initial_state):
        return dispatch.run_local(
            "mamba2_ssd", lambda *t: ssd(*t, impl=impl, chunk=chunk),
            (x, log_a, b, c, initial_state),
            ({"batch": 0, "heads": 2}, {"batch": 0, "heads": 2},
             {"batch": 0}, {"batch": 0}, {"batch": 0, "heads": 1}),
            ({"ndim": 4, "batch": 0, "heads": 2},
             {"ndim": 4, "batch": 0, "heads": 1}))
    impl = dispatch.resolve(impl, "mamba2_ssd", x, log_a, b, c, initial_state)
    if impl == "kernel":
        return mamba2_ssd.ssd_cuda(x, log_a, b, c, initial_state, chunk=chunk)
    if impl == "ref":
        return ssd_chunked(x, log_a, b, c, initial_state, chunk=chunk)
    if impl == "naive":
        return ssd_naive(x, log_a, b, c, initial_state)
    if impl == "meta":
        B, L, H, P = x.shape
        N = b.shape[-1]
        Q = min(chunk, L)
        # per (b, h, chunk): C B^T and M x over the lower triangle of the
        # Q x Q tile, C S^T and the rank-Q state update
        dispatch.add_flops(2 * B * H * (L // Q) * (
            Q * (Q + 1) // 2 * (N + P) + 2 * Q * P * N))
        return (torch.empty_like(x),
                x.new_empty((B, H, P, N), dtype=torch.float32))
    raise ValueError(f"unknown impl {impl!r}")


def ssd_step(x_t, log_a_t, b_t, c_t, state):
    """One decode step (``ref.ssd_step``); on DTensors, on each rank's
    local batch rows and heads."""
    if dispatch.sharded(x_t, log_a_t, b_t, c_t, state):
        heads = {"batch": 0, "heads": 1}
        return dispatch.run_local(
            "mamba2_ssd step", ref.ssd_step, (x_t, log_a_t, b_t, c_t, state),
            (heads, heads, {"batch": 0}, {"batch": 0}, heads),
            ({"ndim": 3, **heads}, {"ndim": 4, **heads}))
    return ref.ssd_step(x_t, log_a_t, b_t, c_t, state)
