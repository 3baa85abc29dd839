"""Dispatching wrapper for the Mamba2 SSD scan."""
from __future__ import annotations

from repro_torch.kernels import dispatch
from repro_torch.kernels.mamba2_ssd import mamba2_ssd
from repro_torch.kernels.mamba2_ssd.ref import (ssd_chunked, ssd_naive,
                                                ssd_step)

__all__ = ["ssd", "ssd_step"]


def ssd(x, log_a, b, c, initial_state=None, *, impl: str | None = None,
        chunk: int = 128):
    """x (B,L,H,P); log_a (B,L,H); b/c (B,L,G,N); initial_state (B,H,P,N)
    or None -> (y (B,L,H,P) in x's dtype, final state f32).

    impl="kernel" launches the CUDA kernel and raises on CPU tensors
    or when an input takes part in a gradient (``kernels/dispatch.py``);
    "ref" is the plain chunked version and "naive" the step-by-step one;
    None picks the kernel for CUDA tensors and "ref" for CPU tensors."""
    impl = dispatch.resolve(impl, "mamba2_ssd", x, log_a, b, c, initial_state)
    if impl == "kernel":
        return mamba2_ssd.ssd_cuda(x, log_a, b, c, initial_state, chunk=chunk)
    if impl == "ref":
        return ssd_chunked(x, log_a, b, c, initial_state, chunk=chunk)
    if impl == "naive":
        return ssd_naive(x, log_a, b, c, initial_state)
    raise ValueError(f"unknown impl {impl!r}")
