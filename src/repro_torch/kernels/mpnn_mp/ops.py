"""Dispatching wrapper for the MPNN message step."""
from __future__ import annotations

import torch

from repro_torch.kernels.mpnn_mp import mpnn_mp
from repro_torch.kernels.mpnn_mp.ref import message_pass_reference


def message_pass(h, edge_mat, adj, *, impl: str | None = None):
    """h (B,N,Hd); edge_mat (B,N,N,Hd,Hd); adj (B,N,N) -> (B,N,Hd).

    impl="kernel" launches the CUDA kernel and raises on CPU tensors;
    impl="ref" is the plain version; None picks the kernel for CUDA tensors
    and the plain version for CPU tensors."""
    if impl is None:
        impl = "kernel" if h.is_cuda else "ref"
    if impl == "kernel":
        if not h.is_cuda:
            raise ValueError("impl='kernel' needs CUDA tensors; "
                             "use impl='ref' on the CPU")
        return mpnn_mp.message_pass_cuda(
            h.contiguous(), edge_mat.contiguous(),
            adj.to(torch.float32).contiguous())
    if impl == "ref":
        return message_pass_reference(h, edge_mat, adj)
    raise ValueError(f"unknown impl {impl!r}")
