"""Dispatching wrapper for the MPNN message step."""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.mpnn_mp import mpnn_mp
from repro_torch.kernels.mpnn_mp.ref import message_pass_reference


def message_pass(h, edge_mat, adj, *, impl: str | None = None):
    """h (B,N,Hd); edge_mat (B,N,N,Hd,Hd); adj (B,N,N) -> (B,N,Hd).

    impl="kernel" launches the CUDA kernel and raises on CPU tensors
    or when an input takes part in a gradient (``kernels/dispatch.py``);
    impl="ref" is the plain version; None picks the kernel for CUDA tensors
    and the plain version for CPU tensors."""
    if dispatch.sharded(h, edge_mat, adj):
        batch = {"batch": 0}
        return dispatch.run_local(
            "mpnn_mp", lambda *t: message_pass(*t, impl=impl),
            (h, edge_mat, adj), (batch,) * 3, {"ndim": 3, **batch})
    impl = dispatch.resolve(impl, "mpnn_mp", h, edge_mat, adj)
    if impl == "kernel":
        return mpnn_mp.message_pass_cuda(
            h.contiguous(), edge_mat.contiguous(),
            adj.to(torch.float32).contiguous())
    if impl == "ref":
        return message_pass_reference(h, edge_mat, adj)
    if impl == "meta":
        B, N, Hd = h.shape
        dispatch.add_flops(2 * B * N * N * Hd * Hd)
        return torch.empty_like(h)
    raise ValueError(f"unknown impl {impl!r}")
