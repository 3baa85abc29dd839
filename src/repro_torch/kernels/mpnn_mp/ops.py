"""Dispatching wrappers for the MPNN message step: ``message_pass`` on the
dense edge tensor, ``message_pass_typed`` on the bond types and the
per-member edge matrices."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.mpnn_mp import mpnn_mp
from repro_torch.kernels.mpnn_mp.ref import (message_pass_reference,
                                             message_pass_typed_reference)


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


def message_pass_typed(h, bonds, edge_w, adj, *, impl: str | None = None):
    """h (E*B,N,Hd) or (E,B,N,Hd); bonds (B,N,N) int; edge_w (E,nb,Hd*Hd);
    adj (B,N,N); bonds and adj may carry a leading (E,) axis, one batch per
    member -> h's shape: the step of ``message_pass`` on the edge tensor
    edge_w[e, bonds] without building it.

    impl as in ``message_pass``. The kernel skips pairs with adj = 0 (an
    exact 0 in the dense form), and a bond type outside [0, nb) adds nothing
    there where the plain version raises. Sharded inputs run on each rank's
    molecules: h as (E,B,N,Hd) with the batch axis sharded, edge_w whole."""
    if dispatch.sharded(h, bonds, edge_w, adj):
        if h.dim() != 4:
            raise ValueError("message_pass_typed: a sharded h must be "
                             "(E,B,N,Hd), with the batch axis on dim 1")
        return dispatch.run_local(
            "mpnn_mp_typed", lambda *t: message_pass_typed(*t, impl=impl),
            (h, bonds, edge_w, adj),
            ({"batch": 1}, {"batch": bonds.dim() - 3}, {},
             {"batch": adj.dim() - 3}), {"ndim": 4, "batch": 1})
    impl = dispatch.resolve(impl, "mpnn_mp_typed", h, bonds, edge_w, adj)
    if impl == "kernel":
        return mpnn_mp.message_pass_typed_cuda(
            h.contiguous(), bonds.to(torch.int32).contiguous(),
            edge_w.contiguous(), adj.to(torch.float32).contiguous())
    if impl == "ref":
        return message_pass_typed_reference(h, bonds, edge_w, adj)
    if impl == "meta":
        N, Hd = h.shape[-2:]
        dispatch.add_flops(2 * math.prod(h.shape[:-2]) * N * N * Hd * Hd)
        return torch.empty_like(h)
    raise ValueError(f"unknown impl {impl!r}")
