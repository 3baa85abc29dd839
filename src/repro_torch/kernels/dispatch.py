"""How each kernel's ``ops`` wrapper picks between the hand-written kernel
and its plain version, shared by the five wrappers.

``impl=None`` picks the kernel for CUDA tensors and the plain version
("ref") for CPU tensors. The kernels write into tensors without autograd
history and have no backward, and neither have the Pallas kernels they
replace: a gradient through one would be silently missing. So a call that
resolves to the kernel raises while grad mode is on and an input requires
grad; training runs the plain versions (``attn_impl="ref"``,
``moe_impl="dropping"``), which autograd differentiates.
"""
from __future__ import annotations

import torch


def on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def resolve(impl, name: str, lead: torch.Tensor, *inputs) -> str:
    """The implementation to run: ``impl``, or the default for ``lead``'s
    device. Raises when the kernel is asked to take part in a gradient, or
    to run on CPU tensors."""
    if impl is None:
        impl = "kernel" if on_card(lead) else "ref"
    if impl != "kernel":
        return impl
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in (lead,) + inputs):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward (nor has the JAX "
            "package's Pallas kernel), so a gradient through it would be "
            "silently missing; differentiate through the plain version, "
            "impl='ref' (attn_impl='ref' and moe_impl='dropping' in a model "
            "config)")
    if not lead.is_cuda:
        raise ValueError("impl='kernel' needs CUDA tensors; "
                         "use impl='ref' on the CPU")
    return impl
