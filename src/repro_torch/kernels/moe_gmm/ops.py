"""Dispatching wrapper for the grouped matmul, and the MoE FFN built on it:
the port of ``repro/kernels/moe_gmm/ops.py``.

Routing and dispatch are those of ``models.moe.moe_dropping``
(``models.moe.dispatch``); the three expert products (gate, up, down) go
through ``gmm``. The JAX package maps the per-row dispatch over the batch
and tiles the expert weights to (B*E, D, F) for its kernel; here the slots
of all batch rows are laid out expert-major, (E, B*C, D), so each product
is one kernel call against the untiled weights (E, D, F) and every
expert's weights are read once. Each output row is the same dot product of
the same token with the same weight column, so the function is the same.
"""
from __future__ import annotations

from repro_torch.kernels import dispatch
from repro_torch.kernels.moe_gmm import moe_gmm
from repro_torch.kernels.moe_gmm.ref import gmm_reference
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import dtype_of
from repro_torch.models.mlp import _ACTS

__all__ = ["expert_ffn", "gmm", "moe_ffn"]


def gmm(xe, w, *, impl: str | None = None, live=None):
    """xe (G,M,D) @ w (G,D,F) -> (G,M,F) in xe's dtype.

    impl="kernel" launches the CUDA kernel and raises on CPU tensors
    or when an input takes part in a gradient (``kernels/dispatch.py``);
    impl="ref" is the plain version; None picks the kernel for CUDA tensors
    and the plain version for CPU tensors. ``live`` (G,) bool marks the
    groups whose rows of xe are not all zero: the kernel skips the others
    (zeros, no weight read); the plain version is not given it and computes
    every group, which gives the same zeros."""
    if dispatch.sharded(xe, w, live):
        experts = {"experts": 0}
        return dispatch.run_local(
            "moe_gmm", lambda a, b, l: gmm(a, b, impl=impl, live=l),
            (xe, w, live), (experts,) * 3, {"ndim": 3, **experts})
    impl = dispatch.resolve(impl, "moe_gmm", xe, w)
    if impl == "kernel":
        return moe_gmm.gmm_cuda(xe, w, live)
    if impl == "ref":
        return gmm_reference(xe, w)
    if impl == "meta":
        G, M, D = xe.shape
        dispatch.add_flops(2 * G * M * D * w.shape[-1])
        return xe.new_empty((G, M, w.shape[-1]))
    raise ValueError(f"unknown impl {impl!r}")


def expert_ffn(params, xe, cfg, live=None):
    """xe (E, N, D) -> (E, N, D): the per-expert gated MLP as three ``gmm``
    calls on the untiled (E, D, F) weights, with the JAX package's casts
    (activation and product in f32, then the compute dtype). ``live`` (E,)
    bool, from ``models.moe.dispatch``, marks the experts that hold a token;
    every call skips the others, whose rows are zero and stay zero (the
    configs' activations map 0 to 0)."""
    cd = dtype_of(cfg.compute_dtype)
    g = gmm(xe, params["wi_gate"].to(cd), live=live)
    u = gmm(xe, params["wi_up"].to(cd), live=live)
    return gmm((_ACTS[cfg.act](g.float()) * u.float()).to(cd),
               params["wo"].to(cd), live=live)


def moe_ffn(params, x, cfg):
    """x (B,S,D) -> (y (B,S,D), aux_loss)."""
    return moe_mod.dispatch(params, x, cfg, expert_ffn, pass_live=True)
