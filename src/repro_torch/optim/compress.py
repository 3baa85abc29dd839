"""Gradient compression for the slow cross-pod hop: the port of
``repro/optim/compress.py``.

- ``bf16``: cast to bf16 (2x fewer bytes).
- ``int8_ef``: per-tensor-scaled int8 quantization with error feedback
  (the residual is carried and added to the next step's gradient, so the
  quantization error does not accumulate).

The quantization math is device-agnostic; the compressed
cross-device reduction needs a mesh, which waits for the multi-device slice.
"""
from __future__ import annotations

import torch


def quantize_int8(x):
    """Symmetric per-tensor int8 quantization. Returns (q, scale); rounding
    is half to even, as in the JAX package."""
    xf = x.float()
    amax = xf.abs().max()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def _map(fn, tree, *rest):
    """fn over the leaves of nested dicts (a (q, scale) pair is a leaf)."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def compress_tree(grads, method: str, errors=None):
    """Quantize a gradient tree; returns (payload, new_errors).

    payload leaves are (q, scale) for int8_ef, bf16 tensors for bf16.
    errors is the error-feedback state (same tree as grads, f32)."""
    if method == "none":
        return grads, errors
    if method == "bf16":
        return _map(lambda g: g.to(torch.bfloat16), grads), errors
    if method == "int8_ef":
        if errors is None:
            errors = _map(lambda g: torch.zeros(
                g.shape, dtype=torch.float32, device=g.device), grads)

        def one(g, e):
            corrected = g.float() + e
            q, s = quantize_int8(corrected)
            new_e = corrected - dequantize_int8(q, s)
            return (q, s), new_e

        pairs = _map(one, grads, errors)
        payload = _map(lambda t: t[0], pairs)
        new_errors = _map(lambda t: t[1], pairs)
        return payload, new_errors
    raise ValueError(method)


def decompress_tree(payload, method: str, like=None):
    if method == "none":
        return payload
    if method == "bf16":
        return _map(lambda g: g.float(), payload)
    if method == "int8_ef":
        return _map(lambda qs: dequantize_int8(*qs), payload)
    raise ValueError(method)


def psum_compressed(grads, axis_name: str, method: str, errors=None):
    """Cross-device gradient mean with compression: needs a mesh."""
    raise NotImplementedError(
        "psum_compressed needs a device mesh; it waits for the multi-device "
        "slice (ROADMAP.md section 1 item 8)")
