"""Gradient compression for the slow cross-pod hop: the port of
``repro/optim/compress.py``.

- ``bf16``: cast to bf16 (2x fewer bytes).
- ``int8_ef``: per-tensor-scaled int8 quantization with error feedback
  (the residual is carried and added to the next step's gradient, so the
  quantization error does not accumulate).

The quantization math is device-agnostic. ``psum_compressed`` takes the
mean over one mesh axis's process group (``mesh.get_group("pod")``; None is
the whole world) with the payload compressed on the wire.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


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


def psum_compressed(grads, group, method: str, errors=None):
    """Cross-rank gradient mean over ``group`` with compression; returns
    (means, new_errors).

    ``none`` all-reduces in the gradients' dtype; ``bf16`` all-reduces the
    bf16 casts and divides in bf16; ``int8_ef`` all-gathers the int8 shards
    and their scales, dequantizes and takes the mean, which halves the
    bytes on the wire against a bf16 all-reduce."""
    n = dist.get_world_size(group)
    if method == "none":
        def mean(g):
            g = g.clone()
            dist.all_reduce(g, group=group)
            return g / n
        return _map(mean, grads), errors
    if method == "bf16":
        def mean_bf16(g):
            h = g.to(torch.bfloat16)
            dist.all_reduce(h, group=group)
            return (h / n).to(g.dtype)
        return _map(mean_bf16, grads), errors
    if method == "int8_ef":
        payload, new_errors = compress_tree(grads, method, errors)

        def reduce_one(qs):
            q, s = qs
            qg = q.new_empty(n * q.numel())                     # int8
            dist.all_gather_into_tensor(qg, q.reshape(-1), group=group)
            qg = qg.reshape((n,) + tuple(q.shape))              # (n, ...)
            sg = s.reshape(1).new_empty(n)                      # (n,) f32
            dist.all_gather_into_tensor(sg, s.reshape(1), group=group)
            vals = qg.float() * sg.reshape((-1,) + (1,) * q.dim())
            return vals.mean(0)

        return _map(reduce_one, payload), new_errors
    raise ValueError(method)
