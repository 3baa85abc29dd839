"""Mamba2 block (zamba2 backbone): projections + causal conv + SSD scan. The
port of ``repro/models/mamba2.py``.

Layout follows the Mamba2 paper: a fused input projection producing
(z gate, x, B, C, dt), a depthwise causal conv over (x, B, C), the SSD
recurrence (``repro_torch.kernels.mamba2_ssd``), a gated RMSNorm and an
output projection. Decode carries {conv, ssm} states. The dtype casts are
the JAX package's: the dt-scaled input and, in a full-sequence pass, the
log decay go to the scan in the compute dtype; the decode step takes the
f32 log decay; the skip term and the gated norm run in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import axisenv
from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
from repro_torch.models.layers import _lead, dtype_of, rmsnorm

# log-decay clamp: keeps exp() terms finite in every implementation
MIN_LOG_A = -12.0


def mamba_dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    H = cfg.ssm_heads or d_inner // 64          # head dim P = 64 by default
    P = d_inner // H
    G = 1                                        # single B/C group
    return d_inner, H, P, G


def mamba_params(mk, cfg: ModelConfig, stacked=()):
    d = cfg.d_model
    d_inner, H, P, G = mamba_dims(cfg)
    N, W = cfg.ssm_state, cfg.ssm_conv
    conv_ch = d_inner + 2 * G * N
    proj_out = 2 * d_inner + 2 * G * N + H      # z, x, B, C, dt
    lead = _lead(stacked)
    return {
        "in_proj": mk.param(stacked + (d, proj_out),
                            lead + ("embed", "ssm_inner"), fan_in=d),
        "conv_w": mk.param(stacked + (W, conv_ch),
                           lead + ("conv", "ssm_inner"), scale=0.5),
        "conv_b": mk.param(stacked + (conv_ch,),
                           lead + ("ssm_inner",), init="zeros"),
        "a_log": mk.param(stacked + (H,), lead + ("ssm_heads",), init="ones"),
        "dt_bias": mk.param(stacked + (H,), lead + ("ssm_heads",),
                            init="zeros"),
        "d_skip": mk.param(stacked + (H,), lead + ("ssm_heads",), init="ones"),
        "norm": mk.param(stacked + (d_inner,), lead + ("ssm_inner",),
                         init="ones"),
        "out_proj": mk.param(stacked + (d_inner, d),
                             lead + ("ssm_inner", "embed"), fan_in=d_inner),
    }


def _split_proj(zxbcdt, cfg):
    d_inner, H, P, G = mamba_dims(cfg)
    N = cfg.ssm_state
    return torch.split(zxbcdt, [d_inner, d_inner, G * N, G * N, H], dim=-1)


def _causal_conv(x, w, b, conv_state=None):
    """Depthwise causal conv. x (B,L,C), w (W,C). Returns (y, new_state)
    where state is the last W-1 inputs (B, W-1, C)."""
    W = w.shape[0]
    if conv_state is None:
        pad = x.new_zeros(x.shape[0], W - 1, x.shape[-1])
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                  # (B, L+W-1, C)
    L = x.shape[1]
    y = sum(xp[:, i:i + L] * w[i] for i in range(W))
    new_state = xp[:, -(W - 1):] if W > 1 else pad[:, :0]
    return y + b, new_state


def _ssm_inputs(params, xin_c, b_c, c_c, dt_raw, cfg):
    """Common post-conv plumbing: activations + dt/decay computation."""
    xin_c = F.silu(xin_c)
    b_c = F.silu(b_c)
    c_c = F.silu(c_c)
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())   # (...,H)
    a = -torch.exp(params["a_log"].float())                        # (H,) < 0
    log_a = torch.clamp_min(dt * a, MIN_LOG_A)                     # (...,H)
    return xin_c, b_c, c_c, dt, log_a


def mamba_block(params, x, cfg: ModelConfig, cache=None):
    """x (B,L,D) -> (y (B,L,D), new_cache).

    cache: None (full sequence from scratch) or {"conv": (B,W-1,C),
    "ssm": (B,H,P,N)}; L may be 1 (decode) or more (prefill from the given
    states). With ``cfg.attn_impl == "kernel"`` a full-sequence scan goes to
    ``ops.ssd`` with impl=None: the CUDA kernel for CUDA tensors, its plain
    version for CPU tensors."""
    B, L, D = x.shape
    d_inner, H, P, G = mamba_dims(cfg)
    N = cfg.ssm_state
    cd = dtype_of(cfg.compute_dtype)

    zxbcdt = x @ params["in_proj"].to(cd)
    z, xin, b, c, dt_raw = _split_proj(zxbcdt, cfg)
    conv_in = torch.cat([xin, b, c], dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    conv_out, new_conv = _causal_conv(
        conv_in, params["conv_w"].to(cd), params["conv_b"].to(cd), conv_state)
    xin_c, b_c, c_c = torch.split(conv_out, [d_inner, G * N, G * N], dim=-1)
    xin_c, b_c, c_c, dt, log_a = _ssm_inputs(params, xin_c, b_c, c_c,
                                             dt_raw, cfg)

    if axisenv.resolve("model", H) is None:
        # on a mesh whose model axis cannot shard H heads, the reshapes
        # need the d_inner axis whole
        xin_c = axisenv.constrain(xin_c, "batch", None, None)
    xh = (xin_c.float().reshape(B, L, H, P) * dt[..., None]).to(cd)
    # on a mesh the scan runs on each rank's heads (the model axis)
    xh = axisenv.constrain(xh, "batch", None, "model", None)
    log_a = axisenv.constrain(log_a, "batch", None, "model")
    bg = b_c.reshape(B, L, G, N)
    cg = c_c.reshape(B, L, G, N)
    s0 = cache["ssm"] if cache is not None else None

    if L == 1 and cache is not None:
        y, s = ssd_ops.ssd_step(xh[:, 0], log_a[:, 0], bg[:, 0], cg[:, 0], s0)
        y = y[:, None]
    else:
        impl = None if cfg.attn_impl == "kernel" else "ref"
        y, s = ssd_ops.ssd(xh, log_a.to(cd), bg, cg, s0, impl=impl,
                           chunk=min(cfg.attn_chunk, 128))

    y = y.float() + (params["d_skip"].float()[:, None]
                     * xin_c.float().reshape(B, L, H, P))
    y = y.reshape(B, L, d_inner).to(cd)
    y = rmsnorm({"scale": params["norm"]}, y * F.silu(z), cfg.norm_eps)
    out = y @ params["out_proj"].to(cd)
    new_cache = {"conv": new_conv, "ssm": s} if cache is not None else None
    return out, new_cache


def init_mamba_cache(cfg: ModelConfig, batch: int, layers: int,
                     device="cuda"):
    """Decode states stacked over layers: conv (L, B, W-1, C) in the compute
    dtype and ssm (L, B, H, P, N) in f32 (DTensors under an axis
    environment)."""
    d_inner, H, P, G = mamba_dims(cfg)
    N, W = cfg.ssm_state, cfg.ssm_conv
    conv_ch = d_inner + 2 * G * N
    return {
        "conv": axisenv.zeros((layers, batch, W - 1, conv_ch),
                              None, "batch", None, "model",
                              dtype=dtype_of(cfg.compute_dtype),
                              device=device),
        "ssm": axisenv.zeros((layers, batch, H, P, N),
                             None, "batch", "model", None, None,
                             dtype=torch.float32, device=device),
    }
