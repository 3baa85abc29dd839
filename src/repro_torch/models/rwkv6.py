"""RWKV6 "Finch" block: token-shift time mix with data-dependent decay (WKV
recurrence in ``repro_torch.kernels.rwkv6_scan``) + channel mix FFN. The
port of ``repro/models/rwkv6.py``, with its simplifications against the
released RWKV6: the five token-shift mixing coefficients are static learned
vectors (the low-rank data-dependent part drives only the decay), the decay
LoRA has rank ``RWKV_LORA``, and ``ln_x`` is an RMS norm over the whole
d_model, not a per-head GroupNorm.

The dtype casts are the JAX package's: projections in the compute dtype,
the decay ``w_raw`` in f32 and ``log_w = max(-exp(w_raw), MIN_LOG_W)``; a
full-sequence pass hands the scan that log decay in the compute dtype, the
decode step takes the f32 one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import axisenv
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.models.layers import _lead, dtype_of, rmsnorm

MIN_LOG_W = -12.0
RWKV_LORA = 64


def rwkv_dims(cfg: ModelConfig):
    K = cfg.rwkv_head_size
    H = cfg.d_model // K
    return H, K


def rwkv_time_mix_params(mk, cfg: ModelConfig, stacked=()):
    d = cfg.d_model
    H, K = rwkv_dims(cfg)
    lead = _lead(stacked)
    p = {}
    for name in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w"):
        p[name] = mk.param(stacked + (d,), lead + ("embed",), init="zeros")
    for name in ("wr", "wk", "wv", "wg", "wo"):
        p[name] = mk.param(stacked + (d, d), lead + ("embed", "embed2"),
                           fan_in=d)
    p["w0"] = mk.param(stacked + (d,), lead + ("embed",), init="zeros")
    p["w_lora_a"] = mk.param(stacked + (d, RWKV_LORA),
                             lead + ("embed", "lora"), fan_in=d)
    p["w_lora_b"] = mk.param(stacked + (RWKV_LORA, d),
                             lead + ("lora", "embed"), scale=0.01)
    p["u"] = mk.param(stacked + (H, K), lead + ("heads", "head_dim"),
                      init="zeros")
    p["ln_x"] = mk.param(stacked + (d,), lead + ("embed",), init="ones")
    return p


def rwkv_channel_mix_params(mk, cfg: ModelConfig, stacked=()):
    d, f = cfg.d_model, cfg.d_ff
    lead = _lead(stacked)
    return {
        "mu_k": mk.param(stacked + (d,), lead + ("embed",), init="zeros"),
        "wk": mk.param(stacked + (d, f), lead + ("embed", "ff"), fan_in=d),
        "wv": mk.param(stacked + (f, d), lead + ("ff", "embed"), fan_in=f),
    }


def _token_shift(x, prev):
    """shifted[t] = x[t-1]; position 0 takes ``prev`` (B,1,D) or zeros."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu            # lerp between current and shifted


def rwkv_time_mix(params, x, cfg: ModelConfig, cache=None):
    """x (B,L,D) -> (y, new_cache); cache = {"shift": (B,1,D), "state":
    (B,H,K,K)}. With ``cfg.attn_impl == "kernel"`` a full-sequence scan goes
    to ``ops.wkv6`` with impl=None: the CUDA kernel for CUDA tensors, its
    plain version for CPU tensors. One token against a cache takes the
    decode step."""
    B, L, D = x.shape
    H, K = rwkv_dims(cfg)
    cd = dtype_of(cfg.compute_dtype)
    xs = _token_shift(x, cache["shift"] if cache is not None else None)

    def proj(name):
        return _mix(x, xs, params["mu_" + name[1]]) @ params[name].to(cd)

    def heads(t):
        """(B, L, D) -> (B, L, H, K); on a mesh, each rank's heads (the
        model axis), from a form whose D axis is whole (D is split into
        heads only where the heads divide the axis)."""
        t = axisenv.constrain(t, "batch", None, None)
        return axisenv.constrain(t.reshape(B, L, H, K),
                                 "batch", None, "model", None)

    r = heads(proj("wr"))
    k = heads(proj("wk"))
    v = heads(proj("wv"))
    g = F.silu(proj("wg"))

    # data-dependent decay (the Finch contribution): w = exp(-exp(...))
    xw = _mix(x, xs, params["mu_w"])
    lora = torch.tanh(xw @ params["w_lora_a"].to(cd)) @ params["w_lora_b"].to(cd)
    w_raw = params["w0"].float() + lora.float()
    log_w = heads(torch.clamp_min(-torch.exp(w_raw), MIN_LOG_W))

    state = cache["state"] if cache is not None else None
    if L == 1 and cache is not None:
        y, s = wkv_ops.wkv6_step(r[:, 0], k[:, 0], v[:, 0], log_w[:, 0],
                                 params["u"], state)
        y = y[:, None]
    else:
        impl = None if cfg.attn_impl == "kernel" else "ref"
        y, s = wkv_ops.wkv6(r, k, v, log_w.to(cd), params["u"], state,
                            impl=impl, chunk=min(cfg.attn_chunk, 64))

    y = y.reshape(B, L, D)
    y = rmsnorm({"scale": params["ln_x"]}, y, cfg.norm_eps) * g
    out = y @ params["wo"].to(cd)
    new_cache = None
    if cache is not None:
        new_cache = {"shift": x[:, -1:], "state": s}
    return out, new_cache


def rwkv_channel_mix(params, x, cfg: ModelConfig, cache=None):
    """Squared-ReLU channel mix; cache = {"shift": (B,1,D)}."""
    cd = dtype_of(cfg.compute_dtype)
    xs = _token_shift(x, cache["shift"] if cache is not None else None)
    kx = _mix(x, xs, params["mu_k"])
    h = torch.relu(kx @ params["wk"].to(cd)).square()
    out = h @ params["wv"].to(cd)
    new_cache = {"shift": x[:, -1:]} if cache is not None else None
    return out, new_cache


def init_rwkv_cache(cfg: ModelConfig, batch: int, layers: int, device="cuda"):
    """Decode states stacked over layers: the two token shifts (L, B, 1, D)
    in the compute dtype and the WKV state (L, B, H, K, K) in f32 (DTensors
    under an axis environment)."""
    H, K = rwkv_dims(cfg)
    dt = dtype_of(cfg.compute_dtype)
    shift = (layers, batch, 1, cfg.d_model)
    return {
        "tm_shift": axisenv.zeros(shift, None, "batch", None, None, dtype=dt,
                                  device=device),
        "cm_shift": axisenv.zeros(shift, None, "batch", None, None, dtype=dt,
                                  device=device),
        "state": axisenv.zeros((layers, batch, H, K, K),
                               None, "batch", "model", None, None,
                               dtype=torch.float32, device=device),
    }
