"""Dense gated MLP (SwiGLU / GeGLU). The port of ``repro/models/mlp.py``."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import axisenv
from repro_torch.models.layers import _lead, dtype_of

# jax.nn.gelu defaults to the tanh approximation
_ACTS = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
         "relu": F.relu}


def mlp_params(mk, cfg: ModelConfig, stacked=(), d_ff=None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    lead = _lead(stacked)
    return {
        "wi_gate": mk.param(stacked + (d, f), lead + ("embed", "ff"), fan_in=d),
        "wi_up": mk.param(stacked + (d, f), lead + ("embed", "ff"), fan_in=d),
        "wo": mk.param(stacked + (f, d), lead + ("ff", "embed"), fan_in=f),
    }


def mlp(params, x, cfg: ModelConfig):
    """The JAX package fuses the gate and up matmuls along a new leading
    axis; two matmuls give the same values."""
    cd = dtype_of(cfg.compute_dtype)
    g = x @ params["wi_gate"].to(cd)
    u = x @ params["wi_up"].to(cd)
    h = axisenv.constrain(_ACTS[cfg.act](g) * u, "batch", None, "model")
    out = h @ params["wo"].to(cd)
    return axisenv.constrain(out, "batch",
                             "seq" if cfg.seq_parallel else None, None)
