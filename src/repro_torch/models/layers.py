"""Shared building blocks of the language models: the parameter makers,
norms, RoPE, the embedding and the token-level cross-entropy. The port of ``repro/models/layers.py``.

Every module defines its parameters once, in a ``*_params(mk, cfg)``
function, each with its logical axis names; the maker ``mk`` decides what
comes out: ``InitMaker`` draws tensors, ``ShapeMaker`` returns ``(shape,
dtype)`` so that ``convert.lm_params_from_numpy`` can check a tree against
the layout, and ``SpecMaker`` returns the logical axes, which
``distributed/sharding.py`` resolves to mesh axes.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


# Largest f32 draw, in elements: a larger parameter is drawn slice by slice.
# 2**26 holds one (5120, 8192) expert matrix of llama4-scout (42 M).
DRAW_ELEMS = 1 << 26


class InitMaker:
    """Draws parameters on ``device`` from ``generator``, with the scales of
    the JAX package's ``InitMaker.param``: a standard normal truncated to
    [-2, 2], times ``scale`` or 1/sqrt(fan_in), drawn in f32 and cast.

    A parameter of more than ``DRAW_ELEMS`` elements is drawn slice by slice
    along its leading axes into the preallocated result, so the f32
    temporary stays at one slice: a stacked (layers, experts, D, F) bf16
    expert weight would otherwise need twice its own size again in f32."""

    def __init__(self, generator: torch.Generator, dtype: torch.dtype, device):
        self.generator = generator
        self.dtype = dtype
        self.device = torch.device(device)

    def _draw(self, out, scale: float) -> None:
        """Fill ``out`` with scale * a truncated standard normal."""
        if out.numel() > DRAW_ELEMS and out.dim() > 1:
            row = out[0].numel()
            for part in (out if row > DRAW_ELEMS
                         else out.split(DRAW_ELEMS // row)):
                self._draw(part, scale)
            return
        t = torch.empty(out.shape, dtype=torch.float32, device=self.device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=self.generator)
        out.copy_(t.mul_(scale))

    def param(self, shape, axes=None, init="normal", scale=None,
              fan_in=None):
        del axes
        if init == "zeros":
            return torch.zeros(shape, dtype=self.dtype, device=self.device)
        if init == "ones":
            return torch.ones(shape, dtype=self.dtype, device=self.device)
        if init == "normal":
            if scale is None:
                fi = fan_in if fan_in is not None else (
                    shape[-2] if len(shape) >= 2 else shape[-1])
                scale = 1.0 / np.sqrt(max(fi, 1))
            out = torch.empty(shape, dtype=self.dtype, device=self.device)
            self._draw(out, float(scale))
            return out
        raise ValueError(init)


class ShapeMaker:
    """Returns ``(shape, dtype)`` for each parameter."""

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype

    def param(self, shape, axes=None, init="normal", scale=None,
              fan_in=None):
        del axes, init, scale, fan_in
        return tuple(shape), self.dtype


class SpecMaker:
    """Returns the logical-axis annotation of each parameter."""

    def param(self, shape, axes, init="normal", scale=None, fan_in=None):
        del init, scale, fan_in
        assert len(axes) == len(shape), f"axes {axes} vs shape {shape}"
        return tuple(axes)


def _lead(stacked):
    """The logical axes of a parameter's stacking dims."""
    return tuple("layer" for _ in stacked)


# ---------------------------------------------------------------------------
# Norms: computed in f32, cast back to the input's dtype
# ---------------------------------------------------------------------------


def rmsnorm_params(mk, dim, stacked=()):
    return {"scale": mk.param(stacked + (dim,), _lead(stacked) + ("embed",),
                              init="ones")}


def rmsnorm(params, x, eps):
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return (x * params["scale"].float()).to(dtype)


def rmsnorm_head(scale, x, eps):
    """Per-head RMS norm (qwen3 qk-norm): scale shape (head_dim,)."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings, split-half convention
# ---------------------------------------------------------------------------


def rope_freqs(head_dim, theta):
    exponent = np.arange(0, head_dim, 2, dtype=np.float32) / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim/2,)


def rope_cos_sin(positions, head_dim, theta, mrope_sections=None):
    """cos, sin (B, S, head_dim/2), float32.

    positions: (B, S) integers, or (3, B, S) for M-RoPE (temporal, height,
    width): frequency band i of ``mrope_sections`` turns with axis i."""
    inv = torch.as_tensor(rope_freqs(head_dim, theta), dtype=torch.float32,
                          device=positions.device)
    if mrope_sections is None:
        if positions.dim() == 3:
            positions = positions[0]
        ang = positions[..., None].float() * inv
    else:
        assert positions.dim() == 3, "M-RoPE needs (3,B,S) positions"
        assert sum(mrope_sections) == head_dim // 2, (mrope_sections, head_dim)
        bands = inv.split(list(mrope_sections))
        ang = torch.cat([positions[i][..., None].float() * band
                         for i, band in enumerate(bands)], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (B, S, H, head_dim); cos/sin (B, S, head_dim/2)."""
    dtype = x.dtype
    x = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embedding_params(mk, cfg: ModelConfig):
    p = {"embed": mk.param((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                           scale=1.0, fan_in=cfg.d_model)}
    if not cfg.tie_embeddings:
        p["unembed"] = mk.param((cfg.d_model, cfg.vocab_size),
                                ("embed", "vocab"))
    return p


def embed(params, tokens, cfg: ModelConfig):
    # F.embedding, not indexing: on the CPU its backward sums the rows of
    # repeated tokens in a fixed order, where indexing's accumulating
    # index_put does not
    from repro_torch.distributed import axisenv
    # on a mesh the lookup reads a replicated table: a gather from a
    # vocab-sharded one comes back as DTensor's masked partial sum, which
    # neither the norm that follows nor the backward takes
    table = axisenv.constrain(params["embed"], None, None)
    h = torch.nn.functional.embedding(tokens, table).to(
        dtype_of(cfg.compute_dtype))
    if cfg.emb_scale:
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype,
                             device=h.device)
    return h


def unembed(params, h, cfg: ModelConfig):
    from repro_torch.distributed import axisenv
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = axisenv.constrain(h @ w.to(h.dtype), "batch", None, "model")
    if cfg.final_logit_softcap:
        cap = cfg.final_logit_softcap
        logits = cap * torch.tanh(logits.float() / cap)
    return logits


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def softmax_cross_entropy(logits, labels, mask=None):
    """Token-level CE. logits (B,S,V) any float dtype; labels (B,S) integers.

    Computed in f32 with the logsumexp trick. Returns (mean_loss,
    token_count), both 0-d f32."""
    logits = logits.float()
    m = logits.amax(-1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.exp(logits - m).sum(-1))
    gold = torch.gather(logits, -1, labels.long()[..., None])
    # on a mesh: a gather from vocab-sharded logits is a masked partial
    # sum; reduce it before the squeeze (DTensor cannot after it)
    from repro_torch.distributed import axisenv
    gold = axisenv.constrain(gold, "batch", None, None)[..., 0]
    nll = lse - gold
    if mask is None:
        mask = torch.ones_like(nll)
    mask = mask.float()
    total = (nll * mask).sum()
    count = torch.clamp(mask.sum(), min=1.0)
    return total / count, count
