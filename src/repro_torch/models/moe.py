"""Mixture-of-Experts FFN with capacity-based dispatch: the port of
``repro/models/moe.py``.

Implementations, selected by ``cfg.moe_impl`` as in the JAX package:

- ``dropping`` (default): scatter/gather dispatch. Each batch row is a
  routing group: it scatters its token indices into an (E, C) slot table.
  The slots of all rows are gathered expert-major into (E, B*C, D), the
  per-expert FFN runs on them, and the results are gathered back. Tokens
  past an expert's capacity C are dropped (the residual stream passes them
  through). The JAX package keeps a batch-major (B, E, C, D) buffer; the
  port's expert-major buffer takes the same sharding constraints (experts
  over "model", batch rows over the data axes) at the same points, and
  each output row is the same dot product either way.
- ``einsum``: the GShard one-hot dispatch/combine einsums; the same
  semantics as ``dropping`` at O(T*E*C*D) cost, for tiny shapes.
- ``dense``: every expert for every token, mixed by the router weights (no
  capacity, no drops); tiny configs only.
- ``gmm``: the dispatch of ``dropping`` with the three expert products in
  the grouped-matmul kernel (``kernels/moe_gmm/ops.py::expert_ffn``), one
  call per product on the untiled (E, D, F) weights.
- ``ep_a2a``: the expert-parallel all-to-all path of ``models/moe_ep.py``
  under an axis environment with a mesh; ``moe_dropping`` without one, at
  tp <= 1, or where S or E is not divisible by tp.

JAX drops out-of-range scatters and fills out-of-range gathers with zeros;
in PyTorch an index out of range is an error. So the slot table has one
overflow column (index C) that is sliced off, and gathers read an appended
zero row.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import axisenv
from repro_torch.distributed.sharding import mesh_axis_size
from repro_torch.models.layers import _lead, dtype_of
from repro_torch.models.mlp import _ACTS


def moe_params(mk, cfg: ModelConfig, stacked=()):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    lead = _lead(stacked)
    return {
        "router": mk.param(stacked + (d, e), lead + ("embed", "experts"),
                           fan_in=d),
        "wi_gate": mk.param(stacked + (e, d, f),
                            lead + ("experts", "embed", "ff"), fan_in=d),
        "wi_up": mk.param(stacked + (e, d, f),
                          lead + ("experts", "embed", "ff"), fan_in=d),
        "wo": mk.param(stacked + (e, f, d),
                       lead + ("experts", "ff", "embed"), fan_in=f),
    }


def _router(params, x, cfg: ModelConfig):
    """x (..., D) -> (gates (..., E) f32, topw (..., k), topi (..., k))."""
    logits = x.float() @ params["router"].float()
    gates = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(gates, cfg.num_experts_per_token, dim=-1)
    topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, topw, topi


def aux_load_balance_loss(gates, topi, num_experts: int):
    """Switch-style load-balancing loss: E * sum_e f_e * P_e."""
    oh = F.one_hot(topi, num_experts).float()                 # (...,k,E)
    frac_tokens = oh.sum(-2).reshape(-1, num_experts).mean(0)
    frac_prob = gates.reshape(-1, num_experts).mean(0)
    return num_experts * (frac_tokens * frac_prob).sum()


def _expert_ffn(params, xe, cfg: ModelConfig):
    """xe (E, C, D) -> (E, C, D); per-expert gated MLP."""
    cd = dtype_of(cfg.compute_dtype)
    g = torch.einsum("ecd,edf->ecf", xe, params["wi_gate"].to(cd))
    u = torch.einsum("ecd,edf->ecf", xe, params["wi_up"].to(cd))
    return torch.einsum("ecf,efd->ecd", _ACTS[cfg.act](g) * u,
                        params["wo"].to(cd))


def _capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    c = int(max(1, round(cfg.num_experts_per_token * tokens_per_group
                         / cfg.num_experts * cfg.capacity_factor)))
    if c > 128:
        c = -(-c // 128) * 128       # lane-friendly rounding when large
    return c


def _route_positions(topi, cfg: ModelConfig, capacity: int):
    """topi (..., S, K) expert ids -> (pos (..., S, K) slot in the expert,
    keep (..., S, K)), per group (the leading axes are independent groups).

    Assignment priority is k-slot major: every token's top-1 choice wins
    capacity before any token's top-2 choice, matching GShard."""
    S, K = topi.shape[-2:]
    lead = topi.shape[:-2]
    E = cfg.num_experts
    oh = F.one_hot(topi, E)                                   # (...,S,K,E)
    oh_km = oh.transpose(-3, -2).reshape(*lead, K * S, E)
    pos_km = oh_km.cumsum(-2) - oh_km
    pos = pos_km.reshape(*lead, K, S, E).transpose(-3, -2)    # (...,S,K,E)
    pos = (pos * oh).sum(-1)                                  # (...,S,K)
    return pos, pos < capacity


def _slot_table(topi, pos, keep, num_experts: int, capacity: int):
    """topi, pos, keep (B, S, K) -> (B, E, C) source-token index of every
    expert slot of every row; an empty slot holds S, the index of a zero row
    appended to the tokens. Dropped assignments are written to an overflow
    column C, which is sliced off."""
    B, S, K = topi.shape
    dev = topi.device
    slots = torch.full((B, num_experts, capacity + 1), S, dtype=torch.long,
                       device=dev)
    b = torch.arange(B, device=dev)[:, None, None].expand(B, S, K)
    tok = torch.arange(S, device=dev)[None, :, None].expand(B, S, K)
    slots[b, topi, torch.where(keep, pos, capacity)] = tok
    return slots[..., :capacity]


def _with_zero_row(t, dim: int):
    """t with one row of zeros appended along ``dim``."""
    shape = list(t.shape)
    shape[dim] = 1
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


def _combine(y_sel, topw, keep):
    """y_sel (B, S*K, D) expert outputs of every assignment (zeros where
    dropped) -> (B, S, D), weighted by the router weights and summed over
    the K choices."""
    B, S, K = topw.shape
    w = (topw * keep).reshape(B, S * K, 1).to(y_sel.dtype)
    return (y_sel * w).reshape(B, S, K, -1).sum(2)


def dispatch(params, x, cfg: ModelConfig, expert_ffn, *,
             pass_live: bool = False):
    """Scatter/gather dispatch around ``expert_ffn`` (params, xe (E, N, D),
    cfg) -> (E, N, D). x (B,S,D) -> (y (B,S,D), aux_loss). With
    ``pass_live``, expert_ffn also gets ``live`` (E,) bool: whether expert e
    holds a token in some row. The rows of an expert that holds none are all
    the zero row, and the kernel path skips it. It is computed on the
    device, with no host sync."""
    B, S, D = x.shape
    E = cfg.num_experts
    C = _capacity(cfg, S)
    gates, topw, topi = _router(params, x, cfg)               # (B,S,E/K)
    aux = aux_load_balance_loss(gates, topi, E)
    pos, keep = _route_positions(topi, cfg, C)
    slots = _slot_table(topi, pos, keep, E, C)                # (B,E,C)
    kw = {"live": (slots < S).any(2).any(0)} if pass_live else {}

    # slot (e, b*C + c) holds row b's token slots[b, e, c]; row b's zero
    # row sits at b*(S+1) + S of the flattened, padded tokens
    base = torch.arange(B, device=x.device)[:, None, None] * (S + 1)
    idx = (slots + base).transpose(0, 1).reshape(-1)
    xe = _with_zero_row(x, 1).reshape(-1, D)[idx]
    xe = axisenv.constrain(xe.reshape(E, B * C, D)
                           .to(dtype_of(cfg.compute_dtype)),
                           "model", "batch", None)
    ye = expert_ffn(params, xe, cfg, **kw)                    # (E,B*C,D)
    ye = axisenv.constrain(ye, "model", "batch", None)

    b = torch.arange(B, device=x.device)[:, None, None]
    flat_idx = torch.where(keep, topi * (B * C) + b * C + pos, E * B * C)
    y_sel = _with_zero_row(ye.reshape(E * B * C, D), 0)[
        flat_idx.reshape(B, -1)]
    y = axisenv.constrain(_combine(y_sel, topw, keep), "batch", None, None)
    return y.to(x.dtype), aux


def moe_dropping(params, x, cfg: ModelConfig):
    """Scatter/gather dispatch. x (B,S,D) -> (y (B,S,D), aux_loss)."""
    return dispatch(params, x, cfg, _expert_ffn)


def moe_einsum(params, x, cfg: ModelConfig):
    """GShard one-hot dispatch/combine einsums (oracle; tiny shapes only)."""
    B, S, D = x.shape
    E = cfg.num_experts
    C = _capacity(cfg, S)
    cd = dtype_of(cfg.compute_dtype)
    gates, topw, topi = _router(params, x, cfg)
    aux = aux_load_balance_loss(gates, topi, E)
    pos, keep = _route_positions(topi, cfg, C)
    ohf = F.one_hot(topi, E).float() * keep[..., None]        # (B,S,K,E)
    # one_hot of a position >= C is all zeros, as jax.nn.one_hot gives it
    slot = F.one_hot(pos.clamp(max=C), C + 1)[..., :C].float()  # (B,S,K,C)
    disp = torch.einsum("bske,bskc->bsec", ohf, slot)
    comb = torch.einsum("bske,bskc,bsk->bsec", ohf, slot, topw.float())
    xe = torch.einsum("bsd,bsec->ebcd", x.float(), disp).to(cd)
    ye = _expert_ffn(params, xe.reshape(E, B * C, D), cfg)
    y = torch.einsum("ebcd,bsec->bsd", ye.reshape(E, B, C, D).float(), comb)
    return y.to(x.dtype), aux


def moe_dense(params, x, cfg: ModelConfig):
    """Exact MoE: every expert for every token (tiny configs only)."""
    B, S, D = x.shape
    E = cfg.num_experts
    xt = x.reshape(B * S, D)
    gates, topw, topi = _router(params, xt, cfg)
    aux = aux_load_balance_loss(gates, topi, E)
    mix = (F.one_hot(topi, E).float() * topw[..., None]).sum(1)  # (T,E)
    xe = xt.expand(E, B * S, D).to(dtype_of(cfg.compute_dtype))
    ye = _expert_ffn(params, xe, cfg)                         # (E,T,D)
    y = torch.einsum("etd,te->td", ye.float(), mix)
    return y.reshape(B, S, D).to(x.dtype), aux


def moe_gmm(params, x, cfg: ModelConfig):
    """The dispatch of ``moe_dropping`` around the grouped-matmul kernel."""
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    return dispatch(params, x, cfg, gmm_ops.expert_ffn, pass_live=True)


def moe_ep(params, x, cfg: ModelConfig):
    """The shard_map expert-parallel all_to_all path; falls back to the
    scatter/gather path when the mesh/shape does not fit (no model axis, S
    or E not divisible, decode with S=1)."""
    env = axisenv._env()
    mesh = env.get("mesh") if env else None
    tp = mesh_axis_size(mesh, "model") if mesh is not None else 1
    if (mesh is None or tp <= 1 or x.shape[1] % tp
            or cfg.num_experts % tp):
        return moe_dropping(params, x, cfg)
    from repro_torch.models import moe_ep as ep
    return ep.moe_ep_a2a(params, x, cfg, mesh, env["batch"])


def moe_ffn(params, x, cfg: ModelConfig):
    impl = {"dropping": moe_dropping, "einsum": moe_einsum,
            "dense": moe_dense, "gmm": moe_gmm, "ep_a2a": moe_ep}
    return impl[cfg.moe_impl](params, x, cfg)
