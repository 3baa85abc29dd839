"""Mixture-of-Experts FFN with capacity-based dispatch: the port of
``repro/models/moe.py``.

Implementations, selected by ``cfg.moe_impl`` as in the JAX package:

- ``dropping`` (default): scatter/gather dispatch. Each batch row is a
  routing group: it scatters its token indices into an (E, C) slot table.
  The slots of all rows are gathered expert-major into (E, B*C, D), the
  per-expert FFN runs on them, and the results are gathered back. Tokens
  past an expert's capacity C are dropped (the residual stream passes them
  through). The JAX package keeps a batch-major (B, E, C, D) buffer and
  constrains it (experts over "model", batch rows over the data axes); on
  a mesh the port runs the same body in ``shard_map`` on each rank's rows
  and experts, and each output row is the same dot product either way.
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
    device, with no host sync. A DTensor ``x`` runs ``_dispatch_rows`` on
    each rank's rows in ``shard_map`` (``_dispatch_on_mesh``); a plain one
    runs it on the whole batch."""
    if hasattr(x, "device_mesh"):
        return _dispatch_on_mesh(params, x, cfg, expert_ffn, pass_live)
    return _dispatch_rows(x, params, cfg, expert_ffn, pass_live)


def _dispatch_rows(x, w, cfg: ModelConfig, expert_ffn, pass_live, *,
                   e0: int = 0, tokens: int | None = None, psum=None):
    """The dispatch of the rows of ``x`` (b, S, D) over all E experts, with
    the products of experts e0 .. e0 + e_loc only (e_loc the leading dim of
    ``w["wi_gate"]``). On one device that is all of ``dispatch``; in
    ``shard_map`` it is one rank's share. ``psum(t, over)`` sums t over
    the ranks that hold the other rows (over "batch": the aux loss's token
    and gate sums) or the other experts (over "model": the outputs);
    ``tokens`` is the token count of the whole batch (default: x's)."""
    b_loc, S, D = x.shape
    E = cfg.num_experts
    e_loc = w["wi_gate"].shape[0]
    C = _capacity(cfg, S)
    dev = x.device
    gates, topw, topi = _router(w, x, cfg)                    # (b,S,E/K)
    sums = torch.stack([
        F.one_hot(topi, E).float().sum(-2).reshape(-1, E).sum(0),
        gates.reshape(-1, E).sum(0)])
    if psum is not None:
        sums = psum(sums, "batch")
    sums = sums / (tokens or b_loc * S)
    aux = E * (sums[0] * sums[1]).sum()
    pos, keep = _route_positions(topi, cfg, C)
    slots = _slot_table(topi, pos, keep, E, C)[:, e0:e0 + e_loc]
    kw = {"live": (slots < S).any(2).any(0)} if pass_live else {}

    # slot (e, b*C + c) holds row b's token slots[b, e, c]; row b's zero
    # row sits at b*(S+1) + S of the flattened, padded tokens
    base = torch.arange(b_loc, device=dev)[:, None, None] * (S + 1)
    idx = (slots + base).transpose(0, 1).reshape(-1)
    xe = _with_zero_row(x, 1).reshape(-1, D)[idx]
    ye = expert_ffn(w, xe.reshape(e_loc, b_loc * C, D)
                    .to(dtype_of(cfg.compute_dtype)), cfg, **kw)

    mine = keep & (topi >= e0) & (topi < e0 + e_loc)
    b = torch.arange(b_loc, device=dev)[:, None, None]
    flat_idx = torch.where(mine, (topi - e0) * (b_loc * C) + b * C + pos,
                           e_loc * b_loc * C)
    y_sel = _with_zero_row(ye.reshape(e_loc * b_loc * C, D), 0)[
        flat_idx.reshape(b_loc, -1)]
    y = _combine(y_sel, topw, mine)
    if psum is not None:
        y = psum(y, "model")
    return y.to(x.dtype), aux


def _dispatch_on_mesh(params, x, cfg: ModelConfig, expert_ffn, pass_live):
    """``dispatch`` for a DTensor ``x`` (B, S, D) sharded over batch rows,
    in ``shard_map``: each rank routes its own rows over every expert (a
    row is a routing group, so its slots are those of the whole batch),
    runs the products of its own experts (those the "model" axis gives it,
    or all), and the partial outputs are summed over "model". The aux loss
    takes the token and gate sums of every row, summed over the batch
    axes. Collectives are autograd-aware where a gradient is wanted."""
    import torch.distributed as dist

    from repro_torch.distributed.compat import shard_map
    from repro_torch.distributed.sharding import P

    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    bax = tuple(a for a, p in zip(names, x.placements)
                if p.is_shard(0)) or None
    E = cfg.num_experts
    tp = mesh_axis_size(mesh, "model")
    em = ("model" if "model" in names and tp > 1 and E % tp == 0
          and "model" not in (bax or ()) else None)
    B, S, _ = x.shape

    def body(x_loc, router, wi_g, wi_u, wo):
        grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in (x_loc, router, wi_g, wi_u, wo))

        def psum(t, over):
            axes = (bax or ()) if over == "batch" else ((em,) if em else ())
            for a in axes:
                g = mesh.get_group(a)
                if grad:
                    import torch.distributed.nn.functional as dnf
                    t = dnf.all_reduce(t, group=g)
                else:
                    t = t.clone()
                    dist.all_reduce(t, group=g)
            return t

        e0 = mesh.get_local_rank("model") * wi_g.shape[0] if em else 0
        return _dispatch_rows(
            x_loc, {"router": router, "wi_gate": wi_g, "wi_up": wi_u,
                    "wo": wo}, cfg, expert_ffn, pass_live, e0=e0,
            tokens=B * S, psum=psum)

    fn = shard_map(body, mesh=mesh,
                   in_specs=(P(bax, None, None), P(None, None),
                             P(em, None, None), P(em, None, None),
                             P(em, None, None)),
                   out_specs=(P(bax, None, None), P()))
    return fn(x, *(params[k] for k in ("router", "wi_gate", "wi_up", "wo")))


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
