"""Expert-parallel MoE over ``shard_map`` and explicit all-to-alls
(``moe_impl="ep_a2a"``): the port of ``repro/models/moe_ep.py``.

The canonical EP lowering moves only the routed token activations, twice:

  tokens (seq-sharded over the model axis)
    -> route locally -> per-destination-rank send buffers
    -> all_to_all over "model" (dispatch)
    -> local capacity dispatch to this rank's E/TP experts -> expert FFN
    -> results written back into the mirrored slot layout
    -> all_to_all back (combine) -> weighted sum per token.

The per-device capacities (``C_send`` of each rank->rank lane, ``C_e`` of
each local expert) and the slot order (``_positions_in_group``: assignment
order is index order) are the JAX package's, so the port drops exactly the
assignments it drops. Requires S % TP == 0 and E % TP == 0; ``models.moe``
falls back to ``moe_dropping`` otherwise.

The local experts run the port's expert FFN: the grouped-matmul kernel
(``kernels/moe_gmm/ops.py::expert_ffn``, at E/TP experts and C_e rows) when
the rows lie on the card and no gradient is wanted, else the plain FFN
(``models.moe._expert_ffn``), which autograd differentiates (the kernel has
no backward). Where a gradient flows, the all-to-alls and the aux loss's
mean are the autograd-aware collectives of ``torch.distributed.nn``.

On DTensors (the sharded train step) ``shard_map`` redistributes the inputs
to the specs below. Under an axis environment a plain tensor stands for a
value every rank holds whole; ``moe_ep_a2a`` takes its block, and for a
plain ``x`` gathers the output back whole (the EP prefill of one card's
ranks, whose expert weights are DTensors of their local experts and whose
other weights are plain).

JAX drops out-of-range scatters and fills out-of-range gathers with zeros;
here every slot table has an overflow column (or row) that is sliced off,
and gathers read an appended zero row.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.compat import shard_map
from repro_torch.kernels import dispatch
from repro_torch.models import moe as moe_mod

P = shd.P


def _round_up(x, m):
    return -(-x // m) * m


def _positions_in_group(group_ids, num_groups, capacity):
    """group_ids (A,) -> (pos (A,), keep (A,)): slot within each group,
    assignment order = index order."""
    oh = F.one_hot(group_ids, num_groups)                      # (A,G)
    pos = oh.cumsum(0) - oh
    pos = (pos * oh).sum(-1)
    return pos, pos < capacity


def capacities(cfg: ModelConfig, B: int, S: int, tp: int, dp: int):
    """(C_send, C_e): the rows of each rank->rank send lane and of each
    local expert, for a (B, S) batch over dp data ranks and tp model
    ranks."""
    E, K = cfg.num_experts, cfg.num_experts_per_token
    E_loc = E // tp
    T_loc = (B // dp) * (S // tp)                  # per-DEVICE tokens
    A = T_loc * K                                  # local assignments
    C_send = _round_up(int(A / tp * cfg.capacity_factor) + 1, 8)
    C_e = _round_up(int(tp * C_send / E_loc * cfg.capacity_factor) + 1, 8)
    return C_send, C_e


def local_expert_ffn(params, xe, cfg: ModelConfig, live):
    """This rank's experts on their rows xe (E_loc, C_e, D): the gmm kernel
    on the card when no gradient is wanted, else the plain FFN."""
    wants_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (xe, *params.values()))
    if dispatch.on_card(xe) and not wants_grad:
        from repro_torch.kernels.moe_gmm import ops as gmm_ops
        return gmm_ops.expert_ffn(params, xe, cfg, live=live)
    return moe_mod._expert_ffn(params, xe, cfg)


def _all_to_all(t, group, grad: bool):
    """Equal-split all_to_all of t's leading axis over ``group``."""
    if grad:
        import torch.distributed.nn.functional as dnf
        return dnf.all_to_all_single(torch.empty_like(t), t.contiguous(),
                                     group=group)
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t.contiguous(), group=group)
    return out


def moe_ep_a2a(params, x, cfg: ModelConfig, mesh, batch_axes):
    """x (B, S, D) -> (y, aux). Requires a mesh with a "model" axis
    dividing S and cfg.num_experts."""
    from torch.distributed.tensor import DTensor, Replicate

    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_token
    sizes = shd.axis_sizes(mesh)
    tp = sizes["model"]
    E_loc = E // tp
    S_loc = S // tp
    dp = 1
    for a in (batch_axes or ()):
        dp *= sizes[a]
    C_send, C_e = capacities(cfg, B, S, tp, dp)
    cd = moe_mod.dtype_of(cfg.compute_dtype)
    group = mesh.get_group("model")

    bax = tuple(batch_axes) if batch_axes else None
    in_specs = (
        P(bax, "model", None),                     # x: seq-sharded
        P(None, None),                             # router (replicated)
        P("model", None, None),                    # wi_gate
        P("model", None, None),                    # wi_up
        P("model", None, None),                    # wo
    )
    out_specs = (P(bax, "model", None), P())

    def body(x_loc, router, wi_g, wi_u, wo):
        # x_loc: (B_loc, S_loc, D) -- per-device block
        grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in (x_loc, router, wi_g, wi_u, wo))
        dev = x_loc.device
        b_loc = x_loc.shape[0]
        t_loc = b_loc * S_loc
        a_loc = t_loc * K
        xt = x_loc.reshape(t_loc, D)

        logits = xt.float() @ router.float()
        gates = torch.softmax(logits, dim=-1)
        topw, topi = torch.topk(gates, K, dim=-1)
        topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)

        # Switch aux loss over local tokens (mean of means == global mean)
        oh = F.one_hot(topi, E).float()
        aux = E * (oh.sum(1).mean(0) * gates.mean(0)).sum()

        # ---- dispatch: build per-destination-rank send lanes ----
        e_flat = topi.reshape(a_loc)                       # global expert id
        dest = e_flat // E_loc                             # owning rank
        pos, keep = _positions_in_group(dest, tp, C_send)
        tok = torch.arange(t_loc, device=dev)[:, None].expand(
            t_loc, K).reshape(a_loc)
        col = torch.where(keep, pos, C_send)               # C_send: dropped
        slot_tok = torch.full((tp, C_send + 1), t_loc, dtype=torch.long,
                              device=dev)
        slot_tok[dest, col] = tok
        slot_eid = torch.full((tp, C_send + 1), E_loc, dtype=torch.long,
                              device=dev)
        slot_eid[dest, col] = e_flat % E_loc
        slot_tok, slot_eid = slot_tok[:, :C_send], slot_eid[:, :C_send]

        send_x = moe_mod._with_zero_row(xt, 0)[slot_tok].to(cd)  # (tp,Cs,D)
        recv_x = _all_to_all(send_x.reshape(tp * C_send, D), group, grad)
        r_eid = _all_to_all(slot_eid.reshape(tp * C_send), group, False)

        # ---- local capacity dispatch to my E_loc experts ----
        valid = r_eid < E_loc
        row = torch.where(valid, r_eid, E_loc)
        epos, ekeep = _positions_in_group(row, E_loc + 1, C_e)
        ekeep = ekeep & valid
        eslot = torch.full((E_loc + 1, C_e + 1), tp * C_send,
                           dtype=torch.long, device=dev)
        eslot[row, torch.where(ekeep, epos, C_e)] = torch.arange(
            tp * C_send, device=dev)
        eslot = eslot[:E_loc, :C_e]
        xe = moe_mod._with_zero_row(recv_x, 0)[eslot]        # (E_loc,C_e,D)

        # ---- expert FFN (this rank's experts) ----
        ye = local_expert_ffn({"wi_gate": wi_g, "wi_up": wi_u, "wo": wo},
                              xe, cfg, (eslot < tp * C_send).any(1))

        # ---- write results back into the mirrored recv layout ----
        flat = torch.where(ekeep, torch.where(valid, r_eid, 0) * C_e + epos,
                           E_loc * C_e)
        back = moe_mod._with_zero_row(ye.reshape(E_loc * C_e, D), 0)[flat]
        ret = _all_to_all(back, group, grad)                 # (tp*Cs, D)

        # ---- combine ----
        a_idx = torch.where(keep, dest * C_send + pos, tp * C_send)
        y_sel = moe_mod._with_zero_row(ret, 0)[a_idx]        # (a_loc, D)
        w = (topw.reshape(a_loc, 1) * keep.reshape(a_loc, 1)).to(y_sel.dtype)
        y = (y_sel * w).reshape(t_loc, K, D).sum(1)
        # global mean over every rank of the mesh
        n = dist.get_world_size()
        if grad:
            import torch.distributed.nn.functional as dnf
            aux = dnf.all_reduce(aux) / n
        else:
            aux = aux.clone()
            dist.all_reduce(aux)
            aux = aux / n
        return y.reshape(b_loc, S_loc, D).to(x_loc.dtype), aux

    fn = shard_map(body, mesh=mesh, in_specs=in_specs, out_specs=out_specs)
    whole = not isinstance(x, DTensor)
    args = [x] + [params[k] for k in ("router", "wi_gate", "wi_up", "wo")]
    # a plain tensor is whole on every rank: shard_map takes its block
    rep = [Replicate()] * mesh.ndim
    args = [a if isinstance(a, DTensor)
            else DTensor.from_local(a, mesh, rep, run_check=False)
            for a in args]
    y, aux = fn(*args)
    if whole:
        return _gather_whole(y), aux.to_local()
    return y, aux


def _gather_whole(y):
    """The whole (B, S, D) of an output DTensor sharded over batch and
    sequence, on every rank, through the plain collectives."""
    out = y.to_local()
    mesh = y.device_mesh
    for i in reversed(range(mesh.ndim)):
        pl = y.placements[i]
        if not pl.is_shard():
            continue
        g = mesh.get_group(i)
        parts = [torch.empty_like(out) for _ in range(dist.get_world_size(g))]
        dist.all_gather(parts, out.contiguous(), group=g)
        out = torch.cat(parts, dim=pl.dim)
    return out
