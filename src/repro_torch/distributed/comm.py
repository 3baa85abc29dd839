"""Process groups for the port's multi-rank runs: ``init_world`` over gloo,
and ``stage_cuda_collectives``, the one wrapper through which DTensor's
collectives on CUDA tensors pass when the ranks share one card.

The single H100 cannot hold two NCCL ranks (NCCL refuses two ranks on one
device), so ranks that share the card talk over gloo. gloo takes CUDA
operands for the plain collectives (``all_to_all_single``, ``all_reduce``,
``all_gather_into_tensor``, ``reduce_scatter_tensor``; torch 2.11 on the
H100), but DTensor redistributes through the functional collectives
(``torch.ops._c10d_functional``), which reach
``allgather_into_tensor_coalesced``, and gloo refuses that for CUDA tensors.
``stage_cuda_collectives`` registers, for the CUDA dispatch key, kernels of
those functional collectives that ALWAYS copy the operand to the host, run
gloo's CPU collective on the group, and copy the result back. ``STAGED``
counts them and ``STAGED_S`` sums their seconds. Such a run's collectives
therefore cross the host: their times say nothing about an interconnect.
CPU ranks (the tests) need none of it.

    init_world(rank, world_size, "file:///tmp/rdv")
    stage_cuda_collectives()          # ranks that share the card only
"""
from __future__ import annotations

import datetime
import time

import torch
import torch.distributed as dist

# host-staged functional collectives, by op name: their count, and the
# seconds they took on the host clock (copies and gloo call included)
STAGED = {}
STAGED_S = {}
_LIB = []          # the torch.library registrations (kept alive)

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN, "product": dist.ReduceOp.PRODUCT}


def init_world(rank: int, world_size: int, init_method: str) -> None:
    """Join the default process group over gloo (rendezvous through
    ``init_method``, e.g. ``file://<path>``). A collective that waits two
    minutes for a peer raises."""
    dist.init_process_group("gloo", init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=120))


def _group(name):
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name)


def _count(name):
    STAGED[name] = STAGED.get(name, 0) + 1


def _timed(name, fn):
    """``fn``, its host seconds summed in ``STAGED_S[name]``."""
    def run(*args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            STAGED_S[name] = STAGED_S.get(name, 0.0) + (
                time.perf_counter() - t0)
    return run


def _reduce(h, op: str, group):
    """All-reduce host tensor ``h`` in place by the functional op's name."""
    if op == "avg":
        dist.all_reduce(h, dist.ReduceOp.SUM, group=group)
        h /= dist.get_world_size(group)
    else:
        dist.all_reduce(h, _OPS[op], group=group)
    return h


def _all_gather(x, group_size, group_name):
    _count("all_gather_into_tensor")
    h = x.detach().cpu().contiguous()
    out = h.new_empty((group_size * h.shape[0],) + tuple(h.shape[1:]))
    dist.all_gather_into_tensor(out, h, group=_group(group_name))
    return out.to(x.device)


def _reduce_scatter(x, op, group_size, group_name):
    _count("reduce_scatter_tensor")
    g = _group(group_name)
    h = _reduce(x.detach().cpu().contiguous().clone(), op, g)
    rank = dist.get_rank(g)
    return h.chunk(group_size)[rank].contiguous().to(x.device)


def _all_reduce(x, op, group_name):
    _count("all_reduce")
    h = _reduce(x.detach().cpu().contiguous().clone(), op, _group(group_name))
    return h.to(x.device)


def _all_to_all(x, out_splits, in_splits, group_name):
    _count("all_to_all_single")
    h = x.detach().cpu().contiguous()
    rows = sum(out_splits) if out_splits else h.shape[0]
    out = h.new_empty((rows,) + tuple(h.shape[1:]))
    dist.all_to_all_single(out, h, list(out_splits) or None,
                           list(in_splits) or None, group=_group(group_name))
    return out.to(x.device)


def stage_cuda_collectives() -> None:
    """Register the host-staging CUDA kernels of the functional
    collectives (see the module docstring). Idempotent."""
    if _LIB:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    impls = {
        "all_gather_into_tensor": _all_gather,
        "all_gather_into_tensor_coalesced":
            lambda xs, n, name: [_all_gather(x, n, name) for x in xs],
        "reduce_scatter_tensor": _reduce_scatter,
        "reduce_scatter_tensor_coalesced":
            lambda xs, op, n, name: [_reduce_scatter(x, op, n, name)
                                     for x in xs],
        "all_reduce": _all_reduce,
        "all_reduce_coalesced":
            lambda xs, op, name: [_all_reduce(x, op, name) for x in xs],
        "all_to_all_single": _all_to_all,
    }
    for name, fn in impls.items():
        lib.impl(name, _timed(name, fn), "CUDA")
    _LIB.append(lib)
