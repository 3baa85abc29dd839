"""How each kernel's ``ops`` wrapper picks between the hand-written kernel
and its plain version, shared by the five wrappers.

``impl=None`` picks the kernel for CUDA tensors and the plain version
("ref") for CPU tensors. The kernels write into tensors without autograd
history and have no backward, and neither have the Pallas kernels they
replace: a gradient through one would be silently missing. So a call that
resolves to the kernel raises while grad mode is on and an input requires
grad; training runs the plain versions (``attn_impl="ref"``,
``moe_impl="dropping"``), which autograd differentiates.

Meta tensors (the dry run, ``launch/dryrun.py``) resolve to "meta": the
wrapper returns empty outputs of the kernel's shapes and adds the kernel's
operation count, the bound column's count of ``PERF.md``, to every counter
in ``FLOP_SINKS``.

A hand-written kernel cannot take a DTensor. When a wrapper's inputs are
DTensors (a sharded program), ``run_local`` runs the resolved
implementation on each rank's local shards through ``compat.shard_map``,
where the sharded dims are the op's independent axes (batch and heads for
attention and the scans, experts for gmm); any other placement raises.
"""
from __future__ import annotations

import torch

# callables fed the operation count of every meta launch (dry run)
FLOP_SINKS: list = []


def on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def add_flops(n: float) -> None:
    for sink in FLOP_SINKS:
        sink(float(n))


def resolve(impl, name: str, lead: torch.Tensor, *inputs) -> str:
    """The implementation to run: ``impl``, or the default for ``lead``'s
    device ("meta" for meta tensors, whose kernel is a shape and a count).
    Raises when the kernel is asked to take part in a gradient, or to run
    on CPU tensors."""
    if lead.is_meta and impl in (None, "kernel"):
        impl = "meta"
    if impl is None:
        impl = "kernel" if on_card(lead) else "ref"
    if impl not in ("kernel", "meta"):
        return impl
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in (lead,) + inputs):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward (nor has the JAX "
            "package's Pallas kernel), so a gradient through it would be "
            "silently missing; differentiate through the plain version, "
            "impl='ref' (attn_impl='ref' and moe_impl='dropping' in a model "
            "config)")
    if impl == "kernel" and not lead.is_cuda:
        raise ValueError("impl='kernel' needs CUDA tensors; "
                         "use impl='ref' on the CPU")
    return impl


def sharded(*tensors) -> bool:
    from torch.distributed.tensor import DTensor
    return any(isinstance(t, DTensor) for t in tensors)


def run_local(name: str, fn, args, roles, out_roles):
    """``fn`` on each rank's local shards of ``args`` (tensors, DTensors or
    None), as DTensor outputs.

    ``roles[i]`` maps the independent axes of input i to its dims, e.g.
    {"batch": 0, "heads": 2}; ``out_roles`` does the same for each output
    of ``fn``, with its rank under "ndim" (a tuple of dicts when ``fn``
    returns a tuple). On each mesh
    axis every input must be replicated or sharded on the dim of one role,
    the same role for all; an input that has that role and is replicated
    takes its local slice (no communication), and one without it must be
    replicated. A plain tensor is whole on every rank (replicated)."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.distributed.compat import shard_map
    from repro_torch.distributed.sharding import P

    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    names = mesh.mesh_dim_names
    rep = (Replicate(),) * len(names)
    where = {}                               # mesh axis -> role
    for m, axis in enumerate(names):
        for t, r in zip(args, roles):
            if t is None:
                continue
            p = t.placements[m] if isinstance(t, DTensor) else Replicate()
            if p.is_replicate():
                continue
            role = next((k for k, d in r.items()
                         if p.is_shard() and p.dim == d), None)
            if role is None or where.get(axis, role) != role:
                got = [tuple(a.placements) if isinstance(a, DTensor)
                       else None for a in args]
                raise ValueError(
                    f"{name}: no per-shard form for placements {got} on "
                    f"mesh axes {names} (independent axes: {roles})")
            where[axis] = role

    def spec(r, ndim):
        return P(*[tuple(a for a in names if where.get(a) is not None
                         and r.get(where[a]) == d) or None
                   for d in range(ndim)])

    present = [i for i, t in enumerate(args) if t is not None]
    in_specs = [spec(roles[i], args[i].ndim) for i in present]
    single = isinstance(out_roles, dict)
    outs = (out_roles,) if single else tuple(out_roles)

    def body(*local):
        full = [None] * len(args)
        for i, t in zip(present, local):
            full[i] = t
        return fn(*full)

    out_specs = [spec({k: d for k, d in r.items() if k != "ndim"},
                      r["ndim"]) for r in outs]
    call = shard_map(body, mesh=mesh, in_specs=in_specs,
                     out_specs=out_specs[0] if single else tuple(out_specs))
    dargs = [args[i] if isinstance(args[i], DTensor)
             else DTensor.from_local(args[i], mesh, rep, run_check=False)
             for i in present]
    return call(*dargs)
