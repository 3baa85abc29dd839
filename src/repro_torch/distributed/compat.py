"""``shard_map`` over ``torch.distributed.tensor.experimental.local_map``:
the port of ``repro/distributed/compat.py``.

``shard_map(f, mesh=, in_specs=, out_specs=)`` (specs are ``sharding.P``;
``out_specs`` one ``P`` or a tuple of them, as ``f`` returns) returns a function of
DTensors that redistributes each input to its spec (``sharding.placements``),
calls ``f`` on the local shards, and wraps ``f``'s outputs as DTensors of
their specs. ``f`` talks to the other ranks itself, through the mesh's
process groups. Gradients follow ``shard_map``'s transpose (the JAX
package calls it with ``check_vma=False``): an output's cotangent is divided
by the size of the mesh axes its spec does not name, and an input's
gradient is summed over the mesh axes its spec does not name (the input was
whole on each of those ranks, and each computed a part of its gradient).
"""
from __future__ import annotations

import math

import torch


class _ScaleGrad(torch.autograd.Function):
    """The identity, whose backward multiplies the gradient by ``scale``."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def shard_map(f, *, mesh, in_specs, out_specs):
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.sharding import P, placements

    def grad_placements(spec):
        return tuple(Partial() if p.is_replicate() else p
                     for p in placements(spec, mesh))

    single = isinstance(out_specs, P)
    specs = (out_specs,) if single else tuple(out_specs)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))

    def unnamed(spec):
        named = {a for e in spec
                 for a in ((e,) if isinstance(e, str) else e or ())}
        return math.prod(n for a, n in sizes.items() if a not in named)

    scales = [1.0 / unnamed(s) for s in specs]

    def body(*args):
        outs = f(*args)
        outs = (outs,) if single else outs
        outs = tuple(o if k == 1.0 else _ScaleGrad.apply(o, k)
                     for o, k in zip(outs, scales))
        return outs[0] if single else outs

    outs = tuple(placements(s, mesh) for s in specs)
    return local_map(
        body, out_placements=list(outs[0]) if single else outs,
        in_placements=tuple(placements(s, mesh) for s in in_specs),
        in_grad_placements=tuple(grad_placements(s) for s in in_specs),
        device_mesh=mesh, redistribute_inputs=True)
