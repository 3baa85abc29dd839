"""Logical-axis -> mesh-axis sharding rules (DP/TP/EP/FSDP/ZeRO): the port
of ``repro/distributed/sharding.py``.

Every parameter is annotated once with logical axis names by the model's
``*_params(mk, cfg)`` function (``SpecMaker``). This module resolves those
names to a concrete spec for a given mesh and mode:

- ``dp_tp``   : params replicated over (pod, data); tensor-parallel axes
                (vocab/ff/heads/experts/ssm channels) sharded over "model".
- ``fsdp_tp`` : dp_tp + the largest remaining unsharded axis of each big
                param additionally sharded over "data" (ZeRO-3 / FSDP).
- ``dp_only`` : no TP; every mesh axis is data parallel.

A mesh is read as its axis sizes (``axis_sizes``): a torch ``DeviceMesh``,
or an object whose ``shape`` maps names to sizes (``launch/mesh.py::
MeshShape``, like a JAX ``Mesh``). A spec, ``P``, is the
counterpart of ``PartitionSpec``: a tuple with one entry per tensor dim,
None (replicated), a mesh-axis name, or a tuple of names (the batch over
(pod, data)).
``placements`` turns one into DTensor placements on a ``DeviceMesh``.

Divisibility is checked per tensor: an axis whose size does not divide the
mesh axis falls back to replication (e.g. granite's single KV head).
"""
from __future__ import annotations

import math
from typing import Optional



class P(tuple):
    """A partition spec: ``P("data", None)`` is the tuple ("data", None).
    As in ``PartitionSpec``, an entry of one name is that name and an empty
    entry is None."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, tuple):
                return e[0] if len(e) == 1 else (e or None)
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


# logical axis -> preferred mesh axis (dp_tp mode)
TP_RULES = {
    "vocab": "model",
    "ff": "model",
    "heads": "model",
    "kv_heads": "model",
    "experts": "model",
    "ssm_inner": "model",
    "ssm_heads": "model",
    # everything else (embed, embed2, head_dim, layer, conv, state, lora,
    # ...) -> replicated
}

# axes eligible for the extra FSDP ("data") shard, in priority order
FSDP_AXES = ("embed", "embed2", "ff", "head_dim", "vocab", "experts")

# parameters smaller than this stay replicated in fsdp mode (norm scales,
# biases -- sharding them only adds collective launches)
FSDP_MIN_SIZE = 1 << 16


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a mesh, in the mesh's axis order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                          # torch DeviceMesh
        return dict(zip(names, (int(s) for s in mesh.shape)))
    return {k: int(v) for k, v in mesh.shape.items()}


def mesh_axis_size(mesh, name: Optional[str]) -> int:
    sizes = axis_sizes(mesh)
    return sizes[name] if name and name in sizes else 1


def spec_for(axes, shape, mesh, mode: str = "dp_tp"):
    """Resolve one parameter's logical axes to a spec.

    Modes: dp_tp (TP over "model"), fsdp_tp (dp_tp + FSDP over "data"),
    dp_only (no TP -- params replicated, every mesh axis is data parallel;
    the right choice for models far smaller than the pod)."""
    assert len(axes) == len(shape), (axes, shape)
    sizes = axis_sizes(mesh)
    used = set()
    out = [None] * len(axes)
    # pass 1: tensor-parallel assignment
    if mode != "dp_only":
        for i, (name, dim) in enumerate(zip(axes, shape)):
            m = TP_RULES.get(name)
            if m and m in sizes and m not in used and dim % sizes[m] == 0:
                out[i] = m
                used.add(m)
    # pass 2: FSDP extra shard over "data"
    if mode == "fsdp_tp" and "data" in sizes and \
            math.prod(shape) >= FSDP_MIN_SIZE:
        for pref in FSDP_AXES:
            done = False
            for i, (name, dim) in enumerate(zip(axes, shape)):
                if name == pref and out[i] is None and \
                        dim % sizes["data"] == 0 and "data" not in used:
                    out[i] = "data"
                    used.add("data")
                    done = True
                    break
            if done:
                break
    return P(*out)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def _shape_of(s):
    """A leaf of a shape tree: ``(shape, dtype)`` from ``ShapeMaker``, a
    tensor, or anything with ``.shape``."""
    if isinstance(s, tuple) and len(s) == 2 and isinstance(s[0], tuple):
        return s[0]
    return tuple(s.shape)


def tree_specs(spec_tree, shape_tree, mesh, mode: str = "dp_tp"):
    """Map ``spec_for`` over a (logical-axes tree, shape tree) pair of
    nested dicts."""
    if isinstance(spec_tree, dict):
        return {k: tree_specs(spec_tree[k], shape_tree[k], mesh, mode)
                for k in spec_tree}
    assert _is_axes(spec_tree), spec_tree
    return spec_for(spec_tree, _shape_of(shape_tree), mesh, mode)


# ---------------------------------------------------------------------------
# Batch / activation sharding
# ---------------------------------------------------------------------------


def batch_axes(mesh, global_batch: int, mode: str = "dp_tp"):
    """Greedy batch partitioning over (pod, data) -- plus "model" in
    dp_only mode, where the whole pod is data-parallel."""
    sizes = axis_sizes(mesh)
    names = ("pod", "data", "model") if mode == "dp_only" \
        else ("pod", "data")
    axes = []
    rem = global_batch
    for ax in names:
        if ax in sizes and rem % sizes[ax] == 0 and sizes[ax] > 1:
            axes.append(ax)
            rem //= sizes[ax]
    return tuple(axes)


def batch_spec(mesh, global_batch: int, extra_dims: int = 1):
    """Spec for a (B, ...) array: batch over (pod,data), rest None."""
    ax = batch_axes(mesh, global_batch)
    lead = ax if ax else None
    return P(lead, *([None] * extra_dims))


def cache_spec(axes, shape, mesh, global_batch: int):
    """KV-cache / state sharding: batch dim over (pod,data), model dims per
    TP rules. ``axes`` uses logical names with 'batch' marking the batch
    dim."""
    sizes = axis_sizes(mesh)
    out = []
    used = set()
    bax = batch_axes(mesh, global_batch)
    for name, dim in zip(axes, shape):
        if name == "batch" and bax and all(a not in used for a in bax):
            out.append(bax if len(bax) > 1 else bax[0])
            used.update(bax)
            continue
        m = TP_RULES.get(name)
        if m and m in sizes and m not in used and dim % sizes[m] == 0:
            out.append(m)
            used.add(m)
        else:
            out.append(None)
    return P(*out)


# ---------------------------------------------------------------------------
# ZeRO-1: optimizer-state sharding
# ---------------------------------------------------------------------------


def zero_spec(param_spec, shape, mesh):
    """Shard optimizer moments over "data" on the first free divisible dim
    (ZeRO-1). Keeps the param's own spec for the other dims."""
    sizes = axis_sizes(mesh)
    if "data" not in sizes or math.prod(shape) < FSDP_MIN_SIZE:
        return P(*param_spec)
    spec = list(param_spec) + [None] * (len(shape) - len(param_spec))
    if "data" in spec or ("pod", "data") in spec:
        return P(*param_spec)
    for i, (cur, dim) in enumerate(zip(spec, shape)):
        if cur is None and dim % sizes["data"] == 0:
            spec[i] = "data"
            return P(*spec)
    return P(*param_spec)


# ---------------------------------------------------------------------------
# Specs as DTensor placements
# ---------------------------------------------------------------------------


def placements(spec, mesh):
    """The DTensor placements of ``spec`` on a ``DeviceMesh``: ``Shard(i)``
    on each mesh dim that tensor dim i names, ``Replicate()`` on the rest.
    A tensor dim split over several mesh axes, e.g. ("pod", "data"), is
    split in mesh-axis order, major to minor, as a ``PartitionSpec``
    splits it."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(mesh.mesh_dim_names)
    index = {name: i for i, name in enumerate(mesh.mesh_dim_names)}
    for dim, entry in enumerate(spec):
        for name in ((entry,) if isinstance(entry, str) else entry or ()):
            out[index[name]] = Shard(dim)
    return tuple(out)
