"""Ambient activation-sharding environment: the port of
``repro/distributed/axisenv.py``.

Model code is mesh-agnostic; the step builder (``launch/steps.build_program``)
installs this environment around a step so that models can pin key
activations with logical constraints:

    x = axisenv.constrain(x, "batch", None, "model", None)

Logical names: "batch" -> the (pod, data) axes the batch is split over,
"model"/"kv" -> the tensor-parallel axis (dropped per-tensor when the
dimension is not divisible). ``constrain`` redistributes a DTensor to the
resolved placements (``with_sharding_constraint``'s meaning: the value is
unchanged, its layout is pinned). Without an installed environment, or on a
plain tensor, it is the identity, so every single-device path is unchanged.
Under an environment a plain tensor stands for a value that every rank holds
whole (replicated).

``zeros`` allocates a decode cache or state the same way: whole, except
under the environment of a sharded program, where it is a DTensor at the
resolved placements of which each rank allocates only its own shard.

Pinning these points gives DTensor's sharding propagation the part GSPMD
plays in the JAX package, and gives an op that DTensor has no strategy for
a placement that it has.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

_tls = threading.local()


def _env():
    return getattr(_tls, "env", None)


@contextmanager
def activation_axes(*, batch=(), batch_sizes=(), model=None, model_size=1,
                    mesh=None, sharded=False):
    """batch: tuple of mesh axis names; model: mesh axis name or None;
    mesh: the DeviceMesh (needed by shard_map-based layers and by
    ``constrain``); sharded: the activations are DTensors (a
    ``launch/steps.build_program`` step), so ``zeros`` allocates caches as
    DTensors too."""
    prev = _env()
    _tls.env = {
        "batch": tuple(batch), "batch_size": int(_prod(batch_sizes)),
        "model": model, "model_size": int(model_size), "mesh": mesh,
        "sharded": sharded,
    }
    try:
        yield
    finally:
        _tls.env = prev


def current():
    """The installed environment (None without one), for ``installed``."""
    return _env()


@contextmanager
def installed(env):
    """Install an environment ``current`` returned, on this thread: the
    recompute of a rematerialised block, which autograd may run on its own
    device thread, sees the forward's axes."""
    prev = _env()
    _tls.env = env
    try:
        yield
    finally:
        _tls.env = prev


def _prod(xs):
    out = 1
    for x in xs:
        out *= x
    return out


def resolve(logical, dim: int):
    env = _env()
    if env is None or logical is None:
        return None
    if logical == "batch":
        if env["batch"] and dim % env["batch_size"] == 0:
            ax = env["batch"]
            return ax if len(ax) > 1 else ax[0]
        return None
    if logical in ("model", "kv", "seq"):
        # "seq": sequence-parallel residual sharding also lands on the
        # model axis (between-block tokens are independent across TP ranks)
        if env["model"] and dim % env["model_size"] == 0:
            return env["model"]
        return None
    raise ValueError(logical)


def constrain(x, *logical):
    """Redistribute a DTensor to the placements resolved from logical
    names. The identity when no environment is installed or ``x`` is a
    plain tensor."""
    from torch.distributed.tensor import DTensor

    env = _env()
    if env is None or not isinstance(x, DTensor):
        return x
    from repro_torch.distributed import sharding

    assert len(logical) == x.ndim, (logical, x.shape)
    spec = tuple(resolve(l, d) for l, d in zip(logical, x.shape))
    return x.redistribute(env["mesh"], sharding.placements(spec, env["mesh"]))


def zeros(shape, *logical, dtype, device):
    """``torch.zeros(shape)``; under the environment of a sharded program, a
    DTensor of zeros at the placements resolved from the logical names (as
    ``constrain`` resolves them), each rank allocating only its own shard."""
    import torch

    env = _env()
    if env is None or not env["sharded"]:
        return torch.zeros(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    from repro_torch.distributed import sharding

    assert len(logical) == len(shape), (logical, shape)
    mesh = env["mesh"]
    pl = sharding.placements(
        tuple(resolve(l, d) for l, d in zip(logical, shape)), mesh)
    local, _ = compute_local_shape_and_global_offset(shape, mesh, pl)
    t = torch.zeros(local, dtype=dtype, device=device)
    return DTensor.from_local(t, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())
