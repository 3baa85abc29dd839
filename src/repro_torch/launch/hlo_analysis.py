"""Collective traffic and roofline terms of a sharded program: the port of
``repro/launch/hlo_analysis.py`` (the name is kept so that a reader finds
the counterpart).

The JAX package parses the optimized HLO text of a compiled program. The
port has no HLO: it reads its own trace of the sharded program as it runs
(``launch/dryrun.py`` runs it on meta tensors over a fake process group).

- ``CollectiveRecorder``, a ``TorchDispatchMode``, records one
  ``(op, output bytes, group size)`` triple for every collective the
  program issues: the ``_c10d_functional`` ops DTensor's redistributions
  call and the ``c10d`` ops of explicit ``torch.distributed`` calls, each
  under the reference's op name (``all-reduce``, ``all-gather``,
  ``reduce-scatter``, ``all-to-all``, ``collective-permute``). It lets
  DTensor desugar first (it returns ``NotImplemented`` for DTensor
  arguments), so the collectives inside a DTensor op's dispatch are seen.
- ``collective_stats(records, total_devices)`` sums them into
  ``CollectiveStats`` with the reference's ring factors.
- ``DeviceFlopCounter`` counts one device's operations:
  ``torch.utils.flop_counter``'s count of each op, divided, for a DTensor
  op, by the number of ranks its output's ``Shard``/``Partial`` placements
  split it over (a replicated op counts whole on every device), plus what
  the kernels' meta implementations add (``kernels/dispatch.FLOP_SINKS``).

Roofline model (NVIDIA H100 SXM datasheet figures, H100 80GB HBM3, 700 W):
    compute    = FLOPs      / (chips * 989e12 FLOP/s bf16 dense)
    memory     = HBM bytes  / (chips * 3.35e12 B/s HBM3)
    collective = wire_bytes / 450e9 B/s of NVLink per direction

wire_bytes uses standard ring-algorithm factors: all-reduce moves
2*(n-1)/n of the tensor per device, the others (n-1)/n.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 SXM datasheet figures (H100 80GB HBM3, 700 W), per card; the
# port's one set, which the trainer's mfu and chip_smoke.py's bounds use too
PEAK_FLOPS = 989e12          # bf16 dense, tensor cores
F32_FLOPS = 67e12            # f32 outside the tensor cores
HBM_BW = 3.35e12             # bytes/s, HBM3
NVLINK_BW = 450e9            # bytes/s per direction (NVLink 4, 900 GB/s both)

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

# op name -> the reference's name: the functional collectives DTensor's
# redistributions call, and the c10d ops behind the explicit
# torch.distributed calls of the port (models/moe.py, models/moe_ep.py)
_FUNCTIONAL = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_C10D = {
    "allreduce_": "all-reduce", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "alltoall_base_": "all-to-all",
}


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(t) for t in x)
    return 0


def _group_size(args, kwargs) -> int | None:
    """The size of the process group named or passed among the args."""
    from torch._C._distributed_c10d import ProcessGroup
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in list(args) + list((kwargs or {}).values()):
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except Exception:             # not a group name
                continue
        if isinstance(a, torch.ScriptObject):
            try:
                return ProcessGroup.unbox(a).size()
            except RuntimeError:          # another class (a ReduceOp)
                continue
    return None


class CollectiveRecorder(TorchDispatchMode):
    """Records ``(op, output bytes, group size)`` of every collective run
    while it is active, in ``records``."""

    def __init__(self):
        super().__init__()
        self.records = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        op = (_FUNCTIONAL.get(name) if ns == "_c10d_functional"
              else _C10D.get(name) if ns == "c10d"
              else "all-to-all" if (ns, name) == ("_dtensor",
                                                  "shard_dim_alltoall")
              else None)
        if op is not None:
            if ns == "c10d":
                # in-place: the output is the first tensor argument(s)
                nbytes = _tensor_bytes(args[0])
            else:
                nbytes = _tensor_bytes(out)
            self.records.append((op, nbytes, _group_size(args, kwargs)))
        return out


@dataclass
class CollectiveStats:
    # op -> [count, tensor_bytes (per-device payload), wire_bytes]
    per_op: dict = field(default_factory=dict)

    @property
    def total_wire_bytes(self) -> float:
        return sum(v[2] for v in self.per_op.values())

    @property
    def total_tensor_bytes(self) -> float:
        return sum(v[1] for v in self.per_op.values())

    def as_dict(self):
        return {k: {"count": v[0], "tensor_bytes": v[1], "wire_bytes": v[2]}
                for k, v in self.per_op.items()}


def collective_stats(records, total_devices: int) -> CollectiveStats:
    """Sum ``(op, output bytes, group size)`` records of one device's
    program (a group size of None is the whole world)."""
    stats = CollectiveStats()
    for op, out_bytes, n in records:
        assert op in _COLLECTIVES, op
        n = n or total_devices
        if op == "all-reduce":
            wire = 2.0 * (n - 1) / max(n, 1) * out_bytes
        elif op == "all-gather":
            wire = (n - 1) / max(n, 1) * out_bytes      # output is gathered
        elif op == "reduce-scatter":
            wire = (n - 1) * out_bytes                  # output is the shard
        elif op == "all-to-all":
            wire = (n - 1) / max(n, 1) * out_bytes
        else:  # collective-permute
            wire = float(out_bytes)
        rec = stats.per_op.setdefault(op, [0, 0.0, 0.0])
        rec[0] += 1
        rec[1] += float(out_bytes)
        rec[2] += float(wire)
    return stats


class DeviceFlopCounter(TorchDispatchMode):
    """One device's operation count of the ops run while it is active
    (``flops``): see the module docstring."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0

    def _sink(self, n):
        self.flops += n

    def __enter__(self):
        from repro_torch.kernels import dispatch
        dispatch.FLOP_SINKS.append(self._sink)
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import dispatch
        dispatch.FLOP_SINKS.remove(self._sink)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            n = count(*args, **kwargs, out_val=out)
            lead = out[0] if isinstance(out, (tuple, list)) else out
            if isinstance(lead, DTensor):
                mesh = lead.device_mesh
                n /= math.prod(mesh.size(m) for m, p in
                               enumerate(lead.placements)
                               if p.is_shard() or p.is_partial())
            self.flops += n
        return out


def roofline_terms(*, flops: float, hbm_bytes: float, wire_bytes: float,
                   chips: int) -> dict:
    """Three roofline terms in seconds + the dominant bottleneck.

    flops / hbm_bytes are whole-program totals (one device's count scaled
    by chips); wire_bytes is per-device."""
    compute = flops / (chips * PEAK_FLOPS)
    memory = hbm_bytes / (chips * HBM_BW)
    collective = wire_bytes / NVLINK_BW
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    dominant = max(terms, key=terms.get)
    bound = max(compute, memory, collective)
    terms["dominant"] = dominant.replace("_s", "")
    terms["step_lower_bound_s"] = bound
    return terms
