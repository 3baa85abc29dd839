"""Mesh definitions: the port of ``repro/launch/mesh.py``.

``make_mesh`` builds a torch ``DeviceMesh`` over the ranks of the default
process group (``init_process_group`` first). The production meshes, (16, 16)
and (2, 16, 16), cannot be built on one card, so ``make_production_mesh``
returns their shape as a ``MeshShape``, which ``distributed/sharding.py``
resolves specs against (and a dry run may size shards by).
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class MeshShape:
    """A mesh as its axis names and sizes, with no devices behind it.
    ``shape`` maps names to sizes, as a JAX ``Mesh``'s does."""
    sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def make_mesh(shape, names, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with axes ``names`` over the world's
    ranks in order (rank r at row-major position r)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """Single pod: (data=16, model=16) = 256 chips.
    Multi-pod: (pod=2, data=16, model=16) = 512 chips."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def make_host_mesh(device_type: str = "cuda"):
    """The degenerate (1, 1) mesh of one rank."""
    return make_mesh((1, 1), ("data", "model"), device_type)


def mesh_chips(mesh) -> int:
    from repro_torch.distributed.sharding import axis_sizes
    return math.prod(axis_sizes(mesh).values())
