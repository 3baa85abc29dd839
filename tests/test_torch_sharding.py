"""The port's logical axes and sharding rules equal the JAX package's.

``api.param_specs`` for all 10 configs at published widths, leaf for leaf;
``spec_for``/``tree_specs`` (every param of every config), ``batch_axes``,
``batch_spec``, ``cache_spec`` and ``zero_spec`` over the meshes (1, 1),
(2, 4), (16, 16) and (2, 16, 16), in each mode and zero level, and the
train state's specs (``state_shardings``). The JAX side resolves over an
``AbstractMesh``: no devices. Pure Python; nothing is allocated."""
import itertools

import pytest
from jax.sharding import AbstractMesh

from repro.configs import base as jax_base
from repro.distributed import sharding as jax_shd
from repro.launch import steps as jax_steps
from repro.models import api as jax_api
from repro_torch.configs import base
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps
from repro_torch.launch.mesh import MeshShape, make_production_mesh, mesh_chips
from repro_torch.models import api

ARCHS = sorted(base.PORTED)
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
MODES = ("dp_tp", "fsdp_tp", "dp_only")


def _meshes(name):
    sizes, names = MESHES[name]
    return MeshShape(sizes, names), AbstractMesh(sizes, names)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _jax_leaves(tree):
    import jax
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple) and all(
            isinstance(a, (str, type(None))) for a in x))
    return {tuple(str(getattr(k, "key", k)) for k in p): v for p, v in flat}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch):
    got = dict(_leaves(api.param_specs(base.get_config(arch))))
    want = _jax_leaves(jax_api.param_specs(jax_base.get_config(arch)))
    assert got == want


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_tree_specs_equal_reference(arch, mode, mesh):
    port_mesh, jax_mesh = _meshes(mesh)
    cfg, jcfg = base.get_config(arch), jax_base.get_config(arch)
    got = dict(_leaves(shd.tree_specs(api.param_specs(cfg),
                                      api.abstract_params(cfg), port_mesh,
                                      mode)))
    want = jax_shd.tree_specs(jax_api.param_specs(jcfg),
                              jax_api.abstract_params(jcfg), jax_mesh, mode)
    import jax
    want = {tuple(str(getattr(k, "key", k)) for k in p): tuple(v)
            for p, v in jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}
    assert {k: tuple(v) for k, v in got.items()} == want


@pytest.mark.parametrize("zero", (0, 1))
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("mode", MODES)
def test_state_shardings_equal_reference(mode, mesh, zero):
    port_mesh, jax_mesh = _meshes(mesh)
    arch = "kimi-k2-1t-a32b"
    got = steps.state_shardings(base.get_config(arch), port_mesh,
                                base.ShardingConfig(mode=mode, zero=zero))
    want = jax_steps.state_shardings(
        jax_base.get_config(arch), jax_mesh,
        jax_base.ShardingConfig(mode=mode, zero=zero))
    for part in ("m", "v"):
        g = dict(_leaves(getattr(got["opt"], part)))
        w = {k: tuple(v.spec) for k, v in
             _jax_leaves(getattr(want["opt"], part)).items()}
        assert {k: tuple(v) for k, v in g.items()} == w
    g = dict(_leaves(got["params"]))
    w = {k: tuple(v.spec) for k, v in _jax_leaves(want["params"]).items()}
    assert {k: tuple(v) for k, v in g.items()} == w


SHAPES = [(3,), (256,), (4096, 512), (16, 4096), (6, 16, 2048, 128),
          (1 << 15, 3), (7, 16), (32, 1, 128)]
AXES = [("embed",), ("ff",), ("embed", "ff"), ("heads", "head_dim"),
        ("layer", "kv_heads", "embed", "head_dim"), ("vocab", "embed"),
        ("experts", "embed"), ("layer", "embed", "lora")]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("mode", MODES)
def test_spec_for_and_zero_spec_equal_reference(mode, mesh):
    port_mesh, jax_mesh = _meshes(mesh)
    for axes, shape in itertools.product(AXES, SHAPES):
        if len(axes) != len(shape):
            continue
        got = shd.spec_for(axes, shape, port_mesh, mode)
        want = jax_shd.spec_for(axes, shape, jax_mesh, mode)
        assert tuple(got) == tuple(want), (axes, shape)
        assert tuple(shd.zero_spec(got, shape, port_mesh)) == tuple(
            jax_shd.zero_spec(want, shape, jax_mesh)), (axes, shape)


CACHE_AXES = [("layer", "batch", "seq", "kv_heads", "head_dim"),
              ("layer", "batch", "heads", "head_dim", "head_dim2"),
              ("layer", "batch", "conv", "ssm_inner")]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("batch", (1, 8, 32, 512))
def test_batch_and_cache_specs_equal_reference(batch, mesh):
    port_mesh, jax_mesh = _meshes(mesh)
    for mode in MODES:
        assert shd.batch_axes(port_mesh, batch, mode) == \
            jax_shd.batch_axes(jax_mesh, batch, mode)
    for extra in (1, 2):
        assert tuple(shd.batch_spec(port_mesh, batch, extra)) == tuple(
            jax_shd.batch_spec(jax_mesh, batch, extra))
    for axes in CACHE_AXES:
        shape = (4, batch, 64, 16, 128)[:len(axes)]
        assert tuple(shd.cache_spec(axes, shape, port_mesh, batch)) == tuple(
            jax_shd.cache_spec(axes, shape, jax_mesh, batch))


def test_production_mesh_shapes():
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        assert mesh_chips(mesh) == (512 if multi else 256)
        assert shd.axis_sizes(mesh) == dict(
            zip(mesh.axis_names, mesh.sizes))


def test_placements_of_specs():
    """A spec's placements on a DeviceMesh-like object: Shard on each named
    mesh dim, mesh-axis order for a dim split over several."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 2, 2)

    assert shd.placements(shd.P(("pod", "data"), None, "model"), Mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert shd.placements(shd.P(None, "data"), Mesh) == (
        Replicate(), Shard(1), Replicate())
    assert shd.placements(shd.P(), Mesh) == (Replicate(),) * 3
