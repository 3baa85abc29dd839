"""Carry the JAX package's parameters into the port.

``params_from_numpy`` takes the stacked surrogate parameters, a flat dict of
numpy arrays, e.g.
``jax.tree.map(np.asarray, repro.apps.electrolyte.Surrogate(cfg).params)``,
and returns a state dict for ``MPNNEnsemble`` that computes the same
function; ``params_to_numpy`` is its inverse. ``lm_params_from_numpy``
takes a language model's nested tree,
``jax.tree.map(np.asarray, repro.models.api.init_params(cfg, key))``, and
returns the same tree of tensors for ``repro_torch.models.api``.
``train_state_from_numpy`` carries a whole train state across, ``{"params",
"opt": AdamWState(step, m, v)}`` as numpy (the JAX state through
``jax.tree.map(np.asarray, ...)``), into the port's
``launch.steps`` state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.mpnn_surrogate import MPNNConfig
from repro_torch.models import api
from repro_torch.models.layers import ShapeMaker, dtype_of
from repro_torch.models.mpnn import param_shapes
from repro_torch.optim.adamw import AdamWState


def params_from_numpy(tree: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """Check names, shapes and dtypes against the MPNN layout (the widths are
    read from ``embed``, ``edge_w`` and ``ro_w1``) and raise ValueError on
    any mismatch; return the arrays as float32 tensors on ``device``."""
    names = list(param_shapes(MPNNConfig()))
    if set(tree) != set(names):
        raise ValueError(f"parameter names differ: missing "
                         f"{sorted(set(names) - set(tree))}, unexpected "
                         f"{sorted(set(tree) - set(names))}")
    arrays = {n: np.asarray(tree[n]) for n in names}
    for n, a in arrays.items():
        if a.dtype != np.float32:
            raise ValueError(f"{n}: dtype {a.dtype}, expected float32")
    embed, edge_w, ro_w1 = arrays["embed"], arrays["edge_w"], arrays["ro_w1"]
    if embed.ndim != 3 or edge_w.ndim != 3 or ro_w1.ndim != 3:
        raise ValueError("embed, edge_w and ro_w1 must be stacked (E, ., .)")
    E, atom_types, hidden = embed.shape
    cfg = MPNNConfig(num_atom_types=atom_types, num_bond_types=edge_w.shape[1],
                     hidden=hidden, readout_hidden=ro_w1.shape[2], ensemble=E)
    for n, shape in param_shapes(cfg).items():
        if arrays[n].shape != shape:
            raise ValueError(f"{n}: shape {arrays[n].shape}, expected {shape}")
    return {n: torch.tensor(a, device=device) for n, a in arrays.items()}


def params_to_numpy(module: torch.nn.Module) -> dict[str, np.ndarray]:
    """The stacked MPNN parameters of ``module`` as a flat dict of float32
    numpy arrays on the host, with the names and (E, ...) shapes of
    ``repro.models.mpnn.mpnn_params``: the inverse of
    ``params_from_numpy``."""
    names = param_shapes(MPNNConfig())
    state = module.state_dict()
    return {n: state[n].detach().to("cpu", torch.float32).numpy().copy()
            for n in names}


_NUMPY_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``, bit for bit. bf16 arrays
    (``ml_dtypes.bfloat16``, which ``torch.from_numpy`` rejects) go through
    an int16 view. The array is copied: the tensor never shares its
    memory."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def lm_params_from_numpy(tree: dict, cfg: ModelConfig, device) -> dict:
    """Check the nested tree's names, shapes and dtypes against the layout
    of ``cfg`` (dtype ``cfg.param_dtype``) and raise ValueError on any
    mismatch; return the same tree of tensors on ``device``."""
    want = api.model_params(ShapeMaker(dtype_of(cfg.param_dtype)), cfg)

    def walk(got, spec, path):
        if isinstance(spec, dict):
            if not isinstance(got, dict) or set(got) != set(spec):
                have = set(got) if isinstance(got, dict) else type(got).__name__
                raise ValueError(f"{path or '/'}: names {have}, expected "
                                 f"{set(spec)}")
            return {k: walk(got[k], spec[k], f"{path}/{k}") for k in spec}
        shape, dtype = spec
        a = np.asarray(got)
        if a.shape != shape:
            raise ValueError(f"{path}: shape {a.shape}, expected {shape}")
        if a.dtype.name != _NUMPY_DTYPE_NAMES[dtype]:
            raise ValueError(f"{path}: dtype {a.dtype.name}, expected "
                             f"{_NUMPY_DTYPE_NAMES[dtype]}")
        return tensor_from_numpy(a, device)

    return walk(tree, want, "")


def train_state_from_numpy(tree: dict, cfg: ModelConfig, device) -> dict:
    """``{"params", "opt"}`` with ``opt`` any (step, m, v) named tuple of
    numpy arrays (the JAX ``AdamWState``) -> the port's train state on
    ``device``, bit for bit: the params as ``lm_params_from_numpy`` checks
    them, m and v f32 trees of the params' shapes, step a 0-d int32."""
    params = lm_params_from_numpy(tree["params"], cfg, device)
    step, m, v = tree["opt"]
    step = np.asarray(step)
    if step.shape != () or step.dtype != np.int32:
        raise ValueError(f"opt/.step: {step.dtype} {step.shape}, expected a "
                         "0-d int32")
    f32 = cfg.replace(param_dtype="float32")
    return {"params": params, "opt": AdamWState(
        step=tensor_from_numpy(step, device),
        m=lm_params_from_numpy(m, f32, device),
        v=lm_params_from_numpy(v, f32, device))}
