"""Carry the JAX package's stacked surrogate parameters into the port.

The input is a flat dict of numpy arrays, e.g.
``jax.tree.map(np.asarray, repro.apps.electrolyte.Surrogate(cfg).params)``;
the output is a state dict for ``MPNNEnsemble`` that computes the same
function.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.mpnn_surrogate import MPNNConfig
from repro_torch.models.mpnn import param_shapes


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
