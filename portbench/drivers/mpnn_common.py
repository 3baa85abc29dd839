"""What the two MPNN drivers share: the molecule space of the
configuration, the surrogate's widths, and its weights drawn from the seed.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.gen import molecules
from portbench.reference import mpnn as ref

# The scale of each weight's draw (a standard normal times it). The biases
# are drawn too, so that a program that drops one shows.
SCALES = {"embed": lambda c: 1.0, "edge_w": lambda c: 0.05,
          "gru_wz": lambda c: (2 * c["hidden"]) ** -0.5,
          "gru_wr": lambda c: (2 * c["hidden"]) ** -0.5,
          "gru_wh": lambda c: (2 * c["hidden"]) ** -0.5,
          "ro_w1": lambda c: c["hidden"] ** -0.5, "ro_b1": lambda c: 0.1,
          "ro_w2": lambda c: c["readout_hidden"] ** -0.5,
          "ro_b2": lambda c: 0.1}

WIDTHS = ("num_atom_types", "num_bond_types", "hidden", "message_steps",
          "readout_hidden", "ensemble")


def space(config: dict, seed: int) -> molecules.MoleculeSpace:
    """The configuration's molecule space; which molecules it holds follows
    the seed (the generator takes a seed below 2**32)."""
    s = config["space"]
    return molecules.MoleculeSpace(
        num_molecules=s["num_molecules"], max_atoms=s["max_atoms"],
        num_atom_types=config["num_atom_types"],
        num_bond_types=config["num_bond_types"], seed=seed % (1 << 32))


def program_config(config: dict):
    from repro_torch.configs.mpnn_surrogate import MPNNConfig
    return MPNNConfig(**{k: config[k] for k in WIDTHS})


def draw_weights(config: dict, gen: torch.Generator, device) -> dict:
    """Every weight from one draw on ``device`` in float32, split by the
    reference's layout and scaled by ``SCALES``: {name: tensor}."""
    shapes = ref.param_shapes(config)
    sizes = [int(np.prod(s)) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    return {k: p.reshape(shapes[k]).mul(SCALES[k](config))
            for k, p in zip(shapes, flat.split(sizes))}


def to_numpy(weights: dict) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in weights.items()}


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy stream of the seed."""
    return np.random.default_rng([seed, stream])


class tf32:
    """TF32 matmuls inside the block (the control's precision)."""

    def __enter__(self):
        self.old = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.old
