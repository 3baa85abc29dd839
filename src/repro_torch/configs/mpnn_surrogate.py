"""The paper's own model: the MPNN-ensemble surrogate used by the
electrolyte-design application (§II-B: 16 MPNNs trained on QC results).

The port's own copy of ``repro.models.mpnn.MPNNConfig`` and of the values in
``repro.configs.mpnn_surrogate``."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class MPNNConfig:
    num_atom_types: int = 8
    num_bond_types: int = 4
    hidden: int = 64
    message_steps: int = 3
    readout_hidden: int = 128
    ensemble: int = 8


CONFIG = MPNNConfig(
    num_atom_types=8,
    num_bond_types=4,
    hidden=64,
    message_steps=3,
    readout_hidden=128,
    ensemble=16,             # the paper's ensemble size
)


def reduced() -> MPNNConfig:
    return dataclasses.replace(CONFIG, hidden=16, message_steps=2,
                               readout_hidden=32, ensemble=4)
