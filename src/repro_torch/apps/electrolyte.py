"""The serving half of the electrolyte application's learned assay (port of
``repro/apps/electrolyte.py``).

After every model update the campaign's ML-Scorer/ML-Recorder re-scores the
whole molecule space: the MPNN ensemble predicts every molecule, UCB turns
the (E, B) predictions into scores, and the queue is reordered by score.
``Surrogate.predict`` and ``rank_space`` are that path. Training, the
Thinker and ``run_campaign`` are not ported yet.

At full width the message step's edge tensor is E*N*N*Hd*Hd floats per
molecule (64 MiB at E=16, N=16, Hd=64, f32), so ``predict`` scores the space
in molecule chunks sized by ``EDGE_BYTES_BUDGET``. Chunking changes memory use
only, not the result.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.mpnn_surrogate import MPNNConfig
from repro_torch.core.policies import ucb_scores
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.mpnn import MPNNEnsemble

EDGE_BYTES_BUDGET = 8 << 30   # bytes of edge tensor per chunk


class Surrogate:
    """MPNN ensemble with standardized targets; predictions are returned in
    the targets' units."""

    def __init__(self, cfg: MPNNConfig, seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = MPNNEnsemble(cfg, torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        self.y_mean, self.y_std = 0.0, 1.0

    def load_numpy(self, params: dict[str, np.ndarray], y_mean: float,
                   y_std: float) -> None:
        """Install stacked numpy parameters (names and shapes of
        ``repro.models.mpnn.mpnn_params``) and the target standardization."""
        self.model.load_state_dict(params_from_numpy(params, self.device))
        self.y_mean, self.y_std = float(y_mean), float(y_std)

    def chunk_size(self, n_atoms: int) -> int:
        """Molecules per chunk whose edge tensor fits EDGE_BYTES_BUDGET."""
        cfg = self.cfg
        per_mol = (cfg.ensemble * n_atoms ** 2 * cfg.hidden ** 2
                   * self.model.embed.element_size())
        return max(1, EDGE_BYTES_BUDGET // per_mol)

    def predict(self, feats) -> np.ndarray:
        """feats {"atoms","bonds","mask"} for B molecules -> (E, B) numpy
        predictions, de-standardized."""
        atoms, bonds, mask = (torch.as_tensor(np.asarray(feats[k]),
                                              device=self.device)
                              for k in ("atoms", "bonds", "mask"))
        chunk = self.chunk_size(atoms.shape[1])
        with torch.inference_mode():
            preds = torch.cat([
                self.model(atoms[s:s + chunk], bonds[s:s + chunk],
                           mask[s:s + chunk])
                for s in range(0, atoms.shape[0], chunk)], dim=1)
        return preds.cpu().numpy() * self.y_std + self.y_mean

    def mae(self, feats, y) -> float:
        return float(np.mean(np.abs(self.predict(feats).mean(0) - y)))


def rank_space(surrogate: Surrogate, feats, kappa: float = 2.0):
    """ML-Recorder re-score: UCB over the whole space and the queue order
    (best first). Returns (scores (B,), order (B,))."""
    scores = ucb_scores(surrogate.predict(feats), kappa)
    return scores, np.argsort(-scores)
