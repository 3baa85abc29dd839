"""The ML-Scorer's re-score: ``apps/electrolyte.py::rank_space`` over the
whole molecule space, back to back. Before each re-score every weight moves
by ``nudge`` times a standard normal from the seed (as a retrain would move
them) and is installed through ``Surrogate.load_numpy``.

Traffic parameters: ``kappa`` (UCB), ``nudge``, ``check_rescores`` (how many
of the window's re-scores the reference recomputes, drawn from the seed),
``stats_molecules`` (the targets' mean and std come from the oracle over
this many molecules), ``trace_seconds``.

``correct`` compares, for each re-score drawn, the program's UCB scores and
order with the reference's (``reference/mpnn.py``, float64):

- ``score_err``: the largest difference of a score, over the std of the
  reference's scores;
- ``order_gap``: the worst inversion of the program's order under the
  reference's scores (the largest s_ref[later] - s_ref[earlier]), over the
  same std.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench.drivers import mpnn_common as mc
from portbench.gen import molecules
from portbench.reference import mpnn as ref


def order_gap(order: np.ndarray, ref_scores: np.ndarray) -> float:
    """max over i < j of ref_scores[order[j]] - ref_scores[order[i]], at
    least 0: how far the order puts a better molecule behind a worse one."""
    s = ref_scores[np.asarray(order)]
    return float(max(0.0, np.max(s[1:] - np.minimum.accumulate(s)[:-1])))


def compare(scores, order, ref_scores) -> dict:
    scale = float(np.std(ref_scores))
    return {"score_err": float(np.max(np.abs(np.asarray(scores, np.float64)
                                              - ref_scores))) / scale,
            "order_gap": order_gap(order, ref_scores) / scale}


class Bench:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.config, self.traffic = cell.config, cell.traffic
        self.units: list = []          # (t0, t1) of each re-score
        self.kept: list = []           # (weights, scores, order) each
        self.attempted = self.failed = 0

    def setup(self, win) -> None:
        from repro_torch.apps import electrolyte

        self.electrolyte = electrolyte
        sp = mc.space(self.config, self.seed)
        self.feats = molecules.featurize(sp, range(sp.num_molecules))
        y = molecules.oracle_batch(sp, range(self.traffic["stats_molecules"]))
        self.y_mean, self.y_std = float(y.mean()), float(y.std())
        self.gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.weights = mc.draw_weights(self.config, self.gen, self.device)
        self.surrogate = electrolyte.Surrogate(
            mc.program_config(self.config), seed=0, device=self.device)
        self._install()
        electrolyte.rank_space(self.surrogate, self.feats,
                               self.traffic["kappa"])      # warm-up
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _install(self) -> dict:
        w = mc.to_numpy(self.weights)
        self.surrogate.load_numpy(w, self.y_mean, self.y_std)
        return w

    def run(self, win) -> None:
        kappa, nudge = self.traffic["kappa"], self.traffic["nudge"]
        while not win.expired():
            win.boundary()
            t0 = time.perf_counter()
            self.attempted += 1
            with torch.no_grad():
                for w in self.weights.values():
                    w.add_(torch.randn(w.shape, generator=self.gen,
                                       device=self.device), alpha=nudge)
            w_np = self._install()
            scores, order = self.electrolyte.rank_space(
                self.surrogate, self.feats, kappa)
            self.units.append((t0, time.perf_counter()))
            self.kept.append((w_np, scores, order))
        win.boundary()

    def release(self) -> None:
        self.surrogate = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def end_to_end(self, win) -> dict:
        wall = self.units[-1][1] - win.t0
        return {"rescore_ms": 1e3 * wall / len(self.units)}

    def context(self, win, trace) -> dict:
        return {"config": self.config, "trace": trace, "units": self.units,
                "win": win, "feats": self.feats,
                "untraced": [u for u in self.units
                             if win.in_untraced_part(u[0])]}

    def sampled(self) -> list:
        """Indices of the re-scores the reference recomputes."""
        n = len(self.kept)
        k = min(n, self.traffic["check_rescores"])
        return sorted(mc.rng(self.seed, 7).choice(n, size=k, replace=False))

    def check(self) -> dict:
        worst = {"score_err": 0.0, "order_gap": 0.0}
        with torch.no_grad():
            for i in self.sampled():
                w_np, scores, order = self.kept[i]
                s_ref = ref.rescore(w_np, self.feats, self.config, self.y_mean,
                                    self.y_std, self.traffic["kappa"],
                                    device=self.device)
                for k, v in compare(scores, order, s_ref).items():
                    worst[k] = max(worst[k], v)
        return {k: (v, self.cell.limits[k]) for k, v in worst.items()}

    def control(self) -> dict:
        """The readings of the control: the reference in float32 with TF32
        matmuls, the step below the configuration's float32, put in the
        program's place for the same re-scores."""
        worst = {"score_err": 0.0, "order_gap": 0.0}
        for i in self.sampled():
            w_np = self.kept[i][0]
            args = (w_np, self.feats, self.config, self.y_mean, self.y_std,
                    self.traffic["kappa"])
            s_ref = ref.rescore(*args, device=self.device)
            with mc.tf32():
                s_ctl = ref.rescore(*args, device=self.device,
                                    dtype=torch.float32)
            for k, v in compare(s_ctl, np.argsort(-s_ctl), s_ref).items():
                worst[k] = max(worst[k], v)
        return worst

    def close(self) -> None:
        pass
