"""The paper's molecular-design application (port of
``repro/apps/electrolyte.py``).

An ML-guided search over a fixed molecule space for high ionization
potential: a UCB-ranked molecule queue steers expensive "QC" assays (the
synthetic spectral oracle of ``data/molecules.py``), an MPNN ensemble provides
the cheap learned assay, and the Thinker's agent pairs mirror the paper's
Fig. 2:

    QC-Scorer / QC-Recorder    pull from the queue; record results
    Trainer  / Updater         retrain the ensemble every n_retrain results
    ML-Scorer / ML-Recorder    re-score + reorder the queue on model update

Three policies reproduce Fig. 4: "random", "no-retrain", "update-n".

After every model update the ML-Scorer/ML-Recorder re-scores the whole
molecule space (``Surrogate.predict``, ``rank_space``), in molecule chunks
whose forward working set fits ``EDGE_BYTES_BUDGET``, as the model reckons
it for the path its forward takes (``Surrogate.chunk_size``,
``MPNNEnsemble.bytes_per_molecule``). The plain path (the CPU)
builds the message step's edge tensor, E*N*N*Hd*Hd floats per molecule
(64 MiB at E=16, N=16, Hd=64, f32: 128 molecules a chunk). On the card the
message steps go through the ``mpnn_mp`` kernel's typed entry, which builds
no edge tensor; what bounds a chunk there is the (E, N, Hd) activations of
a message step's GRU, 640 KiB per molecule at those widths, so a space of
up to 13,107 molecules runs as one chunk, in one forward. Chunking changes
memory use only, not the result.

Retraining runs in a Task Server worker thread while the Thinker's threads
may be re-scoring with the same ``Surrogate``. The JAX package swaps in new
immutable parameters; here ``train`` trains a private copy of the model and
at the end replaces ``Surrogate.state``, the (model, y_mean, y_std) triple,
in one assignment, and ``predict`` reads that triple once. Nothing writes the
weights that a re-score is reading.

Layer spans (``repro_torch.observability``, always on): ``mpnn.install``,
``mpnn.predict`` (with the edge-tensor bytes its forwards allocated),
``mpnn.rank`` and ``mpnn.train``.
"""
from __future__ import annotations

import copy
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import observability as obs
from repro_torch.configs import mpnn_surrogate
from repro_torch.core import (CampaignRecord, ColmenaQueues, Observation,
                              ResourceTracker, TaskServer, ValueServer)
from repro_torch.core.policies import ucb_scores
from repro_torch.core.thinker import BaseThinker, agent, result_processor
from repro_torch.data import molecules
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.mpnn import MPNNEnsemble, mpnn_loss

EDGE_BYTES_BUDGET = 8 << 30   # bytes of a chunk's working set (chunk_size)
FEATURES = ("atoms", "bonds", "mask")


@dataclass
class AppConfig:
    num_molecules: int = 800
    initial_train: int = 48          # pre-campaign QC data (paper: 2563)
    qc_budget: int = 120             # QC assays during the campaign
    parallel_qc: int = 4
    n_retrain: int = 16              # paper's update-8, scaled
    policy: str = "update-n"         # random | no-retrain | update-n
    ucb_kappa: float = 2.0
    train_epochs: int = 200
    lr: float = 5e-3
    qc_cost: float = 6.0             # node-hours per assay (paper's number)
    seed: int = 0
    # "high-performing" threshold; 11.0 V puts ~0.3% of the synthetic space
    # above it, matching the paper's 0.5% random-success baseline
    high_ip: float = 11.0


# ---------------------------------------------------------------------------
# Learned assay: MPNN ensemble train + predict
# ---------------------------------------------------------------------------


class Surrogate:
    """MPNN ensemble with standardized targets, trained with Adam; each
    member sees a different bootstrap subsample (the paper's recipe for
    getting an uncertainty estimate out of the ensemble). Predictions are
    returned in the targets' units."""

    def __init__(self, cfg: mpnn_surrogate.MPNNConfig, seed: int = 0,
                 device="cuda"):
        self.cfg = cfg
        self.seed = seed
        self.device = torch.device(device)
        model = MPNNEnsemble(cfg, torch.Generator().manual_seed(seed))
        # (model, y_mean, y_std): replaced whole, never changed in place
        self.state = (model.to(self.device), 0.0, 1.0)

    @property
    def model(self) -> MPNNEnsemble:
        return self.state[0]

    @property
    def y_mean(self) -> float:
        return self.state[1]

    @property
    def y_std(self) -> float:
        return self.state[2]

    def load_numpy(self, params: dict[str, np.ndarray], y_mean: float,
                   y_std: float) -> None:
        """Install stacked numpy parameters (names and shapes of
        ``repro.models.mpnn.mpnn_params``) and the target standardization."""
        with obs.layer("mpnn.install"):
            model = copy.deepcopy(self.model)
            model.load_state_dict(params_from_numpy(params, self.device))
            self.state = (model, float(y_mean), float(y_std))

    def train(self, feats, y, lr: float, epochs: int, *, idx=None) -> float:
        """Full-batch Adam on a bootstrap sample per member, from the current
        weights, for ``epochs`` steps; then swap the result in. feats
        {"atoms","bonds","mask"} and y for n molecules; idx (E, n) bootstrap
        indices, drawn from the surrogate's seed if None. Returns the mean
        over members of the last epoch's loss (taken before its update)."""
        with obs.layer("mpnn.train", epochs=epochs, molecules=len(y)):
            y = np.asarray(y, np.float64)
            y_mean = float(y.mean())
            y_std = float(max(y.std(), 1e-3))
            y_n = ((y - y_mean) / y_std).astype(np.float32)
            n = len(y)
            if idx is None:
                gen = torch.Generator().manual_seed(self.seed)
                idx = torch.randint(n, (self.cfg.ensemble, n),
                                    generator=gen).numpy()
            idx = np.asarray(idx)
            batch = {k: torch.from_numpy(np.asarray(feats[k])[idx])
                     .to(self.device) for k in FEATURES}
            batch["y"] = torch.from_numpy(y_n[idx]).to(self.device)

            model = copy.deepcopy(self.model)
            # Adam is elementwise, so one optimizer over the stacked
            # parameters is per-member Adam; the loss is summed so that each
            # member gets the gradient of its own loss
            opt = torch.optim.Adam(model.parameters(), lr=lr,
                                   betas=(0.9, 0.999), eps=1e-8)
            for _ in range(epochs):
                loss = mpnn_loss(model, batch)                  # (E,)
                opt.zero_grad(set_to_none=True)
                loss.sum().backward()
                opt.step()
            self.state = (model, y_mean, y_std)
            return float(loss.detach().mean())

    def chunk_size(self, n_atoms: int, impl: str = "ref") -> int:
        """Molecules per chunk whose forward working set on the path
        ``impl`` (as ``MPNNEnsemble.message_impl`` resolves it) fits
        EDGE_BYTES_BUDGET; the model reckons the bytes a molecule
        (``MPNNEnsemble.bytes_per_molecule``). A caller that names no path
        gets the plain path's rule, whose chunks fit either path."""
        return max(1, EDGE_BYTES_BUDGET
                   // self.model.bytes_per_molecule(n_atoms, impl))

    def predict(self, feats) -> np.ndarray:
        """feats {"atoms","bonds","mask"} for B molecules, on the host ->
        (E, B) numpy predictions, de-standardized. The features go to the
        device in one copy (1,152 bytes a molecule at N=16): a copy from
        pageable host memory waits for the stream, so a copy a chunk would
        stall the host once a chunk."""
        with obs.layer("mpnn.predict") as sp:
            model, y_mean, y_std = self.state
            atoms, bonds, mask = (torch.as_tensor(np.asarray(feats[k]),
                                                  device=self.device)
                                  for k in FEATURES)
            edge_bytes = obs.counter("edge_bytes")
            before = edge_bytes.value
            with torch.inference_mode():
                impl = model.message_impl(atoms)
                chunk = self.chunk_size(atoms.shape[1], impl)
                starts = range(0, atoms.shape[0], chunk)
                parts = [model(atoms[s:s + chunk], bonds[s:s + chunk],
                               mask[s:s + chunk], impl=impl)
                         for s in starts]
                preds = parts[0] if len(parts) == 1 else torch.cat(parts,
                                                                   dim=1)
            out = preds.cpu().numpy() * y_std + y_mean
            sp.attrs.update(molecules=atoms.shape[0], chunks=len(starts),
                            edge_bytes=edge_bytes.value - before)
            return out

    def mae(self, feats, y) -> float:
        return float(np.mean(np.abs(self.predict(feats).mean(0) - y)))


def rank_space(surrogate: Surrogate, feats, kappa: float = 2.0):
    """ML-Recorder re-score: UCB over the whole space and the queue order
    (best first). Returns (scores (B,), order (B,))."""
    preds = surrogate.predict(feats)
    with obs.layer("mpnn.rank"):
        scores = ucb_scores(preds, kappa)
        return scores, np.argsort(-scores)


# ---------------------------------------------------------------------------
# The Thinker (Fig. 2)
# ---------------------------------------------------------------------------


class MoleculeThinker(BaseThinker):
    def __init__(self, queues, app: AppConfig, space, surrogate, record,
                 resources):
        super().__init__(queues, resources)
        self.app = app
        self.space = space
        self.surrogate = surrogate
        self.record = record
        self.rng = np.random.default_rng(app.seed)
        self.lock = threading.Lock()
        self.queue_order = list(range(app.num_molecules))  # molecule queue
        self.in_flight: set = set()
        self.evaluated: set = set()
        self.since_retrain = 0
        self.retraining = False
        self.t0 = time.perf_counter()
        self.trace: list = []                 # (t, event, payload)
        # host arrays; predict uploads them on each re-score
        self.all_feats = molecules.featurize(space, range(app.num_molecules))

    # -- helpers ---------------------------------------------------------------

    def _t(self):
        return time.perf_counter() - self.t0

    def _next_molecule(self):
        with self.lock:
            for m in self.queue_order:
                if m not in self.evaluated and m not in self.in_flight:
                    self.in_flight.add(m)
                    return m
        return None

    def _reorder(self):
        """ML-Recorder: recompute UCB over the whole space, reorder queue."""
        t0 = time.perf_counter()
        preds = self.surrogate.predict(self.all_feats)          # (E, N)
        scores = ucb_scores(preds, self.app.ucb_kappa)
        with self.lock:
            self.queue_order = list(np.argsort(-scores))
        self.trace.append((self._t(), "reorder",
                           {"seconds": time.perf_counter() - t0}))

    # -- agents -----------------------------------------------------------------

    @agent
    def qc_scorer(self):
        if self.app.policy == "random":
            with self.lock:
                self.rng.shuffle(self.queue_order)
        else:
            self._reorder()                   # initial (pretrained) ranking
        for _ in range(self.app.parallel_qc):
            self._submit_next()

    def _submit_next(self):
        m = self._next_molecule()
        if m is not None:
            self.queues.send_task(int(m), method="qc", topic="qc")

    @result_processor(topic="qc")
    def qc_recorder(self, result):
        assert result.success, result.error
        m, value = result.args[0], result.value
        with self.lock:
            self.in_flight.discard(m)
            self.evaluated.add(m)
        self.record.add(Observation(str(m), "qc", "ip", float(value),
                                    cost=self.app.qc_cost, time=self._t()))
        self.trace.append((self._t(), "qc", (m, float(value))))
        n = self.record.count("qc")
        if n >= self.app.qc_budget:
            self.done.set()
            return
        self.since_retrain += 1
        if (self.app.policy == "update-n"
                and self.since_retrain >= self.app.n_retrain
                and not self.retraining):
            self.since_retrain = 0
            self.retraining = True
            ids = [int(o.entity) for o in self.record.observations()
                   if o.assay == "qc"]
            ys = [o.value for o in self.record.observations()
                  if o.assay == "qc"]
            self.queues.send_task(ids, ys, method="retrain", topic="retrain")
        self._submit_next()

    @result_processor(topic="retrain")
    def updater(self, result):
        """Updater + ML-Scorer: re-rank the queue with the new weights, which
        the retrain installed on the surrogate before it returned them. The
        payload is numpy (large leaves crossed the Value Server as
        proxies); its leaf types and pickled size are traced."""
        assert result.success, result.error
        self.trace.append((self._t(), "retrain", {
            "seconds": result.task_runtime,
            "output_size": result.output_size,
            "leaf_types": sorted({type(v).__name__
                                  for v in result.value.values()})}))
        self._reorder()
        self.retraining = False


# ---------------------------------------------------------------------------
# Campaign driver
# ---------------------------------------------------------------------------


def run_campaign(app: AppConfig, *, verbose: bool = False, device="cuda",
                 cfg: mpnn_surrogate.MPNNConfig | None = None):
    """One campaign under ``app.policy``. cfg is the surrogate's width
    (``mpnn_surrogate.reduced()`` if None, as the JAX package fixes it);
    the surrogate trains and scores on ``device``."""
    space = molecules.MoleculeSpace(num_molecules=app.num_molecules,
                                    seed=42)
    cfg = mpnn_surrogate.reduced() if cfg is None else cfg
    surrogate = Surrogate(cfg, seed=app.seed, device=device)

    # pre-campaign training set (paper: initial ensemble trained on QC data)
    pre_ids = list(range(app.num_molecules))[: app.initial_train]
    pre_y = molecules.oracle_batch(space, pre_ids)
    pre_feats = molecules.featurize(space, pre_ids)
    if app.policy != "random":
        surrogate.train(pre_feats, pre_y, app.lr, app.train_epochs)
    init_mae_ids = list(range(app.num_molecules - 64, app.num_molecules))
    mae_feats = molecules.featurize(space, init_mae_ids)
    mae_y = molecules.oracle_batch(space, init_mae_ids)
    mae0 = surrogate.mae(mae_feats, mae_y)

    record = CampaignRecord(lambda d: d.get("ip"))
    vs = ValueServer()
    queues = ColmenaQueues(["qc", "retrain"], value_server=vs,
                           proxy_threshold=1 << 16)
    resources = ResourceTracker({"qc": app.parallel_qc, "retrain": 1})
    server = TaskServer(queues, workers_per_topic=app.parallel_qc,
                        resources=resources)

    def qc(mol_id: int) -> float:
        return molecules.qc_oracle(space, mol_id)

    def retrain(ids, ys):
        feats = molecules.featurize(space, ids)
        y = np.concatenate([pre_y, np.asarray(ys)])
        f = {k: np.concatenate([pre_feats[k], feats[k]]) for k in FEATURES}
        surrogate.train(f, y, app.lr, app.train_epochs)
        # numpy, never device tensors: the payload crosses the Value Server
        return params_to_numpy(surrogate.model)

    server.register(qc, topic="qc", pool="qc")
    server.register(retrain, topic="retrain", pool="retrain")

    thinker = MoleculeThinker(queues, app, space, surrogate, record,
                              resources)
    with server:
        thinker.run(timeout=600)

    qc_obs = [o for o in record.observations() if o.assay == "qc"]
    values = np.array([o.value for o in qc_obs])
    times = np.array([o.time for o in qc_obs])
    n_high = int(np.sum(values >= app.high_ip))
    out = {
        "policy": app.policy,
        "n_evaluated": len(values),
        "n_high": n_high,
        "success_rate": n_high / max(len(values), 1),
        "best": float(values.max()) if len(values) else None,
        "mean_last_quarter": float(values[-len(values) // 4:].mean())
        if len(values) >= 4 else None,
        "initial_mae": mae0,
        "final_mae": surrogate.mae(mae_feats, mae_y),
        "cost": record.cost(),
        "V": record.value(),
        "times": times.tolist(),
        "values": values.tolist(),
        "trace": thinker.trace,
        "value_server": dict(vs.stats),
    }
    if verbose:
        print(f"[{app.policy}] evaluated={out['n_evaluated']} "
              f"high-IP(>= {app.high_ip}V)={out['n_high']} "
              f"success={out['success_rate']:.1%} best={out['best']:.2f}V "
              f"V(D)={out['V']:.2f} C(D)={out['cost']:.0f} node-h "
              f"mae {out['initial_mae']:.3f}->{out['final_mae']:.3f}")
    return out
