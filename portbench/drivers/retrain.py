"""The Task Server's retrain task: retrains run one after another, each a
``retrain`` task sent through ``ColmenaQueues`` to a ``TaskServer`` over the
local transport, with a Value Server behind the queues, as ``run_campaign``
registers them. The task's method calls ``Surrogate.train`` (bootstrap
Adam) and returns ``params_to_numpy(surrogate.model)`` and the loss; each
retrain continues from the weights the previous one left, as a campaign's
do. The window's first retrain starts from the weights drawn from the seed.

Traffic parameters: ``train_molecules`` (drawn from the seed's space, their
targets from the frozen oracle), ``epochs``, ``lr``, ``check_steps``,
``proxy_threshold``, ``trace_seconds``.

``train_step_ms`` is the wall of the retrains completed in the window, each
from its send to its result, over their optimizer steps; the retrain in
flight at the close finishes and is not counted.

``correct`` is judged on the window's own retrains. For the whole run
``torch.optim.Adam`` is ``_Spy``, which the program's ``Surrogate.train``
builds its optimizer from, and the program's ``mpnn_loss`` is called
through ``_Recorder``. Of each retrain they keep the weights before its
first step, Adam's first moments after it (the first gradient as the
optimizer got it is ``exp_avg / (1 - beta1)``, with the beta1 it was
given), each member's loss at its first ``check_steps`` steps, the weights
after those steps and after its last, and its step counts. After the
window the float64 reference (``reference/mpnn.py``) follows the first
``check_steps`` steps of the window's first retrain, from the seed's
weights, and compares:

- ``loss_gap``: the largest relative difference of a member's loss at a
  step;
- ``grad_gap``: by the worst leaf, the gap between the program's and the
  reference's gradient norms, over the larger of the reference's norm of
  that leaf and of the median leaf;
- ``change_gap``: the same of the norms of the weights' change over
  ``check_steps`` steps, over the leaves whose reference gradient norm is
  at least a thousandth of the median leaf's (a leaf below that moves under
  Adam by rounding alone).

It follows as well one retrain drawn from the seed among the others, from
the weights it started from (the program's own state, the previous
retrain's result): ``later_change_gap`` is its ``change_gap``. There the
model fits its samples to losses of 1e-10 to 1e-3, so that float32 cannot
resolve its losses and gradients, and only the change is compared.

Exactly, over every retrain of the run:

- ``steps_gap``: how far the optimizer steps the program called, and the
  steps Adam's state counted, fall from ``epochs``;
- ``result_gap``: the largest difference between the weights a retrain
  returned through the queues and those its last step left, and between
  them and the weights the next retrain started from (the first retrain's
  start against the seed's weights).

A program that builds its optimizer other than through
``torch.optim.Adam`` as it stands when a retrain starts leaves the record
empty, and the run is not correct (``steps_gap``).
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from portbench.drivers import mpnn_common as mc
from portbench.gen import molecules
from portbench.reference import mpnn as ref

TOPIC = "retrain"
ADAM = torch.optim.Adam        # the real class, which ``_Spy`` stands in for


def leaf_gap(prog: dict, want: dict, names) -> float:
    """max over ``names`` of | |prog| - |want| | / max(|want|, median |want|),
    norms of each leaf over all its members."""
    pn = {k: float(np.linalg.norm(np.asarray(prog[k], np.float64)))
          for k in want}
    wn = {k: float(np.linalg.norm(want[k])) for k in want}
    med = float(np.median(list(wn.values())))
    return max(abs(pn[k] - wn[k]) / max(wn[k], med) for k in names)


def compare(prog: dict, want: dict, w0: dict) -> dict:
    """prog/want: {"losses" [(E,) a step], "grad1", "params"}; w0 the
    start weights."""
    losses = max(float(np.max(np.abs(np.asarray(p, np.float64) - w)
                              / np.abs(w)))
                 for p, w in zip(prog["losses"], want["losses"]))
    gnorm = {k: float(np.linalg.norm(g)) for k, g in want["grad1"].items()}
    med = float(np.median(list(gnorm.values())))
    moved = [k for k, g in gnorm.items() if g >= 1e-3 * med]
    change = {k: np.asarray(prog["params"][k], np.float64) - w0[k]
              for k in w0}
    change_ref = {k: want["params"][k] - w0[k] for k in w0}
    return {"loss_gap": losses,
            "grad_gap": leaf_gap(prog["grad1"], want["grad1"], want["grad1"]),
            "change_gap": leaf_gap(change, change_ref, moved)}


def max_diff(a: dict, b: dict) -> float:
    """The largest elementwise difference of two sets of weights; a leaf
    that one set lacks reads as zeros there."""
    out = 0.0
    for k in set(a) | set(b):
        x, y = a.get(k), b.get(k)
        x = np.zeros_like(y) if x is None else x
        y = np.zeros_like(x) if y is None else y
        out = max(out, float(np.max(np.abs(x - y))))
    return out


def worst(readings: list) -> dict:
    """Each number's largest reading over the retrains compared."""
    return {k: max(r[k] for r in readings) for k in readings[0]}


class Record:
    """What ``_Spy`` and ``_Recorder`` keep of one retrain (device tensors
    in the optimizer's parameter order, which is ``reference.NAMES``)."""

    def __init__(self, epochs: int, check_steps: int):
        self.epochs, self.check_steps = epochs, check_steps
        self.calls = 0              # optimizer steps the program called
        self.adam_steps = 0         # steps Adam's state counted at the last
        self.beta1 = None
        self.start = self.moments = self.after = self.final = None
        self.losses: list = []      # (E,) each member's loss, first steps
        self.returned = None        # the weights the task returned

    def numpy(self, which: str, like: dict) -> dict:
        """{name: float64 array} of a snapshot; zeros shaped as ``like``
        where none was taken (the program never got so far)."""
        snap = getattr(self, which)
        if snap is None:
            return {k: np.zeros(np.shape(v)) for k, v in like.items()}
        return {k: t.double().cpu().numpy() for k, t in zip(ref.NAMES, snap)}


def _snapshot(params) -> list:
    return [p.detach().clone() for p in params]


class _Spy(ADAM):
    """Adam that records the retrain in progress (``_Spy.record``)."""

    record: Record | None = None

    def step(self, closure=None):
        rec = _Spy.record
        params = self.param_groups[0]["params"]
        if rec is not None and rec.calls == 0:
            rec.start = _snapshot(params)
        out = super().step(closure)
        if rec is None:
            return out
        rec.calls += 1
        if rec.calls == 1:
            rec.beta1 = float(self.param_groups[0]["betas"][0])
            rec.moments = [self.state[p].get("exp_avg", torch.zeros_like(p))
                           .detach().clone() for p in params]
        if rec.calls == rec.check_steps:
            rec.after = _snapshot(params)
        if rec.calls == rec.epochs:
            rec.final = _snapshot(params)
            step = self.state[params[0]].get("step", 0)
            rec.adam_steps = int(step)
        return out


class _Recorder:
    """The program's loss, called through: keeps each member's loss of the
    first ``check_steps`` calls of the retrain in progress."""

    def __init__(self, loss):
        self.loss = loss

    def __call__(self, model, batch):
        out = self.loss(model, batch)
        rec = _Spy.record
        if rec is not None and len(rec.losses) < rec.check_steps:
            rec.losses.append(out.detach().clone())
        return out


class Bench:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.config, self.traffic = cell.config, cell.traffic
        self.units: list = []          # (t_send, t_result, epochs)
        self.records: list = []        # a Record a retrain, in order
        self._wanted: dict = {}        # retrain -> the reference's steps
        self.attempted = self.failed = 0
        self.server = None
        self._patched = None

    # -- the program ----------------------------------------------------------

    def setup(self, win) -> None:
        from repro_torch.apps import electrolyte
        from repro_torch.core import (ColmenaQueues, ResourceTracker,
                                      TaskServer, ValueServer)
        from repro_torch.models.convert import params_to_numpy

        t = self.traffic
        sp = mc.space(self.config, self.seed)
        ids = mc.rng(self.seed, 1).permutation(sp.num_molecules)[
            :t["train_molecules"]]
        self.feats = molecules.featurize(sp, ids)
        self.y = molecules.oracle_batch(sp, ids)
        n = len(ids)
        self.idx = mc.rng(self.seed, 2).integers(
            n, size=(self.config["ensemble"], n))
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.w0 = mc.to_numpy(mc.draw_weights(self.config, gen, self.device))

        self.surrogate = electrolyte.Surrogate(
            mc.program_config(self.config), seed=0, device=self.device)
        surrogate, records = self.surrogate, self.records
        epochs_checked = t["check_steps"]

        def retrain(feats, y, idx, epochs, lr):
            rec = _Spy.record = Record(epochs, epochs_checked)
            records.append(rec)
            try:
                loss = surrogate.train(feats, y, lr, epochs, idx=idx)
            finally:
                _Spy.record = None
            return {"params": params_to_numpy(surrogate.model), "loss": loss}

        self._patched = (electrolyte, electrolyte.mpnn_loss, torch.optim.Adam)
        self.loss = _Recorder(electrolyte.mpnn_loss)
        electrolyte.mpnn_loss = self.loss
        torch.optim.Adam = _Spy

        self.queues = ColmenaQueues([TOPIC], value_server=ValueServer(),
                                    proxy_threshold=t["proxy_threshold"])
        self.server = TaskServer(self.queues, workers_per_topic=1,
                                 resources=ResourceTracker({TOPIC: 1}))
        self.server.register(retrain, topic=TOPIC, pool=TOPIC)
        self.server.start()

        # warm-up: a short retrain through the window's own call and feed,
        # then the seed's weights again for the window's first retrain
        self.surrogate.load_numpy(self.w0, 0.0, 1.0)
        self._task(t["check_steps"])
        self.records.clear()
        self.surrogate.load_numpy(self.w0, 0.0, 1.0)

    def _task(self, epochs: int) -> dict:
        self.queues.send_task(self.feats, self.y, self.idx, epochs,
                              self.traffic["lr"], method="retrain",
                              topic=TOPIC)
        result = self.queues.get_result(TOPIC, timeout=600)
        if result is None or not result.success:
            raise RuntimeError("retrain task failed: "
                               f"{None if result is None else result.error}")
        return result.value

    def run(self, win) -> None:
        epochs = self.traffic["epochs"]
        while not win.expired():
            win.boundary()
            t0 = time.perf_counter()
            self.attempted += 1
            try:
                out = self._task(epochs)
            except RuntimeError:
                self.failed += 1
                continue
            self.units.append((t0, time.perf_counter(), epochs))
            if len(self.records) == self.attempted:
                self.records[-1].returned = out["params"]
        win.boundary()

    def release(self) -> None:
        self.surrogate.state = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def close(self) -> None:
        if self.server is not None:
            self.server.stop()
            for th in threading.enumerate():
                if th.name.startswith(f"worker-{TOPIC}"):
                    th.join(timeout=30)
            self.server = None
        if self._patched is not None:
            module, loss, adam = self._patched
            module.mpnn_loss, torch.optim.Adam = loss, adam
            self._patched = None

    # -- what is reported -----------------------------------------------------

    def counted(self, win) -> list:
        return [u for u in self.units if u[1] <= win.deadline]

    def end_to_end(self, win) -> dict:
        done = self.counted(win)
        if not done:
            raise RuntimeError("no retrain completed in the window: make "
                               "the window longer")
        return {"train_step_ms": 1e3 * sum(b - a for a, b, _ in done)
                / sum(e for _, _, e in done)}

    def context(self, win, trace) -> dict:
        return {"config": self.config, "trace": trace, "units": self.units,
                "win": win, "feats": self.feats, "idx": self.idx,
                "untraced": [u for u in self.units
                             if win.in_untraced_part(u[0])
                             and win.in_untraced_part(u[1])]}

    # -- correct ----------------------------------------------------------------

    def compared(self) -> list:
        """The retrains the reference follows: the window's first, and one
        drawn from the seed among the others."""
        n = len(self.records)
        pick = [0] if n else []
        if n > 1:
            pick.append(int(mc.rng(self.seed, 3).integers(1, n)))
        return pick

    def start_of(self, i: int) -> dict:
        """The weights retrain ``i`` started from: the seed's for the
        first; for a later one the program's own state, as its first step
        found it, or where it took none the previous retrain's result."""
        if i == 0:
            return self.w0
        rec, prev = self.records[i], self.records[i - 1].returned
        if rec.start is None and prev is not None:
            return {k: np.asarray(v, np.float64) for k, v in prev.items()}
        return rec.numpy("start", self.w0)

    def program(self, i: int) -> dict:
        rec = self.records[i]
        moments = rec.numpy("moments", self.w0)
        beta1 = rec.beta1 if rec.beta1 is not None else 0.0
        losses = [t.double().cpu().numpy() for t in rec.losses]
        losses += [np.zeros(self.config["ensemble"])] * (
            rec.check_steps - len(losses))
        return {"losses": losses,
                "grad1": {k: v / (1 - beta1) for k, v in moments.items()},
                "params": rec.numpy("after", self.w0)}

    def _reference(self, i: int, **kw) -> dict:
        return ref.adam_train(self.start_of(i), self.feats, self.y, self.idx,
                              self.config, lr=self.traffic["lr"],
                              steps=self.traffic["check_steps"],
                              device=self.device, **kw)

    def exact(self) -> dict:
        """``steps_gap`` and ``result_gap`` over every retrain."""
        steps, result = 0, 0.0
        prev = {k: np.asarray(v, np.float64) for k, v in self.w0.items()}
        for rec in self.records:
            steps = max(steps, abs(rec.calls - rec.epochs),
                        abs(rec.adam_steps - rec.epochs))
            got = {k: np.asarray(v, np.float64)
                   for k, v in (rec.returned or {}).items()}
            result = max(result, max_diff(rec.numpy("start", self.w0), prev),
                         max_diff(got, rec.numpy("final", self.w0)))
            prev = got
        return {"steps_gap": float(steps), "result_gap": result}

    def _want(self, i: int) -> dict:
        if i not in self._wanted:
            self._wanted[i] = self._reference(i)
        return self._wanted[i]

    def _gaps(self, side) -> dict:
        """The numbers of ``side(i)``, the first steps of retrain ``i`` as
        the program (or a stand-in) took them, against the reference."""
        pick = self.compared()
        if not pick:
            return dict.fromkeys(("loss_gap", "grad_gap", "change_gap",
                                  "later_change_gap"), 1.0)
        got = compare(side(0), self._want(0), self.start_of(0))
        later = 0.0
        if len(pick) > 1:
            i = pick[-1]
            later = compare(side(i), self._want(i),
                            self.start_of(i))["change_gap"]
        return {**got, "later_change_gap": later}

    def readings(self) -> dict:
        return {**self._gaps(self.program), **self.exact()}

    def check(self) -> dict:
        return {k: (v, self.cell.limits[k])
                for k, v in self.readings().items()}

    def control(self) -> dict:
        """The readings of the control (the reference in float32 with TF32
        matmuls in the program's place) and of the fault of half of each
        member's sample left out (the reference in float32 so), against
        the float64 reference, from the same starts as the check's."""
        def tf32(i):
            with mc.tf32():
                return self._reference(i, dtype=torch.float32)
        return {"control": self._gaps(tf32),
                "half_batch": self._gaps(lambda i: self._reference(
                    i, dtype=torch.float32, batch_share=0.5))}
