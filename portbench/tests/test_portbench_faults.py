"""A run whose timed path is broken underneath comes out not correct: the
harness runs past its look for a card on the CPU, at the ``cpu_test``
sizes, with one fault planted in the program for each kind of fault the
cell can have."""
import numpy as np
import pytest
import torch

from portbench import run
from portbench.drivers import retrain


def broken_run(root, workload, faults, monkeypatch):
    return run.run_cell(root, workload, 2**31 + 5, 1.5, False, device="cpu",
                        test_size=True, faults=lambda b: faults(b,
                                                                monkeypatch))


def rescore_answer_altered(bench, mp):
    """One score of every re-score moved where the program produces it."""
    from repro_torch.apps import electrolyte

    real = electrolyte.rank_space

    def altered(surrogate, feats, kappa=2.0):
        scores, order = real(surrogate, feats, kappa)
        scores = scores.copy()
        scores[order[-1]] += 5 * float(np.std(scores))
        return scores, np.argsort(-scores)
    mp.setattr(bench.electrolyte, "rank_space", altered)


def serve_token_altered(bench, mp):
    """Every decode step's token of row 0 replaced by the next id."""
    real = bench.engine.decode_batch
    vocab = bench.cfg.vocab_size

    def altered(state):
        out = real(state).copy()
        out[0] = (out[0] + 1) % vocab
        return out
    mp.setattr(bench.engine, "decode_batch", altered)


def train_state_unchanged(bench, mp):
    """The optimizer's step returns the state as it was."""
    mp.setattr(retrain.ADAM, "step",
               lambda self, closure=None: None)


def train_half_batch(bench, mp):
    """Each member's loss over the first half of its sample only."""
    real = bench.loss.loss

    def half(model, batch):
        n = batch["y"].shape[-1] // 2
        return real(model, {k: v[:, :n] for k, v in batch.items()})
    mp.setattr(bench.loss, "loss", half)


def train_steps_skipped(bench, mp):
    """Adam's step does nothing after each optimizer's third."""
    real = retrain.ADAM.step

    def step(self, closure=None):
        self.portbench_calls = getattr(self, "portbench_calls", 0) + 1
        return real(self, closure) if self.portbench_calls <= 3 else None
    mp.setattr(retrain.ADAM, "step", step)


def train_result_cached(bench, mp):
    """A retrain trains once; later ones return at once, as if the result
    were cached across calls."""
    real, calls = bench.surrogate.train, []

    def train(*args, **kw):
        calls.append(1)
        return real(*args, **kw) if len(calls) == 1 else 0.0
    mp.setattr(bench.surrogate, "train", train)


FAULTS = [("mpnn.rescore", rescore_answer_altered),
          ("internlm2.docs", serve_token_altered),
          ("mpnn.retrain", train_state_unchanged),
          ("mpnn.retrain", train_half_batch),
          ("mpnn.retrain", train_steps_skipped),
          ("mpnn.retrain", train_result_cached)]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f.__name__}" for w, f in FAULTS])
def test_fault_is_not_correct(root, workload, fault, monkeypatch):
    """Each fault is planted after set-up, in the window that the
    comparison reads."""
    line = broken_run(root, workload, fault, monkeypatch)
    assert not line["correct"], line["checks"]
    assert any(c["value"] > c["limit"] for c in line["checks"].values())
