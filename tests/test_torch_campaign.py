"""The port's electrolyte campaign against ``repro.apps.electrolyte`` on the
CPU, at tiny sizes. Every campaign runs in a thread joined with a timeout,
so that a hung Thinker fails its test instead of stalling the run."""
import dataclasses
import math
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np

from repro.apps import electrolyte as jax_app
from repro.configs import mpnn_surrogate as jax_configs
from repro.core import ColmenaQueues as JaxQueues
from repro.core import ResourceTracker as JaxResources
from repro.core.policies import ucb_scores
from repro.data import molecules as jax_molecules
from repro_torch.apps import electrolyte
from repro_torch.configs import mpnn_surrogate as configs
from repro_torch.core import ColmenaQueues, ResourceTracker
from repro_torch.data import molecules
from repro_torch.models.mpnn import param_shapes

TIMEOUT = 120     # seconds a campaign may take before its test fails
QC_SECONDS = 0.4  # wall seconds an assay takes in the update-n campaign
TINY = dict(num_molecules=64, initial_train=8, qc_budget=16, n_retrain=8,
            train_epochs=2)


def bounded(fn):
    """fn() in a thread joined with TIMEOUT; its result, or its exception."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:                  # noqa: BLE001
            box["err"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(TIMEOUT)
    assert not th.is_alive(), f"campaign still running after {TIMEOUT} s"
    if "err" in box:
        raise box["err"]
    return box["out"]


def qc_events(out):
    return [payload for _, kind, payload in out["trace"] if kind == "qc"]


def test_random_policy_evaluates_jax_ids():
    """The seeded shuffle and the oracle are the same, so with one QC worker
    (results in submission order) both campaigns assay the same molecules."""
    kw = dict(TINY, policy="random", parallel_qc=1)
    want = bounded(lambda: jax_app.run_campaign(jax_app.AppConfig(**kw)))
    got = bounded(lambda: electrolyte.run_campaign(
        electrolyte.AppConfig(**kw), device="cpu"))
    assert got["n_evaluated"] == want["n_evaluated"] == kw["qc_budget"]
    assert qc_events(got) == qc_events(want)
    for key in ("n_high", "best", "cost", "V", "values"):
        assert got[key] == want[key], key


def test_thinkers_rank_alike():
    """A port MoleculeThinker and a JAX one, on the same carried-across
    parameters, reorder the queue alike wherever the UCB scores are further
    apart than the predictions' tolerance."""
    tol = 1e-4
    app = electrolyte.AppConfig(**dict(TINY, policy="no-retrain"))
    space = jax_molecules.MoleculeSpace(num_molecules=app.num_molecules, seed=42)
    ids = list(range(24))
    jax_sur = jax_app.Surrogate(jax_configs.reduced(), seed=0)
    jax_sur.train(jax.tree.map(jnp.asarray, jax_molecules.featurize(space, ids)),
                  jax_molecules.oracle_batch(space, ids), app.lr, 10)
    sur = electrolyte.Surrogate(configs.reduced(), seed=0, device="cpu")
    sur.load_numpy(jax.tree.map(np.asarray, jax_sur.params), jax_sur.y_mean,
                   jax_sur.y_std)

    want = jax_app.MoleculeThinker(
        JaxQueues(["qc", "retrain"]),
        jax_app.AppConfig(**dict(TINY, policy="no-retrain")),
        space, jax_sur, None, JaxResources({"qc": 1}))
    got = electrolyte.MoleculeThinker(
        ColmenaQueues(["qc", "retrain"]), app,
        molecules.MoleculeSpace(**vars(space)), sur, None,
        ResourceTracker({"qc": 1}))
    want._reorder()
    got._reorder()
    [(_, kind, payload)] = got.trace
    assert kind == "reorder" and payload["seconds"] > 0

    scores = ucb_scores(jax_sur.predict(want.all_feats), app.ucb_kappa)
    s = scores[np.asarray(want.queue_order)]
    assert sorted(got.queue_order) == list(range(app.num_molecules))
    determined = 0
    for p in range(len(s)):
        if all(abs(s[p] - s[q]) > tol for q in (p - 1, p + 1) if 0 <= q < len(s)):
            assert got.queue_order[p] == want.queue_order[p], p
            determined += 1
    assert determined > app.num_molecules // 2


def test_update_n_retrains_and_reorders(monkeypatch):
    """update-n retrains at least once and re-scores after every retrain;
    each retrain payload reaches the Updater as numpy arrays, the largest
    (edge_w, 64 KiB at hidden 32) through a Value Server proxy. Each QC
    assay waits QC_SECONDS before the oracle answers, so a retrain (tens of
    ms here) returns long before the budget is spent. The pre-campaign
    data and the MAE targets, read on the calling thread, do not wait."""
    oracle = molecules.qc_oracle

    def slow_oracle(space, mol_id):
        if threading.current_thread().name.startswith("worker-qc"):
            time.sleep(QC_SECONDS)
        return oracle(space, mol_id)

    monkeypatch.setattr(molecules, "qc_oracle", slow_oracle)
    app = electrolyte.AppConfig(**dict(TINY, policy="update-n", qc_budget=24,
                                       parallel_qc=2))
    cfg = dataclasses.replace(configs.reduced(), hidden=32)
    out = bounded(lambda: electrolyte.run_campaign(app, device="cpu",
                                                   cfg=cfg))
    assert out["n_evaluated"] == app.qc_budget
    events = [(kind, payload) for _, kind, payload in out["trace"]
              if kind != "qc"]
    assert events[0][0] == "reorder"                 # the initial ranking
    retrains = [p for kind, p in events if kind == "retrain"]
    assert retrains
    for i, (kind, payload) in enumerate(events):
        if kind == "retrain":
            assert events[i + 1][0] == "reorder"
            assert payload["leaf_types"] == ["ndarray"]
            assert payload["seconds"] > 0
    sizes = {k: 4 * math.prod(s) for k, s in param_shapes(cfg).items()}
    assert sizes["edge_w"] == 1 << 16                  # the proxy threshold
    assert max(v for k, v in sizes.items() if k != "edge_w") < 1 << 16
    assert out["value_server"]["puts"] >= len(retrains)
    # the pickled result holds every leaf but edge_w's body
    unproxied = sum(sizes.values()) - sizes["edge_w"]
    assert all(unproxied < p["output_size"] < unproxied + 4096
               for p in retrains)
