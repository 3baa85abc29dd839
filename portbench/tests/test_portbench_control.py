"""On the card, at each cell's own size and load: the control (the
reference in the precision below the configuration's, in the program's
place) fails the cell's limits on three seeds, as does each planted fault
of a training cell, while the program passes them. Runs only where a card
is: ``python -m pytest -q -m cuda portbench/tests/test_portbench_control.py``
(about 10 minutes on one H100)."""
import json

import pytest

from portbench import calibrate

BENCH = json.loads((calibrate.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)
# long enough to finish the mix's longest requests at the cell's load, and
# for the retrain to start the second retrain that its check draws
SECONDS = {"mpnn.rescore": 4.0, "mpnn.retrain": 14.0, "internlm2.docs": 12.0}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_program_passes(root, card, workload):
    limits = json.loads((root / "portbench/limits" / f"{workload}.json")
                        .read_text())
    for seed in SEEDS:
        r = calibrate.readings(root, workload, seed,
                               SECONDS[workload], control=True)
        assert r["failed"] == 0
        for k, v in r["program"].items():
            assert v <= limits[k], (seed, k, v)
        ctl = r["control"]
        groups = ctl if all(isinstance(v, dict) for v in ctl.values()) \
            else {"control": ctl}
        for name, readings in groups.items():
            assert any(v > limits[k] for k, v in readings.items()), (
                seed, name, readings)
