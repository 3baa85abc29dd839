"""Every cell of ``BENCHMARK.json`` run end to end on the CPU at its
configuration's and traffic's ``cpu_test`` sizes (``mpnn_surrogate.reduced()``
widths; internlm2's ``reduced()`` widths in float32), past the look for a
card, and the command's refusals."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import run

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def one_run(root, workload, trace, seconds=1.5, seed=2**31 + 17, **kw):
    return run.run_cell(root, workload, seed, seconds, trace, device="cpu",
                        test_size=True, **kw)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_end_to_end(root, workload):
    line = one_run(root, workload, trace=False)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    want = {m["name"] for m in BENCH["end_to_end"]
            if "workloads" not in m or workload in m["workloads"]}
    assert set(line["metrics"]) == want
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert list(line)[-1] == "checks"
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(line, allow_nan=False)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_traced(root, workload):
    line = one_run(root, workload, trace=True)
    assert line["correct"], line["checks"]
    listed = {m["name"] for m in BENCH["per_layer"]
              if workload in m.get("workloads", ())}
    assert set(line["metrics"]) <= listed
    # on the CPU no device operation runs, so the readers of device time
    # find nothing; the host's counts are there
    assert line["device"]["busy_s"] == 0.0
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(line, allow_nan=False)


def test_same_seed_same_inputs(root):
    from portbench.drivers import serve
    from portbench.harness import spec

    cell = spec.load_cell(root, "internlm2.docs", test_size=True)
    a = serve.Requests(cell.traffic, 512, 99)
    b = serve.Requests(cell.traffic, 512, 99)
    assert [a[k] for k in range(20)] == [b[k] for k in range(20)]


def _command(cwd, env=None):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "mpnn.rescore",
         "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=300, env=env)


def test_command_refuses_without_a_card(root):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _command(root, env)
    assert out.returncode != 0 and out.stdout == ""


def test_command_refuses_without_the_program(root, tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder."""
    shutil.copy(root / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(root / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
