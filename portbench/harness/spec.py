"""Finds a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Its configuration's file is the ``file`` of that entry of ``configs``; the
mix is ``traffic/<traffic>.json``, which names the driver that runs it
(``drivers/<driver>.py``); the limits of its correctness check are
``limits/<workload>.json``; each per-layer metric is read by
``metrics/<metric>.py``. Nothing here knows any particular cell.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    root: Path                    # the checkout: BENCHMARK.json is here
    workload: dict                # the entry of ``workloads``
    config: dict                  # the configuration's file, as run
    traffic: dict                 # the traffic mix's file
    limits: dict                  # limits/<workload>.json
    end_to_end: list              # this cell's end-to-end metrics
    per_layer: list               # this cell's per-layer metrics
    bench: dict = field(repr=False, default_factory=dict)

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def _reports(metric: dict, workload: str, e2e_names: set) -> bool:
    """A per-layer metric is read in the cells its ``workloads`` lists, or
    without that key in every cell that reports the metric it moves."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric["moves"] in e2e_names


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def load_cell(root: Path, workload: str, test_size: bool = False) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``. ``test_size``
    applies the ``cpu_test`` overrides of the configuration's and the
    traffic's files (the CPU tests' small shapes)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: "
                       f"{sorted(cells)}")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    bench_dir = root / bench["paths"][0]
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((bench_dir / "limits" / f"{workload}.json")
                        .read_text())
    if test_size:
        config = _merge(config, config.get("cpu_test", {}))
        traffic = _merge(traffic, traffic.get("cpu_test", {}))
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, workload, names)]
    return Cell(root, w, config, traffic, limits, e2e, per_layer, bench)


def load_driver(cell: Cell):
    """The module ``drivers/<driver>.py`` that the traffic file names."""
    driver = cell.traffic["driver"]
    return importlib.import_module(f"portbench.drivers.{driver}")


def metric_reader(cell: Cell, name: str):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = cell.root / cell.bench["paths"][0] / "metrics" / f"{name}.py"
    mod_name = "portbench_metric_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
