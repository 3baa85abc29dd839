"""The readings that set the limits of a cell's correctness check: for each
seed, the numbers a sound run of the program gives, and the numbers of the
control (the reference in the precision below the configuration's, put in
the program's place) and, for a training cell, of the planted fault of half
the batch left out. All in one process, each seed a set-up and a short
window at the cell's own size and load.

    python3 portbench/calibrate.py --workload mpnn.rescore --seconds 4 \
        --seeds 11 12 13 --control-seeds 11 12 13

Prints one JSON line a seed, then a summary: the largest program reading
(the lower one) and the smallest control reading (the upper one) of each
number. ``PERF.md`` keeps the readings each limit in ``limits/`` was set
from.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(root: Path, workload: str, seed: int, seconds: float, *,
             control: bool, device: str = "cuda",
             test_size: bool = False) -> dict:
    """One seed: the program's numbers, and the control's if asked."""
    import torch

    from portbench.harness import spec as cells
    from portbench.harness.window import Window

    dev = torch.device(device)
    cell = cells.load_cell(root, workload, test_size=test_size)
    bench = cells.load_driver(cell).Bench(cell, seed, dev)
    win = Window(seconds, on_cuda=dev.type == "cuda")
    try:
        bench.setup(win)
        win.open()
        bench.run(win)
        bench.release()
        out = {"seed": seed, "attempted": bench.attempted,
               "failed": bench.failed,
               "program": {k: v for k, (v, _) in bench.check().items()}}
        if control:
            out["control"] = bench.control()
    finally:
        bench.close()
        del bench
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def summary(rows: list) -> dict:
    """The lower reading (largest of the program's) and the upper reading
    (smallest of each control's) of each number."""
    low = {}
    for r in rows:
        for k, v in r["program"].items():
            low[k] = max(low.get(k, 0.0), v)
    up = {}
    for r in rows:
        ctl = r.get("control", {})
        groups = ctl if all(isinstance(v, dict) for v in ctl.values()) \
            else {"control": ctl}
        for g, vals in groups.items():
            for k, v in vals.items():
                up.setdefault(g, {})[k] = min(up.get(g, {}).get(k, v), v)
    return {"lower": low, "upper": up}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=())
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = readings(ROOT, args.workload, seed, args.seconds,
                     control=seed in args.control_seeds)
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
        rows.append(r)
    print(json.dumps({"workload": args.workload, **summary(rows)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
