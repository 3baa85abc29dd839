"""Run one cell of ``BENCHMARK.json`` once, on the card, and print one JSON
line.

    python3 portbench/run.py --workload mpnn.rescore --seed 7 --seconds 30 \
        --trace 0

Run from the root of a checkout: the program is ``src/repro_torch``, built
kernels go to ``build/`` inside the checkout. Set-up (``setup_s``) runs from
the process's start to the window's: data and weights from the seed, the
program, the warm-up of every shape the cell's traffic uses. The window
then runs for ``--seconds``. With ``--trace 0`` the line's metrics are the
cell's end-to-end metrics; with ``--trace 1`` the profiler traces the end
of the window and the line holds the cell's per-layer metrics, the device's
busy and window seconds and a breakdown. After the window, with the peak
memory read and the program's state freed, the plain reference decides
``correct``; each number compared is printed beside its limit, last on
standard error and last in the line.

The run exits with a code other than 0 and prints no result when the card
is missing or fewer cards are present than the cell asks for, when the
program is missing (a directory with only ``BENCHMARK.json`` and this
folder), or when the process has loaded JAX or the JAX package.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _prepare_imports(root: Path) -> None:
    """Import the benchmark as the package ``portbench`` and the program
    from ``src`` of the checkout, never from this folder alone."""
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p and os.path.abspath(p) != here]
    for p in (str(root / "src"), str(root)):
        if p not in sys.path:
            sys.path.insert(0, p)


def _environment(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout; no JAX
    through a library; no span sinks of the program."""
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.pop("REPRO_OBS_DIR", None)


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the run may not load, each
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _device_info(torch, device, chips: int, peak: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, *, device: str = "cuda",
             test_size: bool = False, t_start: float | None = None,
             faults=None) -> dict:
    """One run of the cell; returns the result line as a dict. The CPU
    tests call this with ``device="cpu"`` and ``test_size=True``;
    ``faults`` (tests only) is called with the bench after its set-up and
    may break the program underneath."""
    import torch

    from portbench.harness import spec as cells
    from portbench.harness.window import Window

    t_start = T_START if t_start is None else t_start
    dev = torch.device(device)
    cell = cells.load_cell(root, workload, test_size=test_size)
    driver = cells.load_driver(cell)
    bench = driver.Bench(cell, seed, dev)
    win = Window(seconds, trace=trace,
                 trace_seconds=cell.traffic.get("trace_seconds", seconds),
                 on_cuda=dev.type == "cuda")
    try:
        win.prepare()
        bench.setup(win)
        if faults is not None:
            faults(bench)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        setup_s = time.perf_counter() - t_start
        win.open()
        bench.run(win)
        dtrace = win.finish()
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
        if trace:
            ctx = bench.context(win, dtrace)
            metrics = {}
            for m in cell.per_layer:
                value = cells.metric_reader(cell, m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            values = bench.end_to_end(win)
            values["setup_s"] = setup_s
            metrics = {m["name"]: {"value": values[m["name"]],
                                   "unit": m["unit"]}
                       for m in cell.end_to_end}
        bench.release()
        checks = bench.check()
    finally:
        bench.close()
    correct = (bench.attempted > 0 and bench.failed == 0
               and all(v <= lim for v, lim in checks.values()))
    line = {"correct": bool(correct), "attempted": bench.attempted,
            "failed": bench.failed, "metrics": metrics,
            "device": _device_info(torch, dev, cell.chips, peak)}
    if trace:
        if dtrace is None:
            raise RuntimeError("the profiler never started: the window held "
                               "no boundary inside its traced part")
        line["device"]["busy_s"] = dtrace.busy_s()
        line["device"]["window_s"] = dtrace.window_s
        line["breakdown"] = dtrace.breakdown()
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print("portbench: the program (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    _environment(ROOT)
    _prepare_imports(ROOT)
    import torch

    from portbench.harness import spec as cells

    chips = cells.load_cell(ROOT, args.workload).chips
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); found "
              f"{found}", file=sys.stderr)
        return 2
    line = run_cell(ROOT, args.workload, args.seed % (1 << 63),
                    args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}; it may load none of "
              f"{list(FORBIDDEN)}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
