#!/usr/bin/env python3
"""Where the time of the bf16 scan kernels goes, and which faults the bf16
holds of ``chip_smoke.py`` catch, on one NVIDIA H100.

    python3 benchmarks/bench_port_scan_ablation.py [--holds]

Builds variants of ``mamba2_ssd.cu`` and ``rwkv6_scan.cu`` in which one
phase of the bf16 kernel is left out (``-DABLATE=<mask>``, see the sources;
one ``nvcc`` each, all at once, beside the kernels in ``build/``) and times
each through the binding at the serving shape, as ``chip_smoke.py`` phases
12 and 16 time the kernel (ten calls an event pair, median of ten), in two
rounds. A variant computes wrong numbers: the time a phase saves when it is
left out is its share.

With ``--holds`` every variant is also a faulty kernel put to the bf16
holds of ``chip_smoke.py``: phase 9's or 13's kernel holds (the JAX test
shapes and the serving shape, against the plain version) and phase 10's or
14's full-width bf16 prefill hold. Each hold's failures are recorded, not
raised; a hold that passes a variant cannot tell that fault from the kernel.

Prints the card's name and power limit, then one JSON line per round of
times and one per variant held.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import functools
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

# ABLATE bits of each source (the enums beside its bf16 kernel)
VARIANTS = {
    "mamba2_ssd": {"base": 0, "no_carry_in": 1, "no_lo_passes": 2,
                   "no_state_update": 4, "no_y_store": 8},
    "rwkv6_scan": {"base": 0, "no_scan": 1, "no_offdiag": 2, "no_diag": 4,
                   "no_carry_in": 8, "no_a_v": 16, "no_state_update": 32,
                   "one_pass": 64},
}
BINDINGS = {"mamba2_ssd": smoke.mamba2_ssd, "rwkv6_scan": smoke.rwkv6_scan}


def defines(mask: int) -> tuple[str, ...]:
    return (f"ABLATE={mask}",) if mask else ()


@contextlib.contextmanager
def variant(kernel: str, mask: int):
    """The binding of ``kernel`` launches the variant ``mask`` inside."""
    binding = BINDINGS[kernel]
    built = binding.library
    binding.library = functools.partial(built, defines(mask))
    try:
        yield
    finally:
        binding.library = built


def build_all() -> None:
    with concurrent.futures.ThreadPoolExecutor(32) as pool:
        jobs = [pool.submit(_build.build_libraries, (kernel,), defines(mask))
                for kernel, masks in VARIANTS.items() for mask in masks.values()]
        for job in jobs:
            job.result()


def timers() -> dict:
    """A call of each kernel's binding at its serving shape (bf16 inputs and
    decay, as the models pass them)."""
    gen = torch.Generator(device=smoke.DEV).manual_seed(smoke.SEED)
    x, la, b, c, s0 = smoke.ssd_inputs(smoke.SSD_SERVING, torch.bfloat16, gen,
                                       torch.bfloat16)
    Q = smoke.SSD_SERVING[-1]
    r, k, v, lw, u, w0 = smoke.wkv_inputs(smoke.WKV_SERVING, torch.bfloat16,
                                          gen, torch.bfloat16, torch.bfloat16)
    C = smoke.WKV_SERVING[5]
    return {
        "mamba2_ssd": lambda: smoke.ssd_ops.ssd(x, la, b, c, s0, impl="kernel",
                                                chunk=Q),
        "rwkv6_scan": lambda: smoke.wkv_ops.wkv6(r, k, v, lw, u, w0,
                                                 impl="kernel", chunk=C)}


def hold(kernel: str) -> dict:
    """chip_smoke.py's bf16 holds of ``kernel`` with every failure recorded:
    {"kernel": [...], "prefill": [...]} failures and the prefill readings."""
    failed = []
    smoke.check = lambda ok, what: ok or failed.append(what)
    if kernel == "mamba2_ssd":
        gen = torch.Generator(device=smoke.DEV).manual_seed(smoke.SEED + 7)
        for case in smoke.SSD_CASES:
            smoke.hold_ssd(case, torch.bfloat16, gen)
        smoke.hold_ssd(smoke.SSD_SERVING, torch.bfloat16, gen, torch.bfloat16)
        kernel_failed, failed[:] = list(failed), []
        readings = smoke.phase_hybrid_prefill()
    else:
        gen = torch.Generator(device=smoke.DEV).manual_seed(smoke.SEED + 12)
        for case in smoke.WKV_CASES:
            smoke.hold_wkv(case, torch.bfloat16, gen, lw_dtype=torch.bfloat16)
        smoke.hold_wkv(smoke.WKV_SERVING, torch.bfloat16, gen, torch.bfloat16,
                       torch.bfloat16)
        kernel_failed, failed[:] = list(failed), []
        readings = smoke.phase_rwkv_prefill()
    torch.cuda.empty_cache()
    return {"kernel": kernel_failed, "prefill": failed, "readings": readings}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--holds", action="store_true",
                    help="also put every variant to chip_smoke.py's bf16 holds")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_port_scan_ablation: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    build_all()
    calls = timers()
    for rnd in range(2):
        out = {}
        for kernel, masks in VARIANTS.items():
            for name, mask in masks.items():
                with variant(kernel, mask):
                    out.setdefault(kernel, {})[name] = smoke.median_ms(calls[kernel])
        print(json.dumps({"round": rnd, "ms": out}), flush=True)
    del calls
    torch.cuda.empty_cache()
    if args.holds:
        for kernel, masks in VARIANTS.items():
            for name, mask in masks.items():
                with variant(kernel, mask):
                    print(json.dumps({"kernel": kernel, "variant": name,
                                      **hold(kernel)}), flush=True)


if __name__ == "__main__":
    main()
