#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases:
  1. Build each CUDA kernel of the main path from the sources in this
     checkout and hold it against its plain PyTorch version, in f32 and bf16,
     at the JAX kernel tests' shapes and at the surrogate's chunk shape.
  2. Build the full-width MPNN-ensemble surrogate (E=16, hidden 64, seeded
     random weights) and hold its kernel forward against its plain forward
     on one chunk of real molecules.
  3. Serve: featurize the 10,000-molecule space and answer 3 re-score
     requests (predict, UCB, reorder) through ``rank_space``, perturbing the
     weights between requests as a retrain would. Kernel launch counts are
     set to 0 just before this phase and read just after it.
  4. Report: time each kernel, its plain version and the one PyTorch call
     that computes the same function, with CUDA events at the surrogate's
     chunk shape, beside the bound for that work.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without a CUDA device or when any check fails.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.apps.electrolyte import Surrogate, rank_space  # noqa: E402
from repro_torch.configs.mpnn_surrogate import CONFIG  # noqa: E402
from repro_torch.data.molecules import MoleculeSpace, featurize  # noqa: E402
from repro_torch.kernels.mpnn_mp import mpnn_mp, ops  # noqa: E402
from repro_torch.kernels.mpnn_mp.ref import message_pass_reference  # noqa: E402

DEV = "cuda"
SEED = 0
REQUESTS = 3
KAPPA = 2.0
SPACE = MoleculeSpace()                 # the default 10,000-molecule space
TEST_SHAPES = [(3, 16, 32), (2, 8, 64)]  # tests/test_kernels.py::test_mpnn_kernel
# f32: kernel and plain version both sum in f32, in different orders.
# bf16: both round an f32 sum to bf16, so they may differ by one bf16 ulp
# (<= 2**-7 relative).
TOLERANCE = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2.0 ** -7, 1e-4)}
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s and f32 FLOP/s
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def median_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of one call of fn, from CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernel_inputs(B, N, Hd, dtype, gen):
    h = torch.randn(B, N, Hd, generator=gen, device=DEV, dtype=dtype)
    e = torch.randn(B, N, N, Hd, Hd, generator=gen, device=DEV, dtype=dtype)
    e.mul_(0.1)
    adj = (torch.rand(B, N, N, generator=gen, device=DEV) > 0.5).float()
    return h, e, adj


def hold_kernel(h, e, adj) -> float:
    """Kernel against the plain version on the same inputs; max abs error."""
    got = ops.message_pass(h, e, adj, impl="kernel")
    want = message_pass_reference(h, e, adj)
    torch.cuda.synchronize()
    check(got.dtype == h.dtype and got.shape == h.shape,
          f"mpnn_mp output {got.dtype} {tuple(got.shape)}")
    rtol, atol = TOLERANCE[h.dtype]
    err = (got.float() - want.float()).abs().max().item()
    check(torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol),
          f"mpnn_mp {tuple(h.shape)} {h.dtype}: max abs err {err}")
    log(f"  mpnn_mp {tuple(h.shape)} {str(h.dtype):14s} max abs err {err:.3e}"
        f" (rtol {rtol:.2e}, atol {atol:.0e})")
    return err


def phase_kernels(chunk_batch: int) -> dict:
    log("phase 1: build and hold kernels")
    t0 = time.perf_counter()
    mpnn_mp.library()
    log(f"  mpnn_mp built in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    shape = (chunk_batch, SPACE.max_atoms, CONFIG.hidden)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for s in TEST_SHAPES + [shape]:
            errs[s, dtype] = hold_kernel(*kernel_inputs(*s, dtype, gen))
    return {"max_abs_err": errs[shape, torch.float32],
            "max_abs_err_bf16": errs[shape, torch.bfloat16]}


def phase_surrogate(sur: Surrogate, feats: dict) -> None:
    log("phase 2: full-width surrogate, kernel forward against plain forward")
    chunk = sur.chunk_size(SPACE.max_atoms)
    x = [torch.as_tensor(feats[k][:chunk], device=DEV)
         for k in ("atoms", "bonds", "mask")]
    with torch.inference_mode():
        got = sur.model(*x, impl="kernel")
        want = sur.model(*x, impl="ref")
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(got.shape == (CONFIG.ensemble, chunk), f"forward shape {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), "non-finite predictions")
    check(torch.allclose(got, want, rtol=1e-4, atol=1e-4),
          f"kernel forward vs plain forward: max abs err {err}")
    log(f"  E={CONFIG.ensemble} hidden={CONFIG.hidden} chunk={chunk}: "
        f"max abs err {err:.3e} (rtol 1e-4, atol 1e-4)")


def perturb(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Move every weight a little, as a retrain would."""
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen, device=p.device), alpha=0.01)


def phase_serve(sur: Surrogate, feats: dict) -> dict:
    log(f"phase 3: serve {REQUESTS} re-score requests over "
        f"{SPACE.num_molecules} molecules")
    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    n = SPACE.num_molecules
    torch.cuda.reset_peak_memory_stats()
    previous = None
    mpnn_mp.LAUNCHES = 0
    for r in range(REQUESTS):
        if r:
            perturb(sur.model, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores, order = rank_space(sur, feats, KAPPA)
        wall = time.perf_counter() - t0
        finite = bool(np.isfinite(scores).all())
        check(scores.shape == (n,) and finite, f"request {r}: scores "
              f"{scores.shape}, finite={finite}")
        check(np.array_equal(np.sort(order), np.arange(n)),
              f"request {r}: order is not a permutation")
        check(previous is None or not np.array_equal(scores, previous),
              f"request {r}: scores did not change after the update")
        previous = scores
        log(f"  request {r}: {wall * 1e3:.1f} ms wall, top-10 "
            f"{order[:10].tolist()}, all {n} scores finite")
    launches = mpnn_mp.LAUNCHES
    per_request = CONFIG.message_steps * math.ceil(n / sur.chunk_size(SPACE.max_atoms))
    log(f"  mpnn_mp launches {launches} ({per_request} per re-score); peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(launches == REQUESTS * per_request,
          f"mpnn_mp launched {launches} times, expected {REQUESTS * per_request}")
    return {"launches": launches, "launches_per_rescore": per_request}


def phase_report(chunk_batch: int) -> dict:
    log("phase 4: time mpnn_mp at the surrogate chunk shape (f32)")
    gen = torch.Generator(device=DEV).manual_seed(SEED + 2)
    h, e, adj = kernel_inputs(chunk_batch, SPACE.max_atoms, CONFIG.hidden,
                              torch.float32, gen)
    ms = median_ms(lambda: ops.message_pass(h, e, adj, impl="kernel"))
    plain_ms = median_ms(lambda: message_pass_reference(h, e, adj))
    library_ms = median_ms(lambda: torch.einsum("bijkl,bjl,bij->bik", e, h, adj))
    B, N, Hd = h.shape
    moved = sum(t.numel() * t.element_size() for t in (h, e, adj, h))
    flops = 2 * B * N * N * Hd * Hd
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / F32_FLOP_PER_S * 1e3
    log(f"  kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, torch.einsum "
        f"{library_ms:.3f} ms; bound {max(bytes_ms, flops_ms):.3f} ms "
        f"({moved / 2**30:.2f} GiB moved, {flops / 1e9:.2f} GFLOP)")
    return {"ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "library_ms": library_ms, "shape": [B, N, Hd], "dtype": "float32"}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sur = Surrogate(CONFIG, seed=SEED, device=DEV)
    chunk_batch = CONFIG.ensemble * sur.chunk_size(SPACE.max_atoms)
    kernel = phase_kernels(chunk_batch)

    t0 = time.perf_counter()
    feats = featurize(SPACE, range(SPACE.num_molecules))
    log(f"featurized {SPACE.num_molecules} molecules in "
        f"{time.perf_counter() - t0:.1f} s; adjacency density "
        f"{(feats['bonds'] > 0).mean():.4f} of the N*N atom pairs")
    phase_surrogate(sur, feats)
    kernel.update(phase_serve(sur, feats))
    kernel.update(phase_report(chunk_batch))

    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(card)
    log(json.dumps({"kernels": [{
        "name": "mpnn_mp", "route": "cuda",
        "source": "src/repro_torch/kernels/mpnn_mp/mpnn_mp.cu",
        "replaces": "src/repro/kernels/mpnn_mp/mpnn_mp.py:38",
        **kernel}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
