"""Time the served re-score: ``rank_space`` over the default 10,000-molecule
space at the surrogate's full width (``mpnn_surrogate.CONFIG``), as
``chip_smoke.py`` phase 3 drives it, each weight moved a little between
requests as a retrain would.

    PYTHONPATH=src python -m repro_torch.launch.time_rescore --requests 5

It calls only entry points that every slice of the port has had since the
re-score was ported, so two checkouts compare on one card by running this
file with PYTHONPATH set to each checkout's ``src`` in turn (A, B, B, A):

    PYTHONPATH=OTHER/src python src/repro_torch/launch/time_rescore.py

One warm-up request runs first. Prints one JSON line: the package file it
imported, the card's name and power limit, and the wall ms of each timed
request (host clock, after a synchronize on the card).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from repro_torch.apps import electrolyte
from repro_torch.configs.mpnn_surrogate import CONFIG
from repro_torch.data.molecules import MoleculeSpace, featurize


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--molecules", type=int, default=10_000)
    ap.add_argument("--kappa", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    space = MoleculeSpace(num_molecules=args.molecules)
    feats = featurize(space, range(space.num_molecules))
    sur = electrolyte.Surrogate(CONFIG, seed=args.seed, device=args.device)
    gen = torch.Generator(device=args.device).manual_seed(args.seed + 1)
    on_cuda = torch.device(args.device).type == "cuda"

    def sync():
        if on_cuda:
            torch.cuda.synchronize()

    electrolyte.rank_space(sur, feats, args.kappa)           # warm-up
    wall_ms, scores = [], []
    for _ in range(args.requests):
        with torch.no_grad():
            for p in sur.model.parameters():
                p.add_(torch.randn(p.shape, generator=gen, device=p.device),
                       alpha=0.01)
        sync()
        t0 = time.perf_counter()
        s, _ = electrolyte.rank_space(sur, feats, args.kappa)
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        scores.append(bool(np.isfinite(s).all()))
    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip() if on_cuda else "cpu"
    print(json.dumps({"package": electrolyte.__file__, "card": card,
                      "molecules": space.num_molecules,
                      "finite": all(scores), "wall_ms": wall_ms}))


if __name__ == "__main__":
    main()
