"""Importing the port settles torch's CPU vector math before any parallel
use: in fresh processes, a first parallel exp, sin, cos, tanh or sqrt after
``import repro_torch`` is as accurate as every later call. Without the
settling call in ``repro_torch/__init__.py`` about one fresh process in
twelve gets some chunks of its first such call accurate only to ~1e-4
relative, so 16 concurrent processes catch its loss most of the time."""
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
PROBE = r"""
import numpy as np
import repro_torch  # noqa: F401
import torch
rng = np.random.default_rng(0)
worst = 0.0
for name in ("exp", "sin", "cos", "tanh", "sqrt"):
    z = rng.standard_normal((2, 4, 4, 64, 64))
    z = np.abs(z) + 0.1 if name == "sqrt" else (-3 * np.abs(z) if name == "exp" else z)
    t = torch.from_numpy(z.astype(np.float32))
    want = getattr(np, name)(t.double().numpy())
    got = getattr(torch, name)(t).double().numpy()
    worst = max(worst, (np.abs(got - want) / np.maximum(np.abs(want), 1e-3)).max())
print(worst)
"""


def test_first_parallel_vector_math_is_accurate():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, "-c", PROBE], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(16)]
    worst = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        worst.append(float(out.split()[-1]))
    assert max(worst) < 1e-6, worst
