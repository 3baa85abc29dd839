"""The benchmark's own tests: ``python -m pytest -q portbench/tests`` from the
root of the repository (the ``cuda``-marked ones run only on a card:
``python -m pytest -q -m cuda portbench/tests``)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """Skips the test unless a CUDA device is present (decided when the
    test runs, never when the module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.fixture
def root():
    return ROOT
