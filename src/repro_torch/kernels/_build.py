"""Builds the port's CUDA kernels from the sources in this package at first
use, into ``<repo>/build/torch_kernels/<name>/``.

Each kernel source has a plain C interface and includes no PyTorch header,
so ``nvcc`` compiles it in seconds; ``torch.utils.cpp_extension.load`` does
the compile and link, and the shared library is then bound with ``ctypes``.
Nothing is built when a module is imported, and a failed build raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "torch_kernels"
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]


def load_library(name: str, *sources: str) -> ctypes.CDLL:
    """Compile ``sources`` (paths relative to ``repro_torch/kernels``) into
    the shared library ``name`` and load it."""
    from torch.utils.cpp_extension import load

    build_dir = BUILD_DIR / name
    build_dir.mkdir(parents=True, exist_ok=True)
    path = load(name=name, sources=[str(KERNELS_DIR / s) for s in sources],
                build_directory=str(build_dir), extra_cuda_cflags=CUDA_FLAGS,
                is_python_module=False, verbose=False)
    return ctypes.CDLL(path)
