"""Builds the port's CUDA kernels from the sources in this package at first
use, into ``<repo>/build/torch_kernels/<name>/``.

Each kernel source has a plain C interface and includes no PyTorch header.
``nvcc`` compiles it straight into a shared library named after a hash of
the sources and flags (so an edited source is rebuilt and an unchanged one
is not), and the library is bound with ``ctypes``. ``build_libraries``
starts one ``nvcc`` per library, all at once, and waits for all of them.
Nothing is built when a module is imported, and a failed build raises.

The bf16 kernels of ``flash_attention.cu``, ``moe_gmm.cu``,
``mamba2_ssd.cu`` and ``rwkv6_scan.cu`` include the shared Hopper header
``hopper.cuh`` (``HEADERS``): it enters every
library's hash, so an edited header rebuilds them, but it is not a
translation unit of its own. The header encodes TMA tensor maps with the
driver's ``cuTensorMapEncodeTiled``, which it looks up in the loaded
``libcuda.so.1`` with ``dlopen``/``dlsym`` (hence ``-ldl``), so no library
links against ``libcuda``. ``-Xptxas=-v`` makes ``nvcc`` report each
kernel's registers, shared memory and spills; the report is kept beside
the library (``ptxas_report``). ``defines`` (macros passed as ``-D`` flags,
part of the hash) build a variant of a library beside it; the kernels are
built without any, and only ``benchmarks/bench_port_scan_ablation.py``
passes them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "torch_kernels"
CUDA_FLAGS = ["-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-ldl"]

# Sources of each kernel library, relative to ``repro_torch/kernels``.
LIBRARIES = {
    "mpnn_mp": ("mpnn_mp/mpnn_mp.cu",),
    "flash_attention": ("flash_attention/flash_attention.cu",),
    "mamba2_ssd": ("mamba2_ssd/mamba2_ssd.cu",),
    "rwkv6_scan": ("rwkv6_scan/rwkv6_scan.cu",),
    "moe_gmm": ("moe_gmm/moe_gmm.cu",),
}
# Headers the sources include, relative to ``repro_torch/kernels``.
HEADERS = ("hopper.cuh",)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    path = (os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME
            else shutil.which("nvcc"))
    if not path or not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return path


def _flags(defines=()) -> list[str]:
    return [*CUDA_FLAGS, *(f"-D{d}" for d in defines)]


def _target(name: str, defines=()) -> Path:
    digest = hashlib.sha256(" ".join(_flags(defines)).encode())
    for src in LIBRARIES[name] + HEADERS:
        digest.update((KERNELS_DIR / src).read_bytes())
    return BUILD_DIR / name / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_libraries(names=tuple(LIBRARIES), defines=()) -> dict[str, Path]:
    """Compile every library in ``names`` that is not built yet, one ``nvcc``
    process each, all in parallel; return the path of each library."""
    targets = {n: _target(n, defines) for n in names}
    jobs = {}
    for name, target in targets.items():
        if target.exists():
            continue
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(defines), "-o", str(tmp),
               *(str(KERNELS_DIR / s) for s in LIBRARIES[name])]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, target)
    failed = []
    for name, (proc, tmp, target) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{out}")
        else:
            target.with_suffix(".ptxas.txt").write_text(out)
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return targets


def ptxas_report(name: str) -> str:
    """What ``ptxas -v`` said when the current build of ``name`` was made."""
    return _target(name).with_suffix(".ptxas.txt").read_text()


def load_library(name: str, defines=()) -> ctypes.CDLL:
    """Build the library ``name`` if needed and load it."""
    return ctypes.CDLL(str(build_libraries((name,), defines)[name]))
