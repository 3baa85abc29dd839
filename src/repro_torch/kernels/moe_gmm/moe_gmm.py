"""Binding of the Hopper grouped-matmul kernel (``moe_gmm.cu``), which
replaces ``repro/kernels/moe_gmm/moe_gmm.py::gmm``.

``gmm_cuda`` checks its inputs, allocates the output, launches the kernel
on the current stream and counts the launch in ``LAUNCHES``. It takes CUDA
tensors only; the plain version is ``ref.gmm_reference``. Unlike the TPU
kernel it needs no row count divisible by a block: the kernel masks a
ragged last row tile. D and F must be multiples of 16. ``live`` (G,) bool
marks the groups that hold a token; the kernel writes zeros for the others
and reads none of their weights.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)

LAUNCHES = 0      # kernel launches since the caller last set it to 0


@functools.cache
def library() -> ctypes.CDLL:
    """Build the kernel from ``moe_gmm.cu`` at the first call and bind it."""
    lib = _build.load_library("moe_gmm")
    fn = lib.moe_gmm_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def gmm_cuda(xe, w, live=None):
    """xe (G,M,D) @ w (G,D,F) -> (G,M,F) in xe's dtype; both f32 or both
    bf16, contiguous, on one CUDA device. ``live``: None (every group) or a
    (G,) bool tensor on that device; a group with ``live[g]`` False must
    have all-zero rows of xe, and gets zeros."""
    global LAUNCHES
    if not (xe.is_cuda and w.device == xe.device):
        raise ValueError("gmm_cuda needs both inputs on one CUDA device, got "
                         f"{xe.device}, {w.device}")
    if xe.dtype not in _DTYPES or w.dtype != xe.dtype:
        raise TypeError(f"xe and w must share a dtype in {list(_DTYPES)}, got "
                        f"{xe.dtype}, {w.dtype}")
    if xe.dim() != 3 or w.dim() != 3 or w.shape[0] != xe.shape[0] \
            or w.shape[1] != xe.shape[2]:
        raise ValueError(f"shapes disagree: xe {tuple(xe.shape)}, w "
                         f"{tuple(w.shape)}")
    G, M, D = xe.shape
    F = w.shape[2]
    if G < 1 or M < 1 or D < 16 or F < 16 or D % 16 or F % 16:
        raise ValueError(f"kernel takes G, M >= 1 and D, F multiples of 16, "
                         f"got G={G}, M={M}, D={D}, F={F}")
    for name, t in (("xe", xe), ("w", w)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if live is not None and (live.dtype != torch.bool or live.shape != (G,)
                             or live.device != xe.device
                             or not live.is_contiguous()):
        raise ValueError(f"live must be a contiguous ({G},) bool tensor on "
                         f"{xe.device}, got {live.dtype} {tuple(live.shape)} "
                         f"on {live.device}")
    out = torch.empty(G, M, F, dtype=xe.dtype, device=xe.device)
    with torch.cuda.device(xe.device):
        err = library().moe_gmm_fwd(
            xe.data_ptr(), w.data_ptr(), out.data_ptr(),
            None if live is None else live.data_ptr(), G, M, D, F,
            int(xe.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"moe_gmm kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
