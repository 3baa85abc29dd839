"""Binding of the Hopper MPNN message-step kernel (``mpnn_mp.cu``), which
replaces ``repro/kernels/mpnn_mp/mpnn_mp.py::message_pass_pallas``.

``message_pass_cuda`` checks its inputs, allocates the output, launches the
kernel on the current stream and counts the launch in ``LAUNCHES``. It takes
CUDA tensors only; the plain version is ``ref.message_pass_reference``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

MAX_ATOMS = 32
MAX_HIDDEN = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = 0      # kernel launches since the caller last set it to 0


@functools.cache
def library() -> ctypes.CDLL:
    """Build the kernel from ``mpnn_mp.cu`` at the first call and bind it."""
    lib = _build.load_library("mpnn_mp")
    fn = lib.mpnn_message_pass
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def message_pass_cuda(h, edge_mat, adj):
    """h (B,N,Hd) f32|bf16; edge_mat (B,N,N,Hd,Hd) in h's dtype; adj (B,N,N)
    f32; all contiguous on one CUDA device -> (B,N,Hd) in h's dtype."""
    global LAUNCHES
    B, N, Hd = h.shape
    if not (h.is_cuda and edge_mat.device == h.device
            and adj.device == h.device):
        raise ValueError("message_pass_cuda needs all inputs on one CUDA "
                         f"device, got {h.device}, {edge_mat.device}, "
                         f"{adj.device}")
    if h.dtype not in _DTYPES or edge_mat.dtype != h.dtype:
        raise TypeError(f"h and edge_mat must share a dtype in "
                        f"{list(_DTYPES)}, got {h.dtype}, {edge_mat.dtype}")
    if adj.dtype != torch.float32:
        raise TypeError(f"adj must be float32, got {adj.dtype}")
    if (tuple(edge_mat.shape) != (B, N, N, Hd, Hd)
            or tuple(adj.shape) != (B, N, N)):
        raise ValueError(f"shapes disagree: h {tuple(h.shape)}, edge_mat "
                         f"{tuple(edge_mat.shape)}, adj {tuple(adj.shape)}")
    if N > MAX_ATOMS or Hd > MAX_HIDDEN:
        raise ValueError(f"kernel takes N <= {MAX_ATOMS} and Hd <= "
                         f"{MAX_HIDDEN}, got N={N}, Hd={Hd}")
    if not (h.is_contiguous() and edge_mat.is_contiguous()
            and adj.is_contiguous()):
        raise ValueError("message_pass_cuda needs contiguous inputs")
    out = torch.empty_like(h)
    with torch.cuda.device(h.device):
        err = library().mpnn_message_pass(
            h.data_ptr(), edge_mat.data_ptr(), adj.data_ptr(),
            out.data_ptr(), B, N, Hd, _DTYPES[h.dtype],
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"mpnn_mp kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
