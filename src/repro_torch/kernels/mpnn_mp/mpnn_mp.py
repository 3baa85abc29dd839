"""Bindings of the Hopper MPNN message-step kernels (``mpnn_mp.cu``).

``message_pass_cuda`` takes the dense edge tensor and replaces
``repro/kernels/mpnn_mp/mpnn_mp.py::message_pass_pallas``;
``message_pass_typed_cuda`` takes the bond types and the per-member edge
matrices instead, and builds no edge tensor. Each checks its inputs,
allocates the output, launches its kernel on the current stream and counts
the launch in ``LAUNCHES``. They take CUDA tensors only; the plain versions
are ``ref.message_pass_reference`` and ``ref.message_pass_typed_reference``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

MAX_ATOMS = 32
MAX_HIDDEN = 128
MAX_BOND_TYPES = 4
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
    fn = lib.mpnn_message_pass_typed
    fn.argtypes = ([ctypes.c_void_p] * 5
                   + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
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


def message_pass_typed_cuda(h, bonds, edge_w, adj):
    """h (E*B,N,Hd) or (E,B,N,Hd) f32|bf16; bonds (B,N,N) or (E,B,N,N) int32;
    edge_w (E,nb,Hd*Hd) in h's dtype; adj (B,N,N) or (E,B,N,N) f32; all
    contiguous on one CUDA device -> h's shape and dtype."""
    global LAUNCHES
    E, nb = edge_w.shape[:2]
    N, Hd = h.shape[-2:]
    B = h.shape[0] // E if h.dim() == 3 else h.shape[1]
    if not (h.is_cuda and all(t.device == h.device
                              for t in (bonds, edge_w, adj))):
        raise ValueError("message_pass_typed_cuda needs all inputs on one "
                         f"CUDA device, got {h.device}, {bonds.device}, "
                         f"{edge_w.device}, {adj.device}")
    if h.dtype not in _DTYPES or edge_w.dtype != h.dtype:
        raise TypeError(f"h and edge_w must share a dtype in {list(_DTYPES)}"
                        f", got {h.dtype}, {edge_w.dtype}")
    if bonds.dtype != torch.int32 or adj.dtype != torch.float32:
        raise TypeError(f"bonds must be int32 and adj float32, got "
                        f"{bonds.dtype}, {adj.dtype}")
    lead = {(B, N, N): 0, (E, B, N, N): B * N * N}
    if (h.dim() not in (3, 4) or B * E != math.prod(h.shape[:-2])
            or tuple(edge_w.shape) != (E, nb, Hd * Hd)
            or tuple(bonds.shape) not in lead or tuple(adj.shape) not in lead):
        raise ValueError(f"shapes disagree: h {tuple(h.shape)}, bonds "
                         f"{tuple(bonds.shape)}, edge_w "
                         f"{tuple(edge_w.shape)}, adj {tuple(adj.shape)}")
    if N > MAX_ATOMS or Hd > MAX_HIDDEN or nb > MAX_BOND_TYPES:
        raise ValueError(f"kernel takes N <= {MAX_ATOMS}, Hd <= {MAX_HIDDEN} "
                         f"and nb <= {MAX_BOND_TYPES}, got N={N}, Hd={Hd}, "
                         f"nb={nb}")
    if not all(t.is_contiguous() for t in (h, bonds, edge_w, adj)):
        raise ValueError("message_pass_typed_cuda needs contiguous inputs")
    out = torch.empty_like(h)
    # the library makes h's device current around the launch itself: the
    # re-score launches this once a message step a chunk, and a Python
    # device context and stream object cost more host time than the kernel
    device = h.device.index
    err = library().mpnn_message_pass_typed(
        h.data_ptr(), bonds.data_ptr(), edge_w.data_ptr(), adj.data_ptr(),
        out.data_ptr(), E, B, N, Hd, nb, lead[tuple(bonds.shape)],
        lead[tuple(adj.shape)], _DTYPES[h.dtype], device,
        torch._C._cuda_getCurrentRawStream(device))
    if err:
        raise RuntimeError(f"mpnn_mp typed kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out
