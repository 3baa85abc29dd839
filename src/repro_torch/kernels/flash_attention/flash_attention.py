"""Binding of the Hopper flash-attention kernel (``flash_attention.cu``),
which replaces ``repro/kernels/flash_attention/flash_attention.py::
flash_attention``.

``flash_attention_cuda`` checks its inputs, allocates the output, launches
the kernel on the current stream and counts the launch in ``LAUNCHES``. It
takes CUDA tensors only; the plain version is ``ref.attention_reference``.
Unlike the TPU kernel it needs no ``Sq % block_q == 0``: the kernel masks a
ragged last tile. bf16 runs on the tensor cores (TMA-fed ``wgmma``), f32 on
CUDA-core FMA, at head dims 32, 64, 128 and 256 (gemma2). Any other head
dim that is a multiple of 8 and at most 256 (kimi-k2's 112) is zero-padded
to the next of those four: zero columns change neither q.k nor the first hd
columns of the output, so with the true ``hd ** -0.5`` the result is exact,
at the padded launch's bytes and FLOPs.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = 0      # kernel launches since the caller last set it to 0


@functools.cache
def library() -> ctypes.CDLL:
    """Build the kernel from ``flash_attention.cu`` at the first call and
    bind it."""
    lib = _build.load_library("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                      ctypes.c_int, ctypes.c_float, ctypes.c_int,
                      ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None,
                         softcap: Optional[float] = None, q_offset: int = 0):
    """q (B,Sq,H,hd); k/v (B,Sk,KVH,hd), all f32 or all bf16 on one CUDA
    device, head dim contiguous -> (B,Sq,H,hd) in q's dtype."""
    global LAUNCHES
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share a dtype in {list(_DTYPES)}, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    _, Sk, KVH, _ = k.shape
    if k.shape[0] != B or k.shape[3] != hd or H % KVH:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if hd % 8 or hd > HEAD_DIMS[-1]:
        raise ValueError(f"kernel takes head_dim in {HEAD_DIMS}, or a "
                         f"multiple of 8 below {HEAD_DIMS[-1]} padded to the "
                         f"next of them, got {hd}")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_cuda needs all inputs on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if B * H > 65535:
        raise ValueError(f"kernel takes B*H <= 65535, got {B * H}")
    scale = hd ** -0.5
    kd = next(d for d in HEAD_DIMS if d >= hd)   # the head dim launched
    if kd != hd:
        q, k, v = (F.pad(t, (0, kd - hd)) for t in (q, k, v))
    # f32: float4 loads; bf16: TMA boxes. Either way the head dim is
    # contiguous, the base 16-byte aligned and every stride a multiple of
    # 16 bytes (4 f32 or 8 bf16 elements). Nothing is copied to get there.
    align = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.stride(3) != 1 or any(s % align for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"{name} needs a contiguous head dim, a 16-byte "
                             f"aligned base and strides that are multiples "
                             f"of {align} elements, got strides {t.stride()}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    out = torch.empty(B, Sq, H, kd, dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        err = library().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Sk, H, KVH, kd, strides, int(causal),
            0 if window is None else window,
            0.0 if softcap is None else softcap, q_offset, scale,
            _DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return out if kd == hd else out[..., :hd]
