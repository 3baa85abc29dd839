"""Binding of the Hopper Mamba2 SSD scan kernel (``mamba2_ssd.cu``), which
replaces ``repro/kernels/mamba2_ssd/mamba2_ssd.py::ssd_pallas``.

``ssd_cuda`` checks its inputs, allocates y and the final state, launches
the kernel on the current stream and counts the launch in ``LAUNCHES``, and
in ``LAUNCHES_BY_DESIGN`` under the kernel the library reports it ran:
bf16 runs on the tensor cores (TMA-fed ``wgmma``, "wgmma+tma"), f32 on
CUDA-core FMA ("fma"). It takes CUDA tensors only; the plain version is
``ref.ssd_chunked``. The contract is the TPU kernel's: ``Q = min(chunk, L)``
must divide L. The f32 kernel works in chunks of Q; the bf16 one in chunks
of 64 whatever Q is (the chunked form is exact in any chunking).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (32, 64)          # P
STATE_DIMS = (16, 32, 64)     # N
MAX_CHUNK = 128
_DTYPES = (torch.float32, torch.bfloat16)

LAUNCHES = 0      # kernel launches since the caller last set it to 0
# the same launches by the kernel that ran (mamba2_ssd_last_design)
DESIGNS = ("fma", "wgmma+tma")
LAUNCHES_BY_DESIGN = dict.fromkeys(DESIGNS, 0)


@functools.cache
def library(defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build the kernel from ``mamba2_ssd.cu`` at the first call and bind
    it. ``defines`` build a timing variant (``_build``); calls of the
    binding use the kernel as written."""
    lib = _build.load_library("mamba2_ssd", defines)
    fn = lib.mamba2_ssd_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.mamba2_ssd_last_design.argtypes = []
    lib.mamba2_ssd_last_design.restype = ctypes.c_int
    return lib


def _tma_ready(t) -> bool:
    """A bf16 tensor TMA can read in place: 16-byte aligned base, strides of
    the three outer dims multiples of 8 elements."""
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])


def ssd_cuda(x, log_a, b, c, initial_state=None, *, chunk: int = 128):
    """x (B,L,H,P); log_a (B,L,H); b/c (B,L,G,N); initial_state (B,H,P,N)
    or None (zeros), all on one CUDA device. x, b and c share a dtype (f32 or
    bf16) and have a contiguous last dim; log_a is f32 or bf16. Returns
    (y (B,L,H,P) in x's dtype, final state (B,H,P,N) f32). In bf16, an x,
    b or c whose base or strides TMA cannot take (say a slice of a packed
    projection at an odd offset) is first copied to a contiguous tensor."""
    global LAUNCHES
    tensors = (x, log_a, b, c) + (() if initial_state is None
                                  else (initial_state,))
    if not (x.is_cuda and all(t.device == x.device for t in tensors)):
        raise ValueError("ssd_cuda needs all inputs on one CUDA device, got "
                         + ", ".join(str(t.device) for t in tensors))
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"x, b and c must share a dtype in {list(_DTYPES)}, "
                        f"got {x.dtype}, {b.dtype}, {c.dtype}")
    if log_a.dtype not in _DTYPES:
        raise TypeError(f"log_a must be one of {list(_DTYPES)}, got "
                        f"{log_a.dtype}")
    if x.dim() != 4 or b.dim() != 4 or b.shape != c.shape:
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)}")
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if (tuple(log_a.shape) != (B, L, H) or tuple(b.shape[:2]) != (B, L)
            or H % G):
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, log_a "
                         f"{tuple(log_a.shape)}, b {tuple(b.shape)}")
    if P not in HEAD_DIMS or N not in STATE_DIMS:
        raise ValueError(f"kernel takes P in {HEAD_DIMS} and N in "
                         f"{STATE_DIMS}, got P={P}, N={N}")
    Q = min(chunk, L)
    if Q > MAX_CHUNK or L % Q:
        raise ValueError(f"chunk {Q} must be <= {MAX_CHUNK} and divide "
                         f"L={L}")
    for name, t in (("x", x), ("b", b), ("c", c)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs a contiguous last dim, got "
                             f"strides {t.stride()}")
    if initial_state is None:
        s0 = torch.zeros(B, H, P, N, dtype=torch.float32, device=x.device)
    else:
        if tuple(initial_state.shape) != (B, H, P, N):
            raise ValueError(f"initial_state {tuple(initial_state.shape)}, "
                             f"expected {(B, H, P, N)}")
        s0 = initial_state.float().contiguous()
    if x.dtype == torch.bfloat16:
        x, b, c = (t if _tma_ready(t)
                   else t.clone(memory_format=torch.contiguous_format)
                   for t in (x, b, c))
    y = torch.empty(B, L, H, P, dtype=x.dtype, device=x.device)
    s_out = torch.empty(B, H, P, N, dtype=torch.float32, device=x.device)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (x, log_a, b, c) for s in t.stride()[:3]))
    with torch.cuda.device(x.device):
        err = library().mamba2_ssd_fwd(
            x.data_ptr(), log_a.data_ptr(), b.data_ptr(), c.data_ptr(),
            s0.data_ptr(), y.data_ptr(), s_out.data_ptr(), B, L, H, G, P, N,
            Q, strides, int(x.dtype == torch.bfloat16),
            int(log_a.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
        design = DESIGNS[library().mamba2_ssd_last_design()]
    if err:
        raise RuntimeError(f"mamba2_ssd kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    LAUNCHES_BY_DESIGN[design] += 1
    return y, s_out
