"""Binding of the Hopper RWKV6 WKV scan kernel (``rwkv6_scan.cu``), which
replaces ``repro/kernels/rwkv6_scan/rwkv6_scan.py::wkv6_pallas``.

``wkv6_cuda`` checks its inputs, allocates y and the final state, launches
the kernel on the current stream and counts the launch in ``LAUNCHES``, and
in ``LAUNCHES_BY_DESIGN`` under the kernel the library reports it ran:
bf16 runs the chunked form on the tensor cores ("mma"), f32 the exact
per-step recurrence on CUDA-core FMA ("fma"). It takes CUDA tensors only;
the plain version is ``ref.wkv6_chunked`` (``ref.wkv6_subchunked`` is the
bf16 kernel's arrangement in f32). The contract is the TPU kernel's:
``Q = min(chunk, L)`` must divide L. Both kernels are exact in any
chunking (the bf16 one works in chunks of 32 whatever Q is), so Q decides
nothing but which prompts are accepted.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

HEAD_SIZES = (32, 64)         # K = V
MAX_CHUNK = 64
_DTYPES = (torch.float32, torch.bfloat16)

LAUNCHES = 0      # kernel launches since the caller last set it to 0
# the same launches by the kernel that ran (rwkv6_scan_last_design)
DESIGNS = ("fma", "mma")
LAUNCHES_BY_DESIGN = dict.fromkeys(DESIGNS, 0)


@functools.cache
def library(defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build the kernel from ``rwkv6_scan.cu`` at the first call and bind
    it. ``defines`` build a timing variant (``_build``); calls of the
    binding use the kernel as written."""
    lib = _build.load_library("rwkv6_scan", defines)
    fn = lib.rwkv6_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.rwkv6_scan_last_design.argtypes = []
    lib.rwkv6_scan_last_design.restype = ctypes.c_int
    return lib


def _async_ready(t) -> bool:
    """A tensor the bf16 kernel's 16-byte cp.async loads can read in place:
    16-byte aligned base, byte strides of the three outer dims multiples of
    16."""
    return (t.data_ptr() % 16 == 0
            and all(s * t.element_size() % 16 == 0 for s in t.stride()[:3]))


def wkv6_cuda(r, k, v, log_w, u, initial_state=None, *, chunk: int = 64):
    """r/k/log_w (B,L,H,K); v (B,L,H,V); u (H,K); initial_state (B,H,K,V)
    or None (zeros), all on one CUDA device. r, k and v share a dtype (f32
    or bf16) and, like log_w (f32 or bf16), have a contiguous last dim.
    Returns (y (B,L,H,V) in r's dtype, final state (B,H,K,V) f32). In bf16,
    an r, k, v or log_w whose base or strides the kernel's 16-byte loads
    cannot take (say a slice of a packed projection at an odd offset) is
    first copied to a contiguous tensor."""
    global LAUNCHES
    tensors = (r, k, v, log_w, u) + (() if initial_state is None
                                     else (initial_state,))
    if not (r.is_cuda and all(t.device == r.device for t in tensors)):
        raise ValueError("wkv6_cuda needs all inputs on one CUDA device, got "
                         + ", ".join(str(t.device) for t in tensors))
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"r, k and v must share a dtype in {list(_DTYPES)}, "
                        f"got {r.dtype}, {k.dtype}, {v.dtype}")
    if log_w.dtype not in _DTYPES:
        raise TypeError(f"log_w must be one of {list(_DTYPES)}, got "
                        f"{log_w.dtype}")
    if r.dim() != 4 or k.shape != r.shape or log_w.shape != r.shape:
        raise ValueError(f"shapes disagree: r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, log_w {tuple(log_w.shape)}")
    B, L, H, K = r.shape
    if tuple(v.shape[:3]) != (B, L, H) or v.dim() != 4:
        raise ValueError(f"shapes disagree: r {tuple(r.shape)}, v "
                         f"{tuple(v.shape)}")
    if tuple(u.shape) != (H, K):
        raise ValueError(f"u {tuple(u.shape)}, expected {(H, K)}")
    V = v.shape[3]
    if K not in HEAD_SIZES or V != K:
        raise ValueError(f"kernel takes K = V in {HEAD_SIZES}, got K={K}, "
                         f"V={V}")
    Q = min(chunk, L)
    if Q > MAX_CHUNK or Q < 1 or L % Q:
        raise ValueError(f"chunk {Q} must be <= {MAX_CHUNK} and divide "
                         f"L={L}")
    for name, t in (("r", r), ("k", k), ("v", v), ("log_w", log_w)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs a contiguous last dim, got "
                             f"strides {t.stride()}")
    if initial_state is None:
        s0 = torch.zeros(B, H, K, V, dtype=torch.float32, device=r.device)
    else:
        if tuple(initial_state.shape) != (B, H, K, V):
            raise ValueError(f"initial_state {tuple(initial_state.shape)}, "
                             f"expected {(B, H, K, V)}")
        s0 = initial_state.float().contiguous()
    uf = u.float().contiguous()
    if r.dtype == torch.bfloat16:
        r, k, v, log_w = (t if _async_ready(t)
                          else t.clone(memory_format=torch.contiguous_format)
                          for t in (r, k, v, log_w))
    y = torch.empty(B, L, H, V, dtype=r.dtype, device=r.device)
    s_out = torch.empty(B, H, K, V, dtype=torch.float32, device=r.device)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (r, k, v, log_w) for s in t.stride()[:3]))
    with torch.cuda.device(r.device):
        err = library().rwkv6_scan_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
            uf.data_ptr(), s0.data_ptr(), y.data_ptr(), s_out.data_ptr(),
            B, L, H, K, strides, int(r.dtype == torch.bfloat16),
            int(log_w.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
        design = DESIGNS[library().rwkv6_scan_last_design()]
    if err:
        raise RuntimeError(f"rwkv6_scan kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    LAUNCHES_BY_DESIGN[design] += 1
    return y, s_out
