"""Typed array codec: device/host arrays as raw buffers, not pickles.

The Value Server moves simulation payloads, and for ML-in-the-loop
campaigns those are overwhelmingly dense arrays -- jax device arrays and
numpy ndarrays.  ``pickle.dumps`` of an array detours the body through
pickle's frame machinery (an extra copy, opcode framing, and a
deserialize that reassembles the buffer from pickled chunks).  This
codec writes the body as its raw contiguous buffer behind a tiny typed
header instead::

    b"NDC1" | uint32 header_len (BE) | pickled {dtype, shape, kind} | buffer

Only the *header* dict (three small scalars) is pickled; the array body
is ``tobytes()`` on encode and a zero-copy ``np.frombuffer`` view on
decode.  Device arrays come to the host via ``np.from_dlpack`` where
available (zero-copy on CPU backends), falling back to ``np.asarray``;
``kind == "jax"`` round-trips back to a device array when jax is
importable in the consumer.  Pickle streams (protocol >= 2) always start
with ``b"\\x80"``, so the magic can never be mistaken for one.

``encode`` answers None for anything it does not handle -- object
dtypes, non-arrays -- and callers fall back to pickle; ``decode``
likewise falls through to ``pickle.loads`` for unmagic'd bytes, so
stored values are self-describing and the codec can be toggled per
client without a migration.
"""
from __future__ import annotations

import pickle
import struct
from typing import Optional

import numpy as np

MAGIC = b"NDC1"
_LEN = struct.Struct(">I")
# the typed header's fixed overhead: magic + length word + a small
# pickled dict; used by sizers that must not pickle the body
HEADER_PAD = 96


def _as_host_array(value):
    """(host_ndarray, kind) for a codec-eligible value, else (None, None).
    Only numpy arrays are eligible: a torch tensor falls back to pickle,
    so payloads leave the device as numpy before they are sent."""
    if isinstance(value, np.ndarray):
        return value, "np"
    return None, None


def nbytes_of(value) -> Optional[int]:
    """Serialized size of a codec-eligible value without touching
    pickle; None if ``encode`` would decline it.  Lets proxy-threshold
    sizers and store accounting stay pickle-free for arrays."""
    arr, _kind = _as_host_array(value)
    if arr is None or arr.dtype.hasobject:
        return None
    return arr.nbytes + HEADER_PAD


def encode(value) -> Optional[bytes]:
    """The typed wire bytes for an array value, or None to tell the
    caller to pickle (anything that is not a dense non-object array)."""
    arr, kind = _as_host_array(value)
    if arr is None or arr.dtype.hasobject:
        return None
    arr = np.ascontiguousarray(arr)
    head = pickle.dumps({"dtype": arr.dtype.str, "shape": arr.shape,
                         "kind": kind}, protocol=pickle.HIGHEST_PROTOCOL)
    return b"".join((MAGIC, _LEN.pack(len(head)), head,
                     arr.tobytes(order="C")))


def decode(data: bytes):
    """Inverse of ``encode``; plain pickles pass through ``pickle.loads``
    untouched.  The numpy result is a read-only zero-copy view over
    ``data``, whatever the frame's kind (a "jax" frame written by the
    JAX package decodes to the host view -- same numbers, host memory)."""
    if not data.startswith(MAGIC):
        return pickle.loads(data)
    off = len(MAGIC) + _LEN.size
    hlen = _LEN.unpack_from(data, len(MAGIC))[0]
    meta = pickle.loads(data[off:off + hlen])
    arr = np.frombuffer(data, dtype=np.dtype(meta["dtype"]),
                        offset=off + hlen).reshape(meta["shape"])
    return arr
