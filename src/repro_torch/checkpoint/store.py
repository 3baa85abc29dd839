"""Tree <-> on-disk checkpoint, in the JAX package's format: the port of
``repro/checkpoint/store.py``.

Arrays are flattened with '/'-joined key paths (``utils.trees``) and
written as one ``arrays.npz``; ``manifest.json`` records the keys, each
array's dtype and a checksum (sha256 over the sorted keys and each stored
array's first 64 KiB), so a torn write is detected at restore time. dtypes
numpy's npz cannot hold (bf16, the float8s) are stored as a ``uint8`` byte
view with a trailing itemsize axis, made and read through torch ``view``s.
Writes are atomic: a temp dir, then a rename. A checkpoint written by
either package restores in the other, bit for bit.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.utils.trees import tree_flatten_with_paths, tree_unflatten

MANIFEST = "manifest.json"
SHARD = "arrays.npz"

# dtypes numpy's npz cannot round-trip -> stored as raw byte views
_EXTENDED = {"bfloat16": torch.bfloat16,
             "float8_e4m3fn": torch.float8_e4m3fn,
             "float8_e5m2": torch.float8_e5m2}
_EXTENDED_NAMES = {v: k for k, v in _EXTENDED.items()}


def _to_storable(t: torch.Tensor):
    """(numpy array to store, dtype name)."""
    if t.dtype in _EXTENDED_NAMES:
        raw = t.reshape(-1).view(torch.uint8)
        return (raw.reshape(tuple(t.shape) + (t.element_size(),)).numpy(),
                _EXTENDED_NAMES[t.dtype])
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_storable(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name in _EXTENDED:
        raw = torch.from_numpy(np.ascontiguousarray(arr))
        return raw.reshape(-1).view(_EXTENDED[dtype_name]) \
                  .reshape(arr.shape[:-1])
    return torch.from_numpy(arr)


def _checksum(arrays: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).tobytes()[:1 << 16])
    return h.hexdigest()


def save(path: str, tree) -> None:
    """Atomic checkpoint write (tmp dir + rename) of a tree of tensors on
    any device."""
    flat = [(k, torch.as_tensor(v).detach().cpu().contiguous())
            for k, v in tree_flatten_with_paths(tree)]
    stored = {k: _to_storable(v) for k, v in flat}
    arrays = {k: a for k, (a, _) in stored.items()}
    manifest = {
        "keys": [k for k, _ in flat],
        "dtypes": {k: name for k, (_, name) in stored.items()},
        "checksum": _checksum(arrays),
    }
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=parent, prefix=".ckpt_tmp_")
    try:
        np.savez(os.path.join(tmp, SHARD), **arrays)
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def restore(path: str, like):
    """Restore into the structure of ``like`` (values replaced by the stored
    arrays, in the stored dtype, each on the device of its ``like`` leaf).
    Raises on checksum mismatch."""
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, SHARD)) as z:
        arrays = {k: z[k] for k in manifest["keys"]}
    if _checksum(arrays) != manifest["checksum"]:
        raise IOError(f"checkpoint {path} failed checksum (torn write?)")
    leaves = []
    for key, ref in tree_flatten_with_paths(like):
        t = _from_storable(arrays[key], manifest["dtypes"][key])
        device = ref.device if isinstance(ref, torch.Tensor) else "cpu"
        leaves.append(t.to(device))
    return tree_unflatten(like, leaves)


def exists(path: str) -> bool:
    return (os.path.isdir(path)
            and os.path.exists(os.path.join(path, MANIFEST))
            and os.path.exists(os.path.join(path, SHARD)))
