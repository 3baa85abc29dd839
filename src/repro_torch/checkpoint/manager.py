"""Checkpoint manager: background writes, rotation, resume. The port of
``repro/checkpoint/manager.py``.

- ``save`` copies the state to the host before it returns (the train step
  updates the state in place afterwards), then writes on a background
  thread;
- each checkpoint is atomic (``store.save``) and checksummed;
- ``restore`` skips torn/corrupt checkpoints and falls back to older ones;
- rotation keeps the newest ``keep`` checkpoints.
"""
from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Optional

import torch

from repro_torch.checkpoint import store
from repro_torch.utils.trees import tree_map

_STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._pending: Optional[threading.Thread] = None

    # -- write ------------------------------------------------------------

    def save(self, step: int, tree, *, blocking: bool = False) -> None:
        # a finished host copy *now*, so training can mutate state afterwards
        host_tree = tree_map(
            lambda t: torch.as_tensor(t).detach().to("cpu", copy=True), tree)
        self.wait()

        def work():
            path = self._path(step)
            store.save(path, host_tree)
            self._rotate()

        t = threading.Thread(target=work, daemon=True)
        with self._lock:
            self._pending = t
        t.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        with self._lock:
            t = self._pending
        if t is not None:
            t.join()
            with self._lock:
                if self._pending is t:
                    self._pending = None

    # -- read -------------------------------------------------------------

    def steps(self):
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and store.exists(os.path.join(self.directory, name)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, like, step: Optional[int] = None):
        """Restore newest valid checkpoint (or `step`).  Returns
        (step, tree) or (None, None)."""
        candidates = ([step] if step is not None
                      else list(reversed(self.steps())))
        for s in candidates:
            path = self._path(s)
            try:
                return s, store.restore(path, like)
            except Exception:
                continue        # torn write -> fall back to older
        return None, None

    # -- internals ---------------------------------------------------------

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def _rotate(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._path(s), ignore_errors=True)
