"""Host-side prefetching data loader.

A background thread produces step-keyed batches (pure functions of the
step counter, see tokens.py) into a bounded queue, overlapping host data
generation with device compute.  On restore, `start_step` realigns the
stream -- the step->batch mapping is deterministic.
"""
from __future__ import annotations

import queue
import threading


class PrefetchLoader:
    def __init__(self, make_batch_fn, *, start_step: int = 0, depth: int = 2):
        self._fn = make_batch_fn
        self._q = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._fn(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self):
        return self

    def __next__(self):
        step, batch = self._q.get()
        return step, batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
