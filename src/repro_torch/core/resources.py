"""ResourceTracker: pooled resource accounting + reallocation (§III-B1).

Stores a fixed number of resource slots partitioned into named pools
(e.g. "simulation", "inference", "training").  Agent threads acquire and
release slots concurrently; an Allocator agent moves slots between pools
("different colored traffic lights" in the paper's Fig. 2).  Reallocation
of *busy* slots is deferred: the slots transfer as they are released.

On the TPU adaptation a slot is a mesh slice (DESIGN.md §2); the quantum of
reallocation is the largest slice a task type needs, exactly as the paper
reallocates Theta nodes in 4-node increments.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional


class ResourceTracker:
    def __init__(self, pools: Dict[str, int]):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._total = dict(pools)          # slots assigned to each pool
        self._in_use = {p: 0 for p in pools}
        self._pending_moves: list = []     # deferred (src, dst, n)

    # -- queries -------------------------------------------------------------

    def available(self, pool: str) -> int:
        with self._lock:
            return self._total[pool] - self._in_use[pool]

    def allocation(self, pool: str) -> int:
        with self._lock:
            return self._total[pool]

    def utilization(self) -> Dict[str, tuple]:
        with self._lock:
            return {p: (self._in_use[p], self._total[p]) for p in self._total}

    # -- acquire/release -------------------------------------------------------

    def acquire(self, pool: str, n: int = 1,
                timeout: Optional[float] = None) -> bool:
        deadline = None
        if timeout is not None:
            import time
            deadline = time.monotonic() + timeout
        with self._cv:
            while self._total[pool] - self._in_use[pool] < n:
                if deadline is None:
                    self._cv.wait()
                else:
                    import time
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._cv.wait(remaining):
                        if self._total[pool] - self._in_use[pool] >= n:
                            break
                        return False
            self._in_use[pool] += n
            return True

    def release(self, pool: str, n: int = 1) -> None:
        with self._cv:
            self._in_use[pool] -= n
            assert self._in_use[pool] >= 0, (pool, self._in_use[pool])
            self._apply_pending_locked()
            self._cv.notify_all()

    # -- reallocation ----------------------------------------------------------

    def reallocate(self, src: str, dst: str, n: int,
                   block: bool = False) -> int:
        """Move up to n slots src -> dst.  Free slots move immediately; busy
        slots move as they are released (deferred).  Returns slots moved
        immediately."""
        with self._cv:
            free = self._total[src] - self._in_use[src]
            move_now = min(free, n)
            self._total[src] -= move_now
            self._total[dst] += move_now
            deferred = n - move_now
            if deferred > 0:
                self._pending_moves.append([src, dst, deferred])
            self._cv.notify_all()
            if block:
                while any(m[2] > 0 for m in self._pending_moves):
                    self._cv.wait()
            return move_now

    def _apply_pending_locked(self) -> None:
        for move in self._pending_moves:
            src, dst, want = move
            free = self._total[src] - self._in_use[src]
            take = min(free, want)
            if take > 0:
                self._total[src] -= take
                self._total[dst] += take
                move[2] -= take
        self._pending_moves = [m for m in self._pending_moves if m[2] > 0]
