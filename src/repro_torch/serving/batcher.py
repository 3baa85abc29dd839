"""Micro-batch assembly for the inference shard: pure bookkeeping.

Requests are bucketed by **padded prompt length** (the smallest declared
bucket that fits) so every micro-batch the shard hands to the engine has
one static prompt shape, and batch sizes are padded up to powers of two
(capped at ``max_batch``) so the engine's jitted executables are reused
across calls instead of recompiled per ragged size -- pad-bounded means
the wasted work is bounded by the bucket granularity, never unbounded
ragged padding.

A bucket flushes when it can fill a whole ``max_batch``, when its oldest
request has waited ``max_batch_delay`` (the latency/occupancy knob:
0 serves singles immediately, larger values trade first-token latency
for fuller batches), or on an explicit ``force`` (shutdown drain).

``DecodeGroup`` tracks one prefilled micro-batch through its decode
steps: per-row generation targets, which rows already finished (streamed
back early), and when enough rows have retired that the survivors fit a
strictly smaller batch bucket -- the compaction that makes freed slots
stop costing decode FLOPs and frees capacity for the next admission.

Everything here is plain Python + numpy: no jax, no transport.  The
shard composes it with an engine and a broker channel; the tests drive
it directly.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

DEFAULT_PROMPT_BUCKETS = (16, 32, 64, 128)


def prompt_bucket(length: int, buckets: Sequence[int]) -> int:
    """The smallest declared bucket that fits ``length``."""
    for b in buckets:
        if length <= b:
            return b
    raise ValueError(
        f"prompt length {length} exceeds the largest bucket"
        f" {max(buckets)}; raise ServeSpec.prompt_buckets")


def batch_bucket(n: int, max_batch: int) -> int:
    """Pad a batch size up to the next power of two, capped at
    ``max_batch`` -- the set of batch shapes the engine ever sees (and
    therefore ever compiles) is {1, 2, 4, ..., max_batch}."""
    if n <= 0:
        raise ValueError("empty batch")
    b = 1
    while b < n and b < max_batch:
        b <<= 1
    return min(b, max_batch)


@dataclass
class InferenceRequest:
    """One queued prompt, decoded from its request envelope."""

    task_id: str
    tokens: List[int]
    max_new: int
    enqueue_t: float                      # local receive time (deadlines)
    lease: Optional[int] = None           # detached request-channel lease
    meta: dict = field(default_factory=dict)


@dataclass
class MicroBatch:
    """Requests sharing one padded prompt shape, ready for one prefill."""

    bucket: int                           # padded prompt length
    requests: List[InferenceRequest]

    def padded_tokens(self, padded_b: Optional[int] = None,
                      pad_id: int = 0) -> np.ndarray:
        """(padded_b, bucket) int32 prompt matrix.  Prompts are
        left-padded to the bucket (the generation position must be the
        last *real* token; pad positions participate in attention --
        the same bucketed simplification the engine's docstring
        records).  Batch rows beyond the real requests repeat row 0, so
        padding rows trigger no new compilation and their outputs are
        simply dropped."""
        n = len(self.requests)
        b = n if padded_b is None else padded_b
        out = np.full((b, self.bucket), pad_id, dtype=np.int32)
        for i, r in enumerate(self.requests):
            out[i, self.bucket - len(r.tokens):] = r.tokens
        if b > n:
            out[n:] = out[0]
        return out

    @property
    def max_new(self) -> int:
        return max(r.max_new for r in self.requests)


class MicroBatcher:
    """Accumulates requests into per-bucket queues and decides when a
    micro-batch is worth flushing.  Single-threaded by design: the
    shard's serve loop is the only caller (admission happens between
    decode steps, not concurrently with them)."""

    def __init__(self, *, max_batch: int = 32,
                 prompt_buckets: Sequence[int] = DEFAULT_PROMPT_BUCKETS,
                 max_batch_delay: float = 0.02):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_batch = max_batch
        self.prompt_buckets = tuple(sorted(prompt_buckets))
        self.max_batch_delay = max_batch_delay
        self._pending: Dict[int, List[InferenceRequest]] = {}

    def add(self, req: InferenceRequest) -> None:
        b = prompt_bucket(len(req.tokens), self.prompt_buckets)
        self._pending.setdefault(b, []).append(req)

    def pending_count(self) -> int:
        return sum(len(v) for v in self._pending.values())

    def next_deadline(self) -> Optional[float]:
        """When the oldest pending request must flush (its enqueue time
        plus the delay knob); None with nothing pending.  The serve loop
        bounds its idle wait by this so a partial batch is never
        stranded behind an empty queue."""
        oldest = None
        for reqs in self._pending.values():
            for r in reqs:
                if oldest is None or r.enqueue_t < oldest:
                    oldest = r.enqueue_t
        return None if oldest is None else oldest + self.max_batch_delay

    def pop_ready(self, tnow: float, force: bool = False
                  ) -> List[MicroBatch]:
        """Flush every bucket that can fill a full ``max_batch`` (as
        many times as it can), plus -- when its oldest request is past
        the delay deadline, or ``force`` -- whatever partial batch
        remains.  FIFO within a bucket."""
        out: List[MicroBatch] = []
        for b in sorted(self._pending):
            reqs = self._pending[b]
            while len(reqs) >= self.max_batch:
                out.append(MicroBatch(b, reqs[:self.max_batch]))
                del reqs[:self.max_batch]
            if reqs and (force
                         or tnow >= reqs[0].enqueue_t + self.max_batch_delay):
                out.append(MicroBatch(b, list(reqs)))
                reqs.clear()
            if not reqs:
                del self._pending[b]
        return out


class DecodeGroup:
    """Bookkeeping for one prefilled micro-batch while it decodes.

    Rows share a start position (they were prefilled together at one
    padded prompt length), so per-row progress differs only through
    per-row ``max_new``: a row whose target is reached retires early and
    its tokens stream back immediately.  ``compaction`` reports when the
    surviving rows fit a strictly smaller batch bucket; the shard then
    gathers the engine state down to those rows (slot reuse: retired
    slots stop costing decode compute, and the freed budget admits the
    next prefill sooner)."""

    def __init__(self, mb: MicroBatch, first_tokens: Sequence[int],
                 max_batch: int):
        self.bucket = mb.bucket
        self.max_batch = max_batch
        self.rows = list(mb.requests)
        # rows[i] lives at engine-state batch row slots[i]; the mapping
        # stays identity until a compaction gathers the state down to
        # the survivors (reset_slots), and diverges in between because
        # retired rows leave holes the engine keeps computing
        self.slots = list(range(len(self.rows)))
        self.outputs: List[List[int]] = [[int(first_tokens[s])]
                                         for s in self.slots]
        self.steps = 1                     # tokens generated per live row

    def __len__(self) -> int:
        return len(self.rows)

    @property
    def done(self) -> bool:
        return not self.rows

    def max_remaining(self) -> int:
        return max((r.max_new - self.steps for r in self.rows), default=0)

    def finished(self) -> List[tuple]:
        """(request, generated_tokens) for rows that reached their
        target -- call after the prefill and after every decode step."""
        return [(r, self.outputs[i]) for i, r in enumerate(self.rows)
                if r.max_new <= self.steps]

    def record_step(self, next_tokens: Sequence[int]) -> None:
        """Fold one decode step's per-slot tokens into the outputs.
        Rows already at their target ignore the extra token (the engine
        keeps computing the padded batch; the row is just done)."""
        for i, r in enumerate(self.rows):
            if r.max_new > self.steps:
                self.outputs[i].append(int(next_tokens[self.slots[i]]))
        self.steps += 1

    def retire_finished(self) -> None:
        """Drop finished rows from the bookkeeping.  Their engine slots
        become holes that keep computing until (and unless) a compaction
        gathers the state down to ``self.slots``."""
        keep = [i for i, r in enumerate(self.rows) if r.max_new > self.steps]
        self.rows = [self.rows[i] for i in keep]
        self.outputs = [self.outputs[i] for i in keep]
        self.slots = [self.slots[i] for i in keep]

    def compaction(self, padded_b: int) -> Optional[int]:
        """The smaller padded batch the survivors fit, or None when
        shrinking wouldn't change the executable shape.  ``padded_b`` is
        the engine state's current batch dimension.  On a gather the
        caller re-packs state rows to ``self.slots`` order and then
        calls ``reset_slots``."""
        if not self.rows:
            return None
        target = batch_bucket(len(self.rows), self.max_batch)
        return target if target < padded_b else None

    def reset_slots(self) -> None:
        self.slots = list(range(len(self.rows)))
