"""Worker-side streaming context: ``report_intermediate`` + cooperative
cancel (the task-function half of the streaming-steering lane).

A task function running under a streaming-aware task server publishes
mid-task observations and becomes preemptible between publishes::

    from repro_torch.core import streaming

    def simulate(mol, steps):
        for i in range(steps):
            partial = advance(mol)
            # rides the topic's ``stream`` channel under the task's
            # lease; raises TaskCancelled the moment the Thinker culls
            # this task (the publish is fused with the cancel probe)
            streaming.report_intermediate(partial)
        return finish(mol)

The task server installs a ``TaskContext`` around the user function
(thread-local, so nested/parallel executions cannot cross wires) and
catches ``TaskCancelled``: no result is published and the dispatch lease
is detached, never acked -- a genuinely cancelled task's lease was
already revoked broker-side, and a wrongly-interrupted one redelivers
via lease expiry, so exactly-once is preserved either way.  Outside a
task server (plain function call, unit test) ``report_intermediate`` is
a no-op, so task functions stay runnable anywhere.
"""
from __future__ import annotations

import threading
from typing import Optional

from repro_torch import observability as obs
from repro_torch.core.message import Intermediate, serialize
from repro_torch.core.transport.base import Channel, Envelope
from repro_torch.utils.timing import now


class TaskCancelled(Exception):
    """The current task was preempted (broker-side ``cancel``): unwind
    out of the user function now.  Task servers catch this above the
    user frame -- it must never be swallowed into the retry path."""


class TaskContext:
    """Per-execution streaming state.  ``cancel_pending`` is a one-cell
    list shared with the worker's signal/heartbeat machinery: it flips
    True when a cancel arrives at a moment the exception cannot be
    raised (outside the user function), and the next
    ``report_intermediate`` converts it."""

    def __init__(self, task_id: str, topic: str,
                 stream: Optional[Channel] = None, traced: bool = False,
                 worker: Optional[str] = None,
                 cancel_pending: Optional[list] = None):
        self.task_id = task_id
        self.topic = topic
        self.stream = stream            # the topic's ``stream`` channel
        self.traced = bool(traced)
        self.worker = worker
        self.cancel_pending = (cancel_pending if cancel_pending is not None
                               else [False])
        self.seq = 0

    def check_cancelled(self) -> None:
        if self.cancel_pending[0]:
            raise TaskCancelled(self.task_id)

    def report_intermediate(self, value) -> None:
        self.check_cancelled()
        if self.stream is None:
            return
        msg = Intermediate(task_id=self.task_id, topic=self.topic,
                           seq=self.seq, value=value, worker=self.worker)
        self.seq += 1
        t0 = now()
        data = serialize(msg)
        meta = {"task_id": self.task_id, "seq": msg.seq}
        if self.traced:
            meta["trace"] = True
        cancelled = self.stream.put_stream(Envelope(now(), data, meta),
                                           self.task_id)
        if cancelled:
            # the fused probe says this task is already cancelled: the
            # observation was dropped broker-side -- abort here
            raise TaskCancelled(self.task_id)
        obs.counter("observations").inc()
        if self.traced:
            obs.span(self.task_id, "report_intermediate", t0, now(),
                     seq=msg.seq)


_tls = threading.local()


def set_context(ctx: Optional[TaskContext]) -> None:
    _tls.ctx = ctx


def clear_context() -> None:
    _tls.ctx = None


def current_context() -> Optional[TaskContext]:
    return getattr(_tls, "ctx", None)


def report_intermediate(value) -> None:
    """Publish a mid-task observation onto the executing task's stream
    lane.  Raises ``TaskCancelled`` when the task has been preempted
    (pending cooperative flag, or the fused publish-probe's answer).
    Outside a streaming-aware task server this is a no-op."""
    ctx = current_context()
    if ctx is not None:
        ctx.report_intermediate(value)


__all__ = ["TaskCancelled", "TaskContext", "set_context", "clear_context",
           "current_context", "report_intermediate"]
