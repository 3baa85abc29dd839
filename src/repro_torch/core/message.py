"""Task / Result messages with the paper's instrumented lifecycle (§III-C).

Every message carries a Timer recording serialization, queue transit,
dispatch and execution intervals -- the exact components the paper plots in
Fig. 5 -- plus payload sizes, so Thinker policies can reason about
communication overheads at plan time.

Payloads physically pass through pickle on enqueue/dequeue (as they do
through Redis in the paper) -- exactly once per queue hop: serialization
time and payload size are measured from the same bytes that travel, and
ride the queue envelope so the receiver can graft them onto the message's
Timer (see queues.py).  Large values can bypass the queue path via
Value-Server proxies (value_server.py), which is what Fig. 5/6 measure.
"""
from __future__ import annotations

import itertools
import pickle
import uuid
from dataclasses import dataclass, field
from typing import Any, Optional

from repro_torch.utils.timing import Timer, now

_id_counter = itertools.count()


def new_task_id() -> str:
    return f"task-{next(_id_counter)}-{uuid.uuid4().hex[:8]}"


@dataclass
class Task:
    topic: str                   # task type (assay name, "train", ...)
    method: str                  # registered function name at the Task Server
    args: tuple = ()
    kwargs: dict = field(default_factory=dict)
    task_id: str = field(default_factory=new_task_id)
    timer: Timer = field(default_factory=Timer)
    input_size: int = 0          # serialized payload bytes
    retries: int = 0
    is_backup: bool = False      # straggler-mitigation duplicate
    exclude_worker: Optional[str] = None  # backup placement: not this worker
    bounces: int = 0             # times a worker declined (exclusion) so far


@dataclass
class Result:
    task_id: str
    topic: str
    method: str
    success: bool
    value: Any = None
    error: Optional[str] = None
    args: tuple = ()
    kwargs: dict = field(default_factory=dict)
    timer: Timer = field(default_factory=Timer)
    input_size: int = 0
    output_size: int = 0
    worker: Optional[str] = None

    @property
    def task_runtime(self) -> float:
        return self.timer.intervals.get("execute", 0.0)

    def comm_overhead(self) -> float:
        """Total non-execution lifecycle time recorded so far."""
        return sum(v for k, v in self.timer.intervals.items()
                   if k != "execute")


@dataclass
class Intermediate:
    """A mid-task observation published by a worker over the ``stream``
    channel (the streaming-steering lane).  Rides the same single-pickle
    envelope as tasks/results, under the publishing task's trace; the
    Thinker's ``process_intermediate`` hook receives these and may
    ``queues.cancel(task_id)`` losers early to re-steer the capacity."""
    task_id: str
    topic: str
    seq: int                     # 0-based observation index within the task
    value: Any                   # the partial result (small; no shm lane)
    worker: Optional[str] = None


def serialize(obj) -> bytes:
    return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def deserialize(data: bytes):
    return pickle.loads(data)


def timed_serialize(obj, timer: Timer, name: str) -> bytes:
    t0 = now()
    data = serialize(obj)
    timer.record(name, now() - t0)
    return data


def timed_deserialize(data: bytes, timer: Timer, name: str):
    t0 = now()
    obj = deserialize(data)
    timer.record(name, now() - t0)
    return obj
