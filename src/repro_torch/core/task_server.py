"""Task Server: high-throughput dispatch of Thinker requests to workers.

The paper implements this with Parsl over ZeroMQ; here Workers are thread
pools (one pool per task topic, sized by the ResourceTracker allocation)
executing registered Python methods -- which on the TPU adaptation are
jit-compiled mesh programs (warm-compile caches play the role of the
paper's "warmed" Python workers).  For true process parallelism (the
paper's worker topology) see ``repro_torch.core.process_pool.
ProcessPoolTaskServer``, which runs the same registered methods in worker
OS processes over the ``proc`` queue backend and adds per-worker identity
for backup placement; this thread server remains the low-overhead choice
when tasks release the GIL or run on-device.

Dispatch is event-driven: intake threads block on the queue's Condition
and drain batches per wakeup (no 50 ms polling), and the straggler monitor
sleeps until the earliest in-flight duplicate-dispatch *deadline* (or a
new-work notification) rather than spinning on a fixed interval.

Fault tolerance (1000+ node posture):
- per-task retry with capped attempts; errors are captured into the Result
  (never lost),
- straggler mitigation: tasks exceeding `straggler_factor` x the topic's
  trailing-median runtime are duplicated onto a backup worker; first
  completion wins (duplicate results are dropped via a *bounded* dedup
  window -- only ids involved in a backup race are recorded, capped at
  `dedup_window` entries, so long campaigns don't leak memory),
- worker crash simulation hooks for tests (inject_failure).
"""
from __future__ import annotations

import threading
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional

from repro_torch import observability as obs
from repro_torch.core import message as msg
from repro_torch.core import streaming
from repro_torch.core.queues import ColmenaQueues
from repro_torch.core.transport.base import BoundedIdSet as _BoundedIdSet
from repro_torch.core.value_server import resolve_tree
from repro_torch.utils.timing import now


class MethodSpec:
    def __init__(self, fn: Callable, *, topic: str, max_retries: int = 1,
                 slots_per_task: int = 1, pool: Optional[str] = None):
        self.fn = fn
        self.topic = topic
        self.max_retries = max_retries
        self.slots_per_task = slots_per_task
        self.pool = pool or topic


class TaskServer:
    def __init__(self, queues: ColmenaQueues, *, workers_per_topic: int = 4,
                 resources=None, straggler_factor: Optional[float] = None,
                 straggler_min_history: int = 5, dedup_window: int = 4096,
                 intake_batch: int = 32):
        self.queues = queues
        self.resources = resources
        self.straggler_factor = straggler_factor
        self.straggler_min_history = straggler_min_history
        self.intake_batch = intake_batch
        self._methods: Dict[str, MethodSpec] = {}
        self._pools: Dict[str, ThreadPoolExecutor] = {}
        self._workers_per_topic = workers_per_topic
        self._caches: Dict[str, dict] = {}       # per-topic proxy caches
        self._stop = threading.Event()
        self._threads: list = []
        self._runtimes: Dict[str, list] = {}     # topic -> recent runtimes
        self._inflight: Dict[str, dict] = {}     # task_id -> info
        # bounded dedup: only ids involved in a backup race are recorded
        self._raced_ids = _BoundedIdSet(dedup_window)
        self._done_ids = _BoundedIdSet(dedup_window)
        self._lock = threading.Lock()
        # signalled on: task started, task finished, history update, stop
        self._straggler_cond = threading.Condition(self._lock)

    # -- registration ---------------------------------------------------------

    def register(self, fn: Callable, *, topic: Optional[str] = None,
                 name: Optional[str] = None, max_retries: int = 1,
                 slots_per_task: int = 1, pool: Optional[str] = None):
        name = name or fn.__name__
        topic = topic or name
        self._methods[name] = MethodSpec(fn, topic=topic,
                                         max_retries=max_retries,
                                         slots_per_task=slots_per_task,
                                         pool=pool)
        return name

    # -- lifecycle --------------------------------------------------------------

    def start(self):
        topics = self.queues.topics()
        for t in topics:
            self._pools[t] = ThreadPoolExecutor(
                max_workers=self._workers_per_topic,
                thread_name_prefix=f"worker-{t}")
            self._caches[t] = {}
            th = threading.Thread(target=self._intake_loop, args=(t,),
                                  daemon=True, name=f"intake-{t}")
            th.start()
            self._threads.append(th)
        if self.straggler_factor:
            th = threading.Thread(target=self._straggler_loop, daemon=True,
                                  name="straggler-monitor")
            th.start()
            self._threads.append(th)
        return self

    def stop(self):
        self._stop.set()
        self.queues.wake_all()
        with self._lock:
            self._straggler_cond.notify_all()
        for th in self._threads:
            th.join(timeout=2)
        for p in self._pools.values():
            p.shutdown(wait=False, cancel_futures=True)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- internals ----------------------------------------------------------------

    def _intake_loop(self, topic: str):
        while not self._stop.is_set():
            tasks = self.queues.get_tasks(topic, max_n=self.intake_batch,
                                          cancel=self._stop)
            if not tasks:
                continue                    # woken for shutdown; loop checks
            with self._lock:
                for task in tasks:
                    self._inflight[task.task_id] = {
                        "task": task, "started": None, "backup_sent": False}
            for task in tasks:
                self._pools[topic].submit(self._run_task, task)

    def _lost_race_locked(self, task: msg.Task) -> bool:
        return ((task.is_backup or task.task_id in self._raced_ids)
                and task.task_id in self._done_ids)

    def _run_task(self, task: msg.Task):
        spec = self._methods[task.method]
        tid = threading.current_thread().name
        with self._lock:
            if self._lost_race_locked(task):
                return                      # backup lost the race pre-start
            info = self._inflight.get(task.task_id)
            if info is not None:
                info["started"] = now()
                self._straggler_cond.notify_all()
        cache = self._caches.get(task.topic, {})
        acquired = False
        try:
            if self.resources is not None:
                self.resources.acquire(spec.pool, spec.slots_per_task)
                acquired = True
            # async proxy resolution overlaps with worker start-up
            args = resolve_tree(task.args, self.queues.value_server, cache,
                                async_start=True)
            kwargs = resolve_tree(task.kwargs, self.queues.value_server,
                                  cache, async_start=True)
            args = resolve_tree(args, self.queues.value_server, cache)
            kwargs = resolve_tree(kwargs, self.queues.value_server, cache)
            if getattr(task, "trace", False):
                obs.instant(task.task_id, "task_started",
                            attempt=getattr(task, "attempt", 0), worker=tid)
            # streaming context: the user function's report_intermediate
            # publishes on the topic's stream lane and raises
            # TaskCancelled the moment the Thinker culls this task
            # (cooperative-only on the thread server -- no process to
            # signal)
            ctx = streaming.TaskContext(
                task.task_id, task.topic,
                stream=self.queues.stream_channel(task.topic),
                traced=bool(getattr(task, "trace", False)), worker=tid)
            streaming.set_context(ctx)
            t0 = now()
            try:
                value = spec.fn(*args, **kwargs)
            finally:
                streaming.clear_context()
            runtime = now() - t0
            task.timer.record("execute", runtime)
            if getattr(task, "trace", False):
                obs.span(task.task_id, "execute", t0, t0 + runtime,
                         attempt=getattr(task, "attempt", 0), worker=tid)
            result = msg.Result(
                task_id=task.task_id, topic=task.topic, method=task.method,
                success=True, value=value, args=task.args,
                kwargs=task.kwargs, timer=task.timer,
                input_size=task.input_size, worker=tid)
            with self._lock:
                hist = self._runtimes.setdefault(task.topic, [])
                hist.append(runtime)
                del hist[:-50]
                self._straggler_cond.notify_all()
        except streaming.TaskCancelled:
            # preempted mid-execution: the cancel already claimed the id
            # and revoked broker state -- publish nothing, retry nothing
            # (routing this into the retry path would resubmit work the
            # Thinker explicitly culled)
            with self._lock:
                self._inflight.pop(task.task_id, None)
                self._straggler_cond.notify_all()
            return
        except Exception as e:                         # noqa: BLE001
            task.timer.record("execute", 0.0)
            with self._lock:
                lost = self._lost_race_locked(task)
            if lost:
                return                      # winner already delivered
            if task.retries < spec.max_retries:
                task.retries += 1
                with self._lock:
                    self._inflight.pop(task.task_id, None)
                if acquired and self.resources is not None:
                    self.resources.release(spec.pool, spec.slots_per_task)
                    acquired = False
                self.queues.requeue(task)
                return
            result = msg.Result(
                task_id=task.task_id, topic=task.topic, method=task.method,
                success=False, error=f"{e!r}\n{traceback.format_exc()}",
                args=task.args, kwargs=task.kwargs, timer=task.timer,
                input_size=task.input_size, worker=tid)
        finally:
            if acquired and self.resources is not None:
                self.resources.release(spec.pool, spec.slots_per_task)

        with self._lock:
            raced = task.is_backup or task.task_id in self._raced_ids
            if raced:
                if task.task_id in self._done_ids:
                    return                  # duplicate (straggler backup)
                self._done_ids.add(task.task_id)
            self._inflight.pop(task.task_id, None)
            self._straggler_cond.notify_all()
        result.attempt = getattr(task, "attempt", 0)  # tags result spans
        self.queues.send_result(result)
        # only the race *winner* gets here (dedup), and a losing duplicate
        # that resolves afterwards fails into the lost-race drop path, so
        # releasing is safe even for straggler backups
        self.queues.release_task_inputs(task)

    def _straggler_loop(self):
        while True:
            fire = []
            with self._lock:
                if self._stop.is_set():
                    return
                tnow = now()
                next_deadline = None
                for _, info in self._inflight.items():
                    if info["started"] is None or info["backup_sent"]:
                        continue
                    task = info["task"]
                    hist = self._runtimes.get(task.topic, [])
                    if len(hist) < self.straggler_min_history:
                        continue
                    med = sorted(hist)[len(hist) // 2]
                    deadline = info["started"] + self.straggler_factor * med
                    if deadline <= tnow:
                        info["backup_sent"] = True
                        self._raced_ids.add(task.task_id)
                        fire.append(task)
                    elif next_deadline is None or deadline < next_deadline:
                        next_deadline = deadline
                if not fire:
                    # sleep until the earliest duplicate-dispatch deadline,
                    # or until new work starts / history changes / stop.
                    # now() is recomputed: tnow predates the O(inflight)
                    # scan, and waiting next_deadline - tnow would
                    # overshoot a deadline earned during it
                    if next_deadline is None:
                        self._straggler_cond.wait()
                    else:
                        self._straggler_cond.wait(max(next_deadline - now(),
                                                      0.0))
                    continue
            for task in fire:
                backup = msg.Task(topic=task.topic, method=task.method,
                                  args=task.args, kwargs=task.kwargs,
                                  task_id=task.task_id, is_backup=True)
                self._pools[task.topic].submit(self._run_task, backup)
