"""ProcessPoolTaskServer: registered methods execute in worker OS processes.

The thread-pool ``TaskServer`` gives concurrency; this one gives the
paper's topology -- N *processes* per topic (Parsl workers), true
parallelism for CPU-bound simulation tasks, and per-worker **identity**
(``host/topic/wR/pidP``) so placement decisions are possible.  It requires
the ``proc`` queue backend: the parent (supervisor) and the workers only
ever meet through the broker.

Direct-subscription data plane (no relay in the dispatch path)::

    Thinker --put--> topic requests --get--> worker executes --put--> results
                          ^                     |
                          |  control events     v
                     supervisor  <---- pool@<host>:__control__

Workers subscribe **directly** to the topic's request queue at its home
broker: each worker's leased ``get`` *is* the dispatch, and the lease it
holds across the execution *is* the in-flight record.  The pool parent
never touches an envelope -- it is a pure control-plane supervisor that
watches ``started``/``retry``/``done`` events on a per-host control
channel, keeps runtime history, and schedules straggler backups.  (The
previous design relayed every envelope through a parent intake thread
onto a per-host dispatch queue: one extra broker round-trip per task,
and the parent held a copy of every in-flight payload.)

Straggler mitigation with *placement*: when a task exceeds
``straggler_factor`` x the topic's trailing-median runtime, the
supervisor asks the broker to **clone the leased envelope** back onto
the queue (``Channel.backup`` -- the broker's lease ledger is the only
place the bytes still live), with ``exclude_worker`` (and, when peer
hosts pool the topic, ``exclude_host``) merged into the clone's meta.
An excluded worker that picks the clone up bounces it -- re-puts the
bytes verbatim with a bumped ``bounces`` count and acks, no unpickle --
so an idle *different* worker (on a different host when one exists)
executes the backup.  First completion wins: workers arbitrate via the
claim fused into the result ``put``, so exactly one result per task id
reaches the Thinker even though the racers live in different processes.

Topology awareness: every pool carries a **host identity** (``host=``;
defaults to the real hostname) that prefixes each worker identity and
scopes the pool's control channel (``pool@<host>:__control__``), so each
supervisor monitors exactly its own workers.  ``backup_hosts`` names
peer hosts running pools for the same topics: a straggler backup then
excludes the *whole origin host* (surviving a host-wide slowdown, not
just a slow process -- the paper's Theta runs), falling back to
same-host ``exclude_worker`` bouncing when no peer exists.

Long tasks and leases: each worker runs a heartbeat thread that renews
the request-queue lease at half its timeout while a task executes, so
work that legitimately outlives ``lease_timeout`` keeps its lease
instead of triggering a wasteful redelivery that the claim then has to
dedup.  A SIGKILLed worker stops heartbeating, its lease expires at the
home broker, and the task redelivers to any subscribed worker -- on any
host -- with no supervisor involvement.

Shutdown is a SIGTERM protocol (there are no stop envelopes: a stop
riding a queue shared by every host's workers could land anywhere).  An
idle worker's SIGTERM handler exits the process right there -- the
interrupted blocking ``recv`` would otherwise just resume (PEP 475); a
busy worker finishes its task, observes the flag, flushes and exits.

Fault tolerance mirrors the thread server -- per-task retry with capped
attempts, errors captured into the Result, one-shot Value-Server inputs
released by the winning worker only -- and adds **exactly-once dispatch**
on top of the transport's leases: a worker holds its request-queue
lease for the task's whole execution and only acks after the result is
published, so a worker SIGKILLed mid-task (or a response frame lost with
its connection) leaves an unacked lease that expires and redelivers the
task to a *different* worker.  Completions arbitrate via the claim fused
into the result ``put``, so a redelivery racing a slow-but-alive
original -- like a straggler backup racing its original -- yields exactly
one result per task id.

Workers are **forked** (not spawned): registered methods may be closures
or lambdas, which only fork can inherit.  CPython >= 3.12 warns about
forking a multi-threaded process; the children here never touch the
parent's thread state -- they immediately enter the dispatch loop and
only run stdlib/pickle/numpy plus the registered method -- and every
socket client reconnects per-pid, so the warning is benign for this
usage.  Fork workers *before* starting Thinker agent threads (the
``with pool:`` idiom does this naturally).
"""
from __future__ import annotations

import os
import pickle
import signal
import socket as socketlib
import threading
import time
import traceback
from typing import Callable, Dict, Optional

from repro_torch import observability as obs
from repro_torch.core import message as msg
from repro_torch.core import streaming
from repro_torch.core.queues import ColmenaQueues
from repro_torch.core.task_server import MethodSpec
from repro_torch.core.transport import Envelope
from repro_torch.core.transport.base import BoundedDict
from repro_torch.core.value_server import ValueServer, resolve_tree
from repro_torch.utils.timing import now

_MAX_BOUNCES = 16       # prefer progress over placement after this many

POOL_PREFIX = "pool@"


def dispatch_topic(host: str, topic: str) -> str:
    """The per-host pool channel name for ``topic``.  The direct data
    plane no longer dispatches through these (workers drain the global
    topic queue at its home broker), but the naming -- and
    ``cluster.spec.resolve_home``'s rule homing ``pool@<host>:`` topics
    at that host's broker -- remains for the control channel below and
    for anything host-scoped a deployment wants kept on-host."""
    return f"{POOL_PREFIX}{host}:{topic}"


def control_topic(host: str) -> str:
    """Per-host pool control channel: each supervisor monitors only its
    own workers' events (a shared control topic across hosts would race
    on leases and split events randomly between monitors)."""
    return f"{POOL_PREFIX}{host}:__control__"


def host_of(identity: str) -> str:
    """The host component of a worker identity (``host/topic/wR/pidP``)."""
    return identity.split("/", 1)[0]


class ProcessPoolTaskServer:
    def __init__(self, queues: ColmenaQueues, *, workers_per_topic=2,
                 straggler_factor: Optional[float] = None,
                 straggler_min_history: int = 5, intake_batch: int = 32,
                 history_window: int = 4096,
                 host: Optional[str] = None,
                 backup_hosts: Optional[list] = None):
        """workers_per_topic: an int (uniform) or a {topic: n} dict (a
        cluster host runs only the pools its HostSpec lists, with
        per-topic sizes).  host: this pool's host identity; None uses
        the real hostname.  Simulated hosts sharing one machine pass
        distinct names so placement decisions stay meaningful.
        intake_batch: control-event drain batch size (the name predates
        the direct data plane, when it also sized the intake relay).
        backup_hosts: peer hosts running pools for the same topics --
        a straggler backup excludes the origin host when one exists.
        Either a flat list (every topic) or a {topic: [hosts]} dict (an
        exclusion must only be total when *some* other host pools the
        topic, or the backup would bounce forever)."""
        if queues.backend != "proc":
            raise ValueError(
                "ProcessPoolTaskServer requires ColmenaQueues(backend='proc')"
                " -- worker processes can only reach a socket-backed fabric")
        if isinstance(queues.value_server, ValueServer):
            raise ValueError(
                "an in-process ValueServer is invisible to worker processes;"
                " use transport.shards.ShardedValueServer (or None)")
        self.queues = queues
        self.straggler_factor = straggler_factor
        self.straggler_min_history = straggler_min_history
        self.intake_batch = intake_batch
        self._workers_per_topic = workers_per_topic
        self.host = host or socketlib.gethostname()
        self.backup_hosts = backup_hosts or []
        self._backup_rr = 0                    # round-robin over peers
        self.backup_targets: Dict[str, str] = {}  # task_id -> backup host
        self._methods: Dict[str, MethodSpec] = {}
        self._procs: list = []
        self._threads: list = []
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._straggler_cond = threading.Condition(self._lock)
        self._inflight: Dict[str, dict] = {}   # task_id -> info
        self._runtimes: Dict[str, list] = {}   # topic -> recent runtimes
        # task_id -> [identities that *started* it], for tests/diagnostics;
        # sliding-window bounded (BoundedIdSet's eviction pattern) so the
        # map cannot grow without limit over a long campaign
        self.task_history = BoundedDict(history_window)

    # -- registration ---------------------------------------------------------

    def register(self, fn: Callable, *, topic: Optional[str] = None,
                 name: Optional[str] = None, max_retries: int = 1):
        name = name or fn.__name__
        topic = topic or name
        self._methods[name] = MethodSpec(fn, topic=topic,
                                         max_retries=max_retries)
        return name

    # -- channels -------------------------------------------------------------

    def _request_channel(self, topic: str):
        """The global request queue workers subscribe to -- the same
        channel the Thinker publishes into, reached directly at its home
        broker (``ProcTransport.client_for``)."""
        return self.queues.transport.channel(topic, "requests")

    def _control_channel(self):
        return self.queues.transport.channel(control_topic(self.host),
                                             "events")

    def _n_workers(self, topic: str) -> int:
        if isinstance(self._workers_per_topic, dict):
            return self._workers_per_topic.get(topic, 0)
        return self._workers_per_topic

    # -- lifecycle ------------------------------------------------------------

    def start(self):
        import multiprocessing
        ctx = multiprocessing.get_context("fork")
        topics = self.queues.topics()
        for topic in topics:
            if self._n_workers(topic) == 0:
                continue                    # this host does not pool it
            for rank in range(self._n_workers(topic)):
                p = ctx.Process(target=self._worker_main, args=(topic, rank),
                                daemon=True, name=f"pool-{topic}-w{rank}")
                p.start()
                self._procs.append(p)
        th = threading.Thread(target=self._monitor_loop, daemon=True,
                              name="pool-monitor")
        th.start()
        self._threads.append(th)
        if self.straggler_factor:
            th = threading.Thread(target=self._straggler_loop, daemon=True,
                                  name="pool-straggler")
            th.start()
            self._threads.append(th)
        return self

    def stop(self):
        self._stop.set()
        # SIGTERM is the stop protocol: an idle worker exits inside its
        # handler (its blocked recv would just resume otherwise), a busy
        # one finishes its task first.  There are no stop envelopes --
        # on a queue every host's workers share they could land anywhere.
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        self.queues.wake_all()
        with self._lock:
            self._straggler_cond.notify_all()
        for p in self._procs:
            p.join(timeout=2)
            if p.is_alive():
                p.kill()
        for th in self._threads:
            th.join(timeout=2)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- supervisor (control plane only) --------------------------------------

    def _monitor_loop(self):
        control = self._control_channel()
        while not self._stop.is_set():
            try:
                envs = control.get_batch(self.intake_batch,
                                         cancel=self._stop)
            except (ConnectionError, OSError):
                return                      # broker died: fabric is gone
            if envs:
                # control events are cheap to lose on a crash (the parent
                # dies with its whole bookkeeping): ack up front so a slow
                # scan can never let the lease lapse into redelivery
                control.ack()
            with self._lock:
                for env in envs:
                    kind, tid, identity, topic, value = pickle.loads(env.data)
                    if kind == "started":
                        # the event carries everything a backup decision
                        # needs: start time and the worker's lease id
                        # (which addresses the envelope bytes the broker
                        # still holds).  A backup execution registers
                        # with backup_sent=True so it can never cascade
                        # a backup-of-a-backup.
                        t_start, lease, is_backup = value
                        self._inflight[tid] = {
                            "topic": topic, "started": t_start,
                            "worker": identity, "lease": lease,
                            "backup_sent": is_backup}
                        self.task_history.setdefault(tid, []).append(identity)
                    elif kind == "retry":
                        info = self._inflight.get(tid)
                        if info is not None:
                            info["started"] = None  # queued again, not running
                            info["lease"] = None    # worker acked: lease gone
                    elif kind == "done":
                        self._inflight.pop(tid, None)
                        if value is not None:
                            hist = self._runtimes.setdefault(topic, [])
                            hist.append(value)
                            del hist[:-50]
                if envs:
                    self._straggler_cond.notify_all()

    def _straggler_loop(self):
        while True:
            fire = []
            with self._lock:
                if self._stop.is_set():
                    return
                tnow = now()
                next_deadline = None
                for tid, info in self._inflight.items():
                    if (info["started"] is None or info["backup_sent"]
                            or info["lease"] is None):
                        continue
                    hist = self._runtimes.get(info["topic"], [])
                    if len(hist) < self.straggler_min_history:
                        continue
                    med = sorted(hist)[len(hist) // 2]
                    deadline = info["started"] + self.straggler_factor * med
                    if deadline <= tnow:
                        info["backup_sent"] = True
                        fire.append((tid, dict(info)))
                    elif next_deadline is None or deadline < next_deadline:
                        next_deadline = deadline
                if not fire:
                    if next_deadline is None:
                        self._straggler_cond.wait()
                    else:
                        # recompute now(): tnow predates the O(inflight)
                        # scan above, and waiting next_deadline - tnow
                        # would overshoot a deadline earned during it
                        self._straggler_cond.wait(max(next_deadline - now(),
                                                      0.0))
                    continue
            for tid, info in fire:
                # the supervisor holds no envelope bytes: the broker's
                # lease ledger does.  Ask it to clone the leased original
                # back onto the queue with placement exclusions merged
                # into the clone's meta (``Channel.backup``); the
                # original lease is untouched -- the slow worker may
                # still win, and the claim arbitrates.
                # Topology-aware placement: exclude the *whole origin
                # host* when a peer pools this topic (a whole host can be
                # the straggler -- paper's Theta runs); otherwise exclude
                # just the original worker and let a sibling process take
                # it.  The started events only ever come from this host's
                # own workers, so the origin host is always self.host.
                eligible = (self.backup_hosts.get(info["topic"], [])
                            if isinstance(self.backup_hosts, dict)
                            else self.backup_hosts)
                peers = [h for h in eligible if h != self.host]
                meta_update = {"exclude_worker": info["worker"]}
                if peers:
                    meta_update["exclude_host"] = self.host
                    target = peers[self._backup_rr % len(peers)]
                    self._backup_rr += 1
                else:
                    target = self.host
                try:
                    ok = self._request_channel(info["topic"]).backup(
                        info["lease"], tid, meta_update)
                except (ConnectionError, OSError, RuntimeError):
                    continue                # broker gone / torn down
                if ok:
                    # the recorded target is the intended landing (with
                    # exclude_host any non-origin host may take it; with
                    # two hosts -- the common case -- it is exact)
                    self.backup_targets[tid] = target

    # -- worker side ----------------------------------------------------------

    def _start_heartbeat(self, requests, on_cancelled=None):
        """Worker-side lease keepalive: one daemon thread per worker
        process renews the request-queue lease under execution at half
        the lease timeout, so tasks that legitimately outlive it are
        never redelivered while their worker is demonstrably alive.  The
        main loop publishes the lease id under ``hb_cond``; clearing it
        (task finished) or replacing it (next task) retires the old
        renewal.  A SIGKILL stops the heartbeat with the process --
        expiry-based redelivery is untouched for real deaths.

        The same cadence doubles as the preemption escalation probe:
        each beat asks the broker whether the running task id has been
        cancelled, and ``on_cancelled`` fires when it has.  A task that
        never calls ``report_intermediate`` (so the cooperative fused
        probe never runs) is still preempted within ~lease_timeout/2."""
        hb_cond = threading.Condition()
        current = [None]                    # (lease_id, task_id) or None
        interval = max(self.queues.transport.lease_timeout / 2.0, 0.05)

        def loop():
            while True:
                with hb_cond:
                    while current[0] is None:
                        hb_cond.wait()
                    lid, tid = current[0]
                    hb_cond.wait(interval)
                    still_running = (current[0] is not None
                                     and current[0][0] == lid)
                if still_running:
                    try:
                        # probe before renew: a cancelled task's lease was
                        # already revoked broker-side, so renewing it would
                        # be a wasted round-trip on a dead lease
                        if (on_cancelled is not None and tid is not None
                                and requests.is_cancelled(tid)):
                            on_cancelled(tid)
                            continue
                        # renew from this thread's own connection: leases
                        # are addressed (topic, kind, id), not per-socket.
                        # False = too late (already expired): the claim on
                        # the result put arbitrates, same as a straggler
                        requests.renew(lid)
                    except (ConnectionError, OSError, RuntimeError):
                        pass                # broker gone: worker exits soon

        threading.Thread(target=loop, daemon=True,
                         name="pool-heartbeat").start()

        def set_current(lid, tid=None):
            with hb_cond:
                current[0] = None if lid is None else (lid, tid)
                hb_cond.notify()

        return set_current

    def _worker_flush_and_exit(self):
        # cumulative metrics: the final snapshot supersedes the throttled
        # mid-run ones, so short-lived workers don't under-report
        obs.flush_metrics(force=True)
        vs = self.queues.value_server
        if vs is not None and hasattr(vs, "flush_replication"):
            # drain queued replica fan-outs (async release/put copies)
            # before dying: an op stranded in the background queue would
            # leave a replica holding a copy its primary already deleted
            try:
                vs.flush_replication(timeout=5.0)
            except Exception:               # noqa: BLE001
                pass
        os._exit(0)

    def _worker_main(self, topic: str, rank: int):
        identity = f"{self.host}/{topic}/w{rank}/pid{os.getpid()}"
        requests = self._request_channel(topic)
        control = self._control_channel()
        queues = self.queues
        # fabric-timeline identity (+ clock calibration against the
        # connected broker when tracing is on -- telemetry, never fatal)
        ref, offset = "", None
        if obs.enabled():
            try:
                offset = obs.calibrate(queues.transport.clock_sync)
                ref = obs.addr_str(queues.transport.address)
            except (ConnectionError, OSError, RuntimeError, KeyError,
                    TypeError, ValueError, AttributeError):
                offset = None
        obs.configure(role="worker", host=self.host, ref=ref, offset=offset)
        t_spawn = now()
        busy_total = 0.0
        cache: dict = {}
        stopping = [False]
        busy = [False]
        # preemption cells shared between the main thread (executes the
        # task), the heartbeat thread (probes the broker) and the SIGTERM
        # handler (runs on the main thread): one-cell lists, GIL-atomic
        current_tid = [None]                # task id under execution
        cancel_tid = [None]                 # heartbeat saw this id cancelled
        in_user_fn = [False]                # main thread is inside spec.fn
        cancel_pending = [False]            # deliver at next safe point

        def on_term(signum, frame):
            if cancel_tid[0] is not None and cancel_tid[0] == current_tid[0]:
                # preemption escalation: our own heartbeat signalled us
                # because the broker cancelled the running task.  Raise
                # ONLY while the main thread is inside the user function;
                # interrupting transport code would corrupt a frame
                # mid-send, so elsewhere we set the cooperative flag and
                # let report_intermediate (or the post-execute check)
                # convert it.
                if in_user_fn[0]:
                    raise streaming.TaskCancelled(current_tid[0])
                cancel_pending[0] = True
                return
            stopping[0] = True
            if not busy[0]:
                # idle: the main loop is parked in a blocking recv that
                # would simply *resume* when this handler returns (PEP
                # 475), so the exit must happen here.  No socket I/O from
                # the handler (the parked get owns this thread's
                # connection); an unflushed piggybacked ack just lets a
                # lease expire into a redelivery the claim dedups.
                self._worker_flush_and_exit()

        def on_cancelled(tid):
            # heartbeat thread -> main thread: signal handlers run on the
            # main thread, so a self-SIGTERM is a safe cross-thread
            # interrupt that lands exactly where on_term can judge it
            cancel_tid[0] = tid
            os.kill(os.getpid(), signal.SIGTERM)

        signal.signal(signal.SIGTERM, on_term)
        set_hb = self._start_heartbeat(requests, on_cancelled)
        while True:
            envs = requests.get_batch(1)
            if stopping[0]:
                requests.ack(flush=True)
                self._worker_flush_and_exit()
            if not envs:
                continue
            env = envs[0]
            meta = env.meta
            bounces = meta.get("bounces", 0)
            if ((meta.get("exclude_worker") == identity
                 or meta.get("exclude_host") == self.host)
                    and bounces < _MAX_BOUNCES):
                # backup placement: this envelope must run elsewhere (the
                # excluded worker is by definition still busy with the
                # original).  Bounce the bytes verbatim -- no unpickle --
                # and back off a little so an eligible worker wins the
                # next dequeue race.
                busy[0] = True
                meta = dict(meta)
                meta["bounces"] = bounces + 1
                requests.put(Envelope(env.t_put, env.data, meta))
                requests.ack()              # handed off: the re-put owns it
                busy[0] = False
                if stopping[0]:
                    requests.ack(flush=True)
                    self._worker_flush_and_exit()
                time.sleep(0.002 * (bounces + 1))
                continue
            busy[0] = True
            task = queues._decode_task(env)
            current_tid[0] = task.task_id
            control.put(Envelope(now(), pickle.dumps(
                ("started", task.task_id, identity, task.topic,
                 (now(), requests.held_lease(), meta.get("backup", False)))),
                {}))
            # heartbeat (and cancel probe) across the execution
            set_hb(requests.held_lease(), task.task_id)
            t_task = now()
            cancelled = False
            try:
                self._execute(task, identity, requests, control, cache,
                              in_user_fn, cancel_pending)
            except streaming.TaskCancelled:
                cancelled = True
            finally:
                set_hb(None)
                current_tid[0] = None
                cancel_tid[0] = None
                cancel_pending[0] = False
                in_user_fn[0] = False
                busy_total += now() - t_task
                obs.gauge("worker_busy_frac").set(
                    busy_total / max(now() - t_spawn, 1e-9))
                obs.flush_metrics()
            if cancelled:
                # preempted: the broker's cancel already claimed the id
                # and revoked this lease, so there is nothing to ack --
                # and we must NOT ack: were the interruption ever wrong
                # (stale probe), the unacked lease expires and the task
                # redelivers, preserving at-least-once.  Detach so the
                # channel forgets the dead lease instead of piggybacking
                # a bogus ack on the next frame.
                requests.detach_lease()
                control.put(Envelope(now(), pickle.dumps(
                    ("done", task.task_id, identity, task.topic, None)),
                    {}))
                busy[0] = False
                if stopping[0]:
                    requests.ack(flush=True)
                    self._worker_flush_and_exit()
                continue
            # the task reached a terminal handoff (result published, retry
            # requeued, or duplicate swallowed by the claim): release the
            # request-queue lease.  The ack piggybacks on the next frame
            # this worker sends; dying before it reaches the broker only
            # causes a redelivery whose completion the claim dedups.  Until
            # here the lease stays held, so a SIGKILL mid-execution expires
            # it and the broker redelivers the task to another worker.
            requests.ack()
            busy[0] = False
            if stopping[0]:
                requests.ack(flush=True)
                self._worker_flush_and_exit()

    def _execute(self, task: msg.Task, identity: str, requests, control,
                 cache: dict, in_user_fn: list, cancel_pending: list):
        queues = self.queues
        spec = self._methods[task.method]
        # sampling decision made at send_task rides the envelope meta;
        # _decode_task surfaced it (and the redelivery attempt number)
        # as dynamic attributes
        traced = bool(getattr(task, "trace", False))
        attempt = int(getattr(task, "attempt", 0) or 0)
        runtime = None
        try:
            args = resolve_tree(task.args, queues.value_server, cache,
                                async_start=True)
            kwargs = resolve_tree(task.kwargs, queues.value_server, cache,
                                  async_start=True)
            args = resolve_tree(args, queues.value_server, cache)
            kwargs = resolve_tree(kwargs, queues.value_server, cache)
            if traced:
                # written through to disk BEFORE execute: a SIGKILLed
                # attempt is evidenced by this instant with no closing
                # span, and the redelivered attempt starts its own
                # sub-trace at the next attempt number
                obs.instant(task.task_id, "task_started", attempt=attempt,
                            worker=identity)
            # streaming context: report_intermediate publishes on the
            # topic's stream lane; cancel_pending is the cell the SIGTERM
            # handler flips when the exception could not be raised in
            # place.  in_user_fn brackets spec.fn *strictly*: the handler
            # may only raise while the main thread is inside the user
            # frame (anywhere else could be mid-send on the socket).
            ctx = streaming.TaskContext(
                task.task_id, task.topic,
                stream=queues.stream_channel(task.topic),
                traced=traced, worker=identity,
                cancel_pending=cancel_pending)
            streaming.set_context(ctx)
            t0 = now()
            try:
                in_user_fn[0] = True
                value = spec.fn(*args, **kwargs)
            finally:
                in_user_fn[0] = False
                streaming.clear_context()
            ctx.check_cancelled()       # pending cancel -> unwind, no result
            runtime = now() - t0
            task.timer.record("execute", runtime)
            if traced:
                obs.span(task.task_id, "execute", t0, t0 + runtime,
                         attempt=attempt, worker=identity)
            result = msg.Result(
                task_id=task.task_id, topic=task.topic, method=task.method,
                success=True, value=value, args=task.args,
                kwargs=task.kwargs, timer=task.timer,
                input_size=task.input_size, worker=identity)
        except streaming.TaskCancelled:
            # preemption is not a failure: never the retry path (that
            # would resubmit work the Thinker explicitly culled).  The
            # caller detaches the revoked lease and moves on.
            raise
        except Exception as e:                         # noqa: BLE001
            task.timer.record("execute", 0.0)
            if task.retries < spec.max_retries:
                task.retries += 1
                obs.counter("task_retries").inc()
                data = msg.serialize(task)
                retry_meta = {"input_size": task.input_size,
                              "task_id": task.task_id}
                if traced:
                    # the retry is a fresh attempt: keep it sampled and
                    # bump the attempt number its sub-trace carries
                    retry_meta["trace"] = 1
                    retry_meta["redelivered"] = attempt + 1
                requests.put(Envelope(now(), data, retry_meta))
                # tell the supervisor the attempt ended: clearing
                # 'started' stops the straggler monitor from firing a
                # backup for a task that is queued for retry, not
                # running anywhere
                control.put(Envelope(now(), pickle.dumps(
                    ("retry", task.task_id, identity, task.topic, None)),
                    {}))
                return
            result = msg.Result(
                task_id=task.task_id, topic=task.topic, method=task.method,
                success=False, error=f"{e!r}\n{traceback.format_exc()}",
                args=task.args, kwargs=task.kwargs, timer=task.timer,
                input_size=task.input_size, worker=identity)

        # cross-process first-completion-wins, fused with the publish: the
        # broker claims the id and enqueues the result in one atomic op.
        # Always on (not just under straggler_factor): a lease-expiry
        # redelivery racing a slow-but-alive original is the same race as
        # a straggler backup and needs the same arbitration.
        result.attempt = attempt            # send_result tags its spans
        won = queues.send_result(result, claim_id=task.task_id)
        if won:
            obs.counter("tasks_completed").inc()
            queues.release_task_inputs(task)
        control.put(Envelope(now(), pickle.dumps(
            ("done", task.task_id, identity, task.topic, runtime)), {}))
