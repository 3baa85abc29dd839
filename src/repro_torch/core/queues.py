"""Per-topic request/result queue pairs (the paper's Redis topology).

The Thinker writes Tasks to the request queue of a topic; the Task Server
reads them, executes, and writes Results to the topic's result queue.
Distinct queue pairs per task type simplify multi-agent Thinkers (§III-B3).

Messages physically traverse pickle bytes so the serialization /
communication costs the paper measures are real, not simulated.  Each
message is serialized **exactly once** per queue hop: the pickled payload
travels inside a tiny envelope that carries the enqueue timestamp plus the
serialization time / payload size measured from those same bytes, and the
receiver grafts them onto the deserialized message's Timer.

*Where* the envelope waits is a pluggable transport backend
(``repro_torch.core.transport``):

- ``backend="local"`` -- in-process ``Condition``-notified deques:
  consumers block until a producer notifies them, ``wake_all()`` nudges
  every blocked consumer so shutdown events propagate immediately, and
  batched drains (``get_tasks`` / ``get_results``) amortize wakeups.
- ``backend="proc"`` -- the envelope's single-pickle bytes become a
  socket frame to a broker process, so Thinker and Task Server can be
  different OS processes (the paper's multi-process topology) with the
  exact same call-site API and the same blocking/batching semantics.

A configurable proxy threshold transparently moves large values through the
Value Server instead (lazy object proxies); those one-shot entries are
refcounted and released once their single consumer resolves them.

Delivery is leased on both backends (``transport.base.Channel``): the
queue-level ``get_*`` helpers ack as soon as a batch is decoded and
handed to the caller, while raw-channel consumers (pool workers) hold
their lease across execution -- either way an unacked batch redelivers
after ``lease_timeout``, and ``checkpoint(path)``/``resume(path)``
persist the whole fabric (queued + in-flight envelopes, claim window,
active count) so a killed campaign restarts without resubmission.
"""
from __future__ import annotations

import os
import pickle
import tempfile
import threading
from typing import Iterable, List, Optional

from repro_torch import observability as obs
from repro_torch.core import message as msg
from repro_torch.core.transport import Envelope, Transport, make_transport
from repro_torch.core.value_server import iter_proxies, proxy_tree, resolve_tree
from repro_torch.utils.timing import now


class TopicQueue:
    def __init__(self, transport: Transport, topic: str):
        self.requests = transport.channel(topic, "requests")
        self.results = transport.channel(topic, "results")
        # mid-task observations (streaming steering): workers publish
        # via the fused ``put_stream`` under the task's lease, Thinkers
        # drain via ``get_intermediates`` / ``process_intermediate``
        self.stream = transport.channel(topic, "stream")


class ColmenaQueues:
    """The Thinker <-> Task Server communication fabric."""

    def __init__(self, topics: Iterable[str], *,
                 backend: str = "local",
                 transport: Optional[Transport] = None,
                 value_server=None,
                 proxy_threshold: Optional[int] = None,
                 release_inputs: bool = True,
                 lease_timeout: Optional[float] = None,
                 snapshot_every: float = 0.0,
                 snapshot_path: str = "",
                 serve_spec=None,
                 trace=None,
                 trace_dir: str = ""):
        """backend: "local" (in-process deques) or "proc" (socket broker
        process); ignored when an explicit ``transport`` is given.
        release_inputs: delete one-shot proxied task inputs from the
        Value Server once the task completes (bounds campaign memory).
        Set False if your Thinker resolves ``result.args`` proxies after
        completion, e.g. to resubmit the exact input payload.
        lease_timeout: seconds before an unacked delivery lease expires
        and its envelopes redeliver (None: the backend default).  Must
        exceed the longest task execution *or* the consumer must renew
        (pool workers heartbeat); it also bounds how long a resumed
        campaign waits before re-running work that was in flight at the
        checkpoint.
        serve_spec: a ``repro_torch.serving.shard.ServeSpec`` declaring the
        fabric's inference topic -- registers the topic's queue pair and
        makes it ``send_inference``'s default destination.  The shards
        that drain it are forked by the cluster launcher (or
        ``start_inference_shard``); this side only routes requests.
        snapshot_every/snapshot_path (proc backend): the forked broker
        auto-snapshots its whole state to ``snapshot_path`` every
        ``snapshot_every`` seconds (atomic tmp+rename) -- long campaigns
        get a crash-resumable file (``resume`` accepts it directly) with
        no application checkpoint call.
        trace: distributed tracing sampling control.  ``True`` enables
        span sinks at the default sample rate
        (``observability.DEFAULT_SAMPLE``); a float in (0, 1] sets the
        rate; ``0``/``False`` force tracing off; ``None`` (default)
        inherits the environment (``REPRO_OBS_DIR``/``REPRO_OBS_SAMPLE``
        -- how cluster-launched roles get theirs).  trace_dir: sink
        directory (default: env, else a fresh temp dir, exposed as
        ``self.trace_dir`` for ``repro_torch.observability.report``).  The
        sampling decision is made once per task here and rides the
        envelope meta, so unsampled tasks cross every hop span-free."""
        # observability config must land in the environment BEFORE the
        # transport forks its broker, so every child role inherits it
        if trace:
            sample = obs.DEFAULT_SAMPLE if trace is True else float(trace)
            trace_dir = (trace_dir or os.environ.get(obs.ENV_DIR)
                         or tempfile.mkdtemp(prefix="repro_torch-obs-"))
            os.environ[obs.ENV_DIR] = trace_dir
            os.environ[obs.ENV_SAMPLE] = repr(sample)
        elif trace is not None:
            os.environ.pop(obs.ENV_DIR, None)     # explicit off
        self.trace_dir = os.environ.get(obs.ENV_DIR, "")
        if self.trace_dir:
            obs.configure(role="thinker")
        if transport is not None and snapshot_every:
            raise ValueError(
                "snapshot_every configures the broker the queues fork:"
                " with an explicit transport, auto-snapshot is configured"
                " where its broker is launched (ProcTransport/ClusterSpec"
                " snapshot_every)")
        if transport is None:
            kw = {} if lease_timeout is None \
                else {"lease_timeout": lease_timeout}
            if snapshot_every:
                if backend != "proc":
                    raise ValueError(
                        "snapshot_every is broker-side crash protection:"
                        " it requires backend='proc'")
                kw.update(snapshot_every=snapshot_every,
                          snapshot_path=snapshot_path)
            transport = make_transport(backend, **kw)
        self.transport = transport
        self.backend = self.transport.name
        self._topics = {t: TopicQueue(self.transport, t) for t in topics}
        self.serve_spec = serve_spec
        if serve_spec is not None and serve_spec.topic not in self._topics:
            self._topics[serve_spec.topic] = TopicQueue(self.transport,
                                                        serve_spec.topic)
        self.value_server = value_server
        self.proxy_threshold = proxy_threshold
        self.release_inputs = release_inputs
        self._active = 0
        self._lock = threading.Lock()
        self._all_done = threading.Condition(self._lock)

    @classmethod
    def connect(cls, topics: Iterable[str], address: tuple, *,
                lease_timeout: Optional[float] = None,
                **kwargs) -> "ColmenaQueues":
        """Cluster-aware construction: attach to an existing broker --
        a plain remote ``ProcTransport`` fabric or a federation member
        bound by ``ClusterLauncher`` (``launcher.address_of(host)``).
        Every queue/checkpoint/resume semantic is identical; topics
        homed at other federation members are simply one relay hop
        away."""
        from repro_torch.core.transport.proc import ProcTransport
        kw = {} if lease_timeout is None else {"lease_timeout": lease_timeout}
        return cls(topics, transport=ProcTransport(address=address, **kw),
                   **kwargs)

    def topics(self):
        """Worker-pool topics.  The serve topic is excluded: it is
        drained by inference shards, and a Task Server intake on it
        would steal requests the shards are supposed to micro-batch."""
        skip = None if self.serve_spec is None else self.serve_spec.topic
        return [t for t in self._topics if t != skip]

    def wake_all(self) -> None:
        """Wake every blocked consumer (used on shutdown/done events)."""
        self.transport.wake_all()
        with self._lock:
            self._all_done.notify_all()

    def shutdown(self) -> None:
        """Tear down transport-owned processes (broker).  A no-op for the
        local backend; idempotent."""
        self.wake_all()
        self.transport.close()
        if self.trace_dir:
            # this process's buffered span tail (submit/decode spans,
            # local-backend broker spans) must be on disk before any
            # same-process report reads the sinks
            obs.flush()

    # -- checkpoint / resume ------------------------------------------------

    def checkpoint(self, path: str, extra=None) -> str:
        """Write a resumable image of the fabric to ``path``: the
        transport snapshot (queued + in-flight envelopes, leases, claim
        window) plus the active-task count, and any picklable ``extra``
        the application wants to travel with it (Thinker progress, a
        CampaignRecord).  Written atomically (tmp + rename) so a kill
        mid-checkpoint leaves the previous checkpoint intact.

        The transport snapshot is a consistent cut of the queues, but
        the active count and the application's ``extra`` are read
        separately: call from the (sole) result-consuming thread with no
        concurrent ``send_task`` -- the blessed site is
        ``BaseThinker.after_result_batch``, where every result of the
        drained (already-acked) batch has been counted -- so the
        progress written cannot drift from the captured queues.  A count
        that includes a task the snapshot missed would make a resumed
        ``wait_until_done`` wait forever.

        Value Server contents travel WITH the checkpoint: a snapshot of
        the attached server (both storage tiers, deduplicated across
        replicas) is bundled so restored task/result proxies resolve in
        the next incarnation -- proxied payloads no longer have to be
        carried inline to be checkpointable."""
        # transport BEFORE value server: a payload is always put before
        # the envelope referencing it, so any proxy inside a captured
        # envelope was stored before the transport cut -- and therefore
        # before the (later) VS snapshot.  The reverse order could image
        # a result envelope whose payload missed the VS cut: a dangling
        # proxy on a *claimed* task id, which is an unrecoverable lost
        # task.
        #
        # The residual window -- a worker completing between the two
        # cuts, whose one-shot input release beats the VS snapshot while
        # the transport cut still images its request as in-flight -- is
        # closed by verification: every completion fuses a claim into
        # the result put *before* the release, so if a transport re-cut
        # taken after the VS snapshot shows the same claim window, no
        # release can have raced the VS cut and the pair is consistent.
        # On mismatch both cuts are retaken (the completed task's claim
        # and result envelope are then inside the transport cut, and its
        # released inputs are no longer needed).  If the fabric outruns
        # every retry, the stale pair still errors a redelivered
        # re-execution out visibly -- never silently losing work.
        transport_snap = self.transport.snapshot()
        vs = None
        if self.value_server is not None \
                and hasattr(self.value_server, "snapshot"):
            baseline = self._claim_ids(transport_snap)
            for _ in range(5):
                vs = self.value_server.snapshot()
                recut = self.transport.snapshot()
                ids = self._claim_ids(recut)
                if ids == baseline:
                    break
                transport_snap, baseline = recut, ids
        payload = {"version": 1,
                   "transport": transport_snap,
                   "active": self.active_count,
                   "vs": vs,
                   "extra": extra}
        tmp = path + ".tmp"
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        with open(tmp, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
        return path

    @staticmethod
    def _claim_ids(snap: bytes) -> set:
        """The union of claim-window ids inside a transport snapshot --
        single broker or federation bundle.  Every task completion fuses
        a claim into its result put, so two cuts with equal claim sets
        bracket an interval in which no task completed (the
        ``checkpoint`` consistency check)."""
        from repro_torch.core.transport.base import load_snapshot
        payload = pickle.loads(snap)
        if isinstance(payload, dict) and "fed_snapshot" in payload:
            states = [load_snapshot(b) for b in payload["hosts"].values()]
        else:
            states = [load_snapshot(snap)]
        ids: set = set()
        for state in states:
            ids.update(state["claims"]["order"])
        return ids

    @staticmethod
    def load_checkpoint(path: str) -> dict:
        """Read + validate a checkpoint file without restoring it, e.g.
        to inspect ``extra`` before constructing the fabric it
        configures.  Pass the returned payload to ``resume`` to avoid a
        second read of the (potentially large) snapshot blob.

        Accepts two formats: an application checkpoint written by
        ``checkpoint`` (transport snapshot + active count + extra), or a
        **raw broker auto-snapshot** (single broker or a federation
        bundle) written by the broker's ``snapshot_every`` timer.  A raw
        snapshot has no application around to record the active count,
        so it is *derived* from the captured envelopes and claim window
        (``transport.base.derive_active``: ids whose completion was
        already claimed-and-consumed are excluded, or a resumed
        ``wait_until_done`` would wait on them forever) -- and ``extra``
        is None (broker-side snapshots cannot capture Thinker progress;
        applications that need ``extra`` keep calling ``checkpoint``)."""
        from repro_torch.core.transport.base import derive_active, load_snapshot
        with open(path, "rb") as f:
            raw = f.read()
        payload = pickle.loads(raw)
        if isinstance(payload, dict) and "transport" in payload:
            if payload.get("version") != 1:
                raise ValueError("unsupported checkpoint version "
                                 f"{payload.get('version')!r}")
            return payload
        if isinstance(payload, dict) and "fed_snapshot" in payload:
            active = derive_active([load_snapshot(s)
                                    for s in payload["hosts"].values()])
            return {"version": 1, "transport": raw, "active": active,
                    "extra": None}
        if isinstance(payload, dict) and "queues" in payload:
            return {"version": 1, "transport": raw,
                    "active": derive_active([load_snapshot(raw)]),
                    "extra": None}
        raise ValueError(f"{path}: neither a checkpoint nor a broker "
                         "snapshot")

    def resume(self, path: str, payload: Optional[dict] = None):
        """Restore a ``checkpoint`` into this (fresh) fabric and return
        the ``extra`` that was stored with it.  Queued tasks re-dispatch,
        in-flight leases expire and redeliver, completed-but-unconsumed
        results deliver from the restored result queues, and the restored
        claim window swallows re-executions of work that already
        published -- so nothing is lost and nothing completes twice.
        Call before task servers / Thinker agents start consuming.

        The end-to-end guarantee needs every in-flight task to live in
        transport state, which is true of ``ProcessPoolTaskServer`` on
        the ``proc`` backend (workers hold their dispatch leases for the
        whole execution).  The in-process thread ``TaskServer`` hands
        tasks to its executor after acking them, so a checkpoint taken
        while it runs captures only still-queued work -- quiesce it
        first, or use the process pool for resumable campaigns."""
        if payload is None:
            payload = self.load_checkpoint(path)
        vs_blob = payload.get("vs")
        if vs_blob is not None:
            if self.value_server is None:
                raise ValueError(
                    "checkpoint bundles Value Server contents but this "
                    "fabric has no value_server attached: restored "
                    "proxies would dangle")
            # restore payloads BEFORE queue state: once the transport is
            # live a consumer could lease a restored task and resolve its
            # proxies immediately
            self.value_server.restore(vs_blob)
        # the checkpointed incarnation is dead: requeue its in-flight
        # leases immediately instead of waiting out their durations
        self.transport.restore(payload["transport"], expire_leases=True)
        with self._lock:
            self._active = payload["active"]
        return payload["extra"]

    # -- Thinker side -------------------------------------------------------

    def send_task(self, *args, method: str, topic: str = "default",
                  **kwargs) -> str:
        task = msg.Task(topic=topic, method=method, args=args, kwargs=kwargs)
        task.timer.mark("created")
        if self.value_server is not None and self.proxy_threshold is not None:
            task.args = proxy_tree(task.args, self.value_server,
                                   self.proxy_threshold, task.timer,
                                   one_shot=True)
            task.kwargs = proxy_tree(task.kwargs, self.value_server,
                                     self.proxy_threshold, task.timer,
                                     one_shot=True)
        data = msg.timed_serialize(task, task.timer, "serialize_request")
        t_ser = now()
        # single serialization: the measured time/size ride in the envelope
        # (proxy_put was recorded before pickling, so it already travels
        # inside the payload; only post-pickle measurements ride in meta).
        # Timer measurements live in the namespaced "timers" sub-dict;
        # top-level meta is bookkeeping (task_id so a relaying task
        # server can track in-flight work without unpickling the
        # payload, sizes, placement, the trace flag)
        meta = {"timers": {"serialize_request":
                           task.timer.intervals["serialize_request"]},
                "input_size": len(data), "task_id": task.task_id}
        traced = bool(self.trace_dir) and obs.sampled(task.task_id)
        if traced:
            meta["trace"] = 1
        with self._lock:
            self._active += 1
        self._topics[task.topic].requests.put(Envelope(now(), data, meta))
        if traced:
            dur = task.timer.intervals["serialize_request"]
            obs.span(task.task_id, "serialize_request", t_ser - dur, t_ser)
            obs.span(task.task_id, "submit", t_ser - dur, now(),
                     topic=task.topic)
        return task.task_id

    @property
    def serve_topic(self) -> str:
        if self.serve_spec is None:
            raise ValueError(
                "no serve_spec declared: pass serve_spec= to ColmenaQueues"
                " (or an explicit topic= to send_inference)")
        return self.serve_spec.topic

    def send_inference(self, tokens, *, max_new: Optional[int] = None,
                       topic: Optional[str] = None) -> str:
        """Enqueue one inference request (a token-id prompt) on the
        serve topic and return its task id.  The draining inference
        shard buckets it by prompt length into a pad-bounded micro-batch
        with whatever else is queued -- possibly other clients' traffic
        -- and streams the generated ids back as an ordinary ``Result``
        on the topic's result queue (``value`` = generated token list).
        ``serving.shard.InferenceClient`` wraps this with transparent
        split/reassemble over many prompts.  Exactly-once, lease
        redelivery, and checkpoint/resume apply exactly as for
        ``send_task``: this *is* a task, just served by a shard instead
        of a worker pool."""
        return self.send_task(method="infer",
                              topic=topic or self.serve_topic,
                              tokens=[int(t) for t in tokens],
                              max_new=max_new)

    def _decode_result(self, env: Envelope) -> msg.Result:
        result: msg.Result = msg.deserialize(env.data)
        # sender-side Timer measurements ride the namespaced "timers"
        # sub-dict; every other meta key is bookkeeping by construction,
        # so a new top-level key can never be misrecorded as a lifecycle
        # interval (the PR-4/PR-8 grafting-bug class, closed structurally)
        for name, seconds in env.meta.get("timers", {}).items():
            result.timer.record(name, seconds)
        if "output_size" in env.meta:
            result.output_size = env.meta["output_size"]
        t_recv = now()
        result.timer.record("result_queue_transit", t_recv - env.t_put)
        traced = bool(env.meta.get("trace"))
        attempt = int(env.meta.get("redelivered", 0) or 0)
        if traced:
            obs.span(result.task_id, "result_queue_transit", env.t_put,
                     t_recv, attempt=attempt)
        # note the one-shot proxies before resolution replaces them in-tree
        one_shot = ([p for p in iter_proxies(result.value) if p.one_shot]
                    if self.value_server is not None else [])
        t0 = now()
        result.value = resolve_tree(result.value, self.value_server)
        t1 = now()
        result.timer.record("deserialize_result", t1 - t0)
        if traced:
            obs.span(result.task_id, "deserialize_result", t0, t1,
                     attempt=attempt)
            # the envelope Timer's final totals, for the report's
            # decomposition acceptance check
            obs.emit_timers(result.task_id, result.timer.intervals)
        for p in one_shot:
            # result payloads have exactly one consumer: release immediately
            self.value_server.release(p.key)
        with self._lock:
            self._active -= 1
            if self._active <= 0:
                self._all_done.notify_all()
        return result

    def get_result(self, topic: str = "default",
                   timeout: Optional[float] = None,
                   cancel: Optional[threading.Event] = None
                   ) -> Optional[msg.Result]:
        env = self._topics[topic].results.get(timeout=timeout, cancel=cancel)
        if env is None:
            return None
        result = self._decode_result(env)
        # decoded and about to be handed to the caller: commit the lease
        # NOW (flush, not piggyback) -- a consumer that processes this
        # result for longer than lease_timeout before sending its next
        # frame must not get it redelivered
        self._topics[topic].results.ack(flush=True)
        return result

    def get_results(self, topic: str = "default", max_n: int = 32,
                    timeout: Optional[float] = None,
                    cancel: Optional[threading.Event] = None
                    ) -> List[msg.Result]:
        """Blocking batched drain, mirroring ``get_tasks``: one wakeup can
        hand a result-processor thread up to ``max_n`` completed results
        (empty list = cancelled/timed out)."""
        envs = self._topics[topic].results.get_batch(max_n, timeout=timeout,
                                                     cancel=cancel)
        results = [self._decode_result(e) for e in envs]
        if envs:
            # flush: the batch may take arbitrarily long to process
            self._topics[topic].results.ack(flush=True)
        return results

    def cancel(self, task_id: str, topic: str = "default") -> bool:
        """Preempt a task: the broker-side ``cancel`` op claims the id
        (so a racing completion dedups through the same fused put-claim
        path -- exactly one of cancel/complete wins), destroys every
        queued copy (original, retry requeue, straggler backup clone),
        revokes in-flight leases, and wakes parked getters so freed
        capacity re-steers immediately.  The executing worker aborts
        cooperatively (next ``report_intermediate``) or via its
        heartbeat probe + SIGTERM escalation (process pool).

        True: this cancel won -- no result will ever arrive for the id,
        and it leaves the active count here.  False: a completion (or an
        earlier cancel) already claimed it -- the result is or will be
        delivered and counts down normally."""
        t0 = now()
        won = self._topics[topic].requests.cancel(task_id)
        if won:
            obs.observe("cancel_latency", now() - t0)
            with self._lock:
                self._active -= 1
                if self._active <= 0:
                    self._all_done.notify_all()
        return won

    def stream_channel(self, topic: str = "default"):
        """The topic's ``stream`` channel (task servers hand it to the
        worker-side ``streaming.TaskContext``)."""
        return self._topics[topic].stream

    def _decode_intermediate(self, env: Envelope) -> msg.Intermediate:
        ob: msg.Intermediate = msg.deserialize(env.data)
        if env.meta.get("trace") and env.meta.get("task_id"):
            obs.span(env.meta["task_id"], "observation_transit", env.t_put,
                     now(), seq=int(env.meta.get("seq", 0)))
        return ob

    def get_intermediates(self, topic: str = "default", max_n: int = 32,
                          timeout: Optional[float] = None,
                          cancel: Optional[threading.Event] = None
                          ) -> List[msg.Intermediate]:
        """Blocking batched drain of the topic's stream lane: one wakeup
        hands back up to ``max_n`` mid-task observations (empty list =
        cancelled/timed out).  Observations are advisory partials --
        they are acked on decode and never claimed, so a redelivered
        duplicate (stream leases expire like any other) is at worst seen
        twice, never lost while the publishing task is still live."""
        envs = self._topics[topic].stream.get_batch(max_n, timeout=timeout,
                                                    cancel=cancel)
        out = [self._decode_intermediate(e) for e in envs]
        if envs:
            self._topics[topic].stream.ack(flush=True)
        return out

    def wait_until_done(self, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else now() + timeout
        with self._lock:
            while self._active > 0:
                # re-check the predicate: wake_all() notifies unconditionally
                if deadline is None:
                    self._all_done.wait()
                else:
                    remaining = deadline - now()
                    if remaining <= 0:
                        return False
                    self._all_done.wait(remaining)
            return True

    @property
    def active_count(self) -> int:
        with self._lock:
            return self._active

    # -- Task Server side ---------------------------------------------------

    def _decode_task(self, env: Envelope) -> msg.Task:
        task: msg.Task = msg.deserialize(env.data)
        # namespaced "timers" sub-dict only -- top-level bookkeeping
        # (task_id/redelivered/backup/bounces/exclude_*/trace/_shm) can
        # no longer leak into Timer.intervals via a forgotten skip-list
        # entry
        for name, seconds in env.meta.get("timers", {}).items():
            task.timer.record(name, seconds)
        if "input_size" in env.meta:
            task.input_size = env.meta["input_size"]
        t_recv = now()
        task.timer.record("request_queue_transit", t_recv - env.t_put)
        task.timer.mark("received_by_server")
        # delivery-side trace context for the executing role: the
        # sampling verdict and which redelivery attempt this is
        task.trace = bool(env.meta.get("trace"))
        task.attempt = int(env.meta.get("redelivered", 0) or 0)
        if task.trace:
            obs.span(task.task_id, "request_queue_transit", env.t_put,
                     t_recv, attempt=task.attempt, topic=task.topic)
        return task

    def get_task(self, topic: str, timeout: Optional[float] = None,
                 cancel: Optional[threading.Event] = None
                 ) -> Optional[msg.Task]:
        env = self._topics[topic].requests.get(timeout=timeout, cancel=cancel)
        if env is None:
            return None
        task = self._decode_task(env)
        self._topics[topic].requests.ack(flush=True)
        return task

    def get_tasks(self, topic: str, max_n: int = 32,
                  timeout: Optional[float] = None,
                  cancel: Optional[threading.Event] = None
                  ) -> List[msg.Task]:
        """Blocking batched drain: one wakeup can hand back up to ``max_n``
        queued tasks (empty list = cancelled/timed out)."""
        envs = self._topics[topic].requests.get_batch(max_n, timeout=timeout,
                                                      cancel=cancel)
        tasks = [self._decode_task(e) for e in envs]
        if envs:
            # flush: execution of the drained batch may outlive the lease
            self._topics[topic].requests.ack(flush=True)
        return tasks

    def send_result(self, result: msg.Result, *,
                    claim_id: Optional[str] = None) -> bool:
        """Publish a result.  ``claim_id`` (normally the task id) fuses
        an atomic first-completion claim with the enqueue: only the first
        publisher's result is enqueued (True); raced duplicates -- a
        straggler backup, or a lease-expiry redelivery racing a slow but
        alive original -- are swallowed in the same round trip (False).
        The claim happening *inside* the put leaves no window where an
        id is claimed but its result died with the claimant."""
        if self.value_server is not None and self.proxy_threshold is not None:
            result.value = proxy_tree(result.value, self.value_server,
                                      self.proxy_threshold, result.timer,
                                      prefix="serialize_result",
                                      one_shot=True)
        data = msg.timed_serialize(result, result.timer, "serialize_result")
        t_ser = now()
        # task_id rides the meta (like requests) so a broker auto-snapshot
        # can count a completed-but-unconsumed task as still active;
        # Timer measurements ride the namespaced "timers" sub-dict
        meta = {"timers": {"serialize_result":
                           result.timer.intervals["serialize_result"]},
                "output_size": len(data), "task_id": result.task_id}
        traced = bool(self.trace_dir) and obs.sampled(result.task_id)
        if traced:
            meta["trace"] = 1
        ok = self._topics[result.topic].results.put(
            Envelope(now(), data, meta), claim=claim_id)
        if traced:
            dur = result.timer.intervals["serialize_result"]
            attempt = int(getattr(result, "attempt", 0))
            obs.span(result.task_id, "serialize_result", t_ser - dur,
                     t_ser, attempt=attempt)
            obs.span(result.task_id, "publish_result", t_ser, now(),
                     attempt=attempt, claimed=bool(ok))
        return ok

    def requeue(self, task: msg.Task) -> None:
        """Retry path: put a (deserialized) task back on its request queue."""
        data = msg.serialize(task)
        meta = {"input_size": task.input_size or len(data),
                "task_id": task.task_id}
        # the sampling decision is a deterministic hash of the task id,
        # so a retried task keeps (or keeps lacking) its trace
        if self.trace_dir and obs.sampled(task.task_id):
            meta["trace"] = 1
        self._topics[task.topic].requests.put(Envelope(now(), data, meta))

    def release_task_inputs(self, task: msg.Task) -> None:
        """Drop one-shot input payloads from the Value Server once the task
        reached its final outcome (shared by both task-server flavours so
        the release policy can never drift between them).  Only the race
        *winner* calls this; Thinkers that re-resolve ``result.args`` after
        completion opt out via ``release_inputs=False``."""
        if self.value_server is None or not self.release_inputs:
            return
        for p in iter_proxies(task.args):
            if p.one_shot:
                self.value_server.release(p.key)
        for p in iter_proxies(task.kwargs):
            if p.one_shot:
                self.value_server.release(p.key)
