"""Inference shard: continuous-batching model serving as a fabric role.

A shard is a forked consumer process (supervised like Value Server
shards, declared per host via ``HostSpec.inference_shards``) that drains
one dedicated request topic through the ordinary lease/ack broker
protocol and serves the requests over a warm ``Engine``:

- requests are bucketed by prompt length into pad-bounded micro-batches
  (``serving.batcher``), flushed when full or when the oldest request
  has waited ``max_batch_delay_ms`` -- the latency/occupancy knob;
- the serve loop runs **continuous batching**: between any two decode
  steps it polls the request channel and admits newly arrived
  micro-batches as fresh prefills, so a request never waits for an
  unrelated batch to run to completion;
- rows that reach their per-request ``max_new`` stream back immediately,
  and when the survivors of a group fit a strictly smaller batch bucket
  the engine state is gathered down (slot reuse: retired slots stop
  costing decode FLOPs);
- every result is published under the fused put-claim, so the
  exactly-once and checkpoint/resume guarantees of the dispatch fabric
  carry over unchanged.

Lease discipline (the crash story): a drained request batch's lease is
**detached** (``Channel.detach_lease``) and held -- heartbeat-renewed --
until every request it delivered has had its result published (claim won
*or* lost); only then is the lease acked.  A shard SIGKILLed mid-batch
therefore leaves its leases unacked: they expire, every undelivered
request redelivers to a surviving (or restarted) shard, and any row the
dead shard already streamed out is deduped by the claim on the result
put.  Zero lost, zero duplicated.

This module imports no jax at module scope: fabric processes can import
``ServeSpec``/``InferenceClient`` without dragging in the accelerator
stack (the engine is built lazily, inside the shard process).
"""
from __future__ import annotations

import multiprocessing
import os
import signal
import threading
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

from repro_torch import observability as obs
from repro_torch.core import message as msg
from repro_torch.core.transport.base import Envelope, Transport
from repro_torch.serving.batcher import (DEFAULT_PROMPT_BUCKETS, DecodeGroup,
                                   InferenceRequest, MicroBatch,
                                   MicroBatcher, batch_bucket)
from repro_torch.utils.timing import now

_mp = multiprocessing.get_context("fork")

DEFAULT_INFER_TOPIC = "infer"

#: how long the serve loop waits on the request channel between decode
#: steps while groups are active -- the admission poll.  Returns
#: immediately when requests are queued; otherwise bounds the stall a
#: decode step pays to check for new arrivals.
ADMIT_POLL = 0.002


def default_engine_factory(arch: str = "internlm2-1.8b", *,
                           reduced: bool = True, seed: int = 0,
                           max_new: int = 32,
                           device: str = "cuda") -> Callable:
    """An engine factory for the reduced reference model.  Returned as a
    closure so the build happens inside the shard process, never in the
    fabric process that declares the spec: a child forked from a process
    that has initialised CUDA cannot use the card.  The weights are drawn
    on ``device`` (the card unless the caller asks for "cpu") from a
    ``torch.Generator`` seeded with ``seed``."""
    def build():
        import torch
        from repro_torch.configs.base import get_config
        from repro_torch.models import api
        from repro_torch.serving.engine import Engine
        cfg = get_config(arch, reduced=reduced)
        gen = torch.Generator(device=device).manual_seed(seed)
        params = api.init_params(cfg, gen, device=device)
        return Engine(cfg, params, max_new=max_new)
    return build


@dataclass
class ServeSpec:
    """Everything a shard needs to serve one inference topic.  Pure data
    plus a factory callable (fork-inherited, like launcher methods)."""

    topic: str = DEFAULT_INFER_TOPIC
    engine_factory: Optional[Callable] = None   # () -> Engine-like
    max_batch: int = 32
    prompt_buckets: Sequence[int] = DEFAULT_PROMPT_BUCKETS
    #: deadline knob: how long a partial micro-batch may wait for
    #: company before it is flushed anyway.  0 serves singles with
    #: minimum latency; larger values trade first-token latency for
    #: batch occupancy (tokens/sec).
    max_batch_delay_ms: float = 20.0
    #: per-request ``max_new`` ceiling; also bounds the cache reserve
    #: buckets so decode executables are shared across groups.
    max_new_cap: int = 64
    default_max_new: int = 8

    def make_engine(self):
        factory = self.engine_factory or default_engine_factory()
        return factory()


def _pow2_at_most(n: int, cap: int) -> int:
    b = 1
    while b < n and b < cap:
        b <<= 1
    return min(b, cap)


class _ActiveGroup:
    """A DecodeGroup plus its engine state."""

    def __init__(self, group: DecodeGroup, state) -> None:
        self.group = group
        self.state = state
        self.t_decode0 = now()              # decode-span origin (tracing)


class ServeLoop:
    """The shard's serve loop, separable from the process for tests: it
    runs equally over a ``LocalTransport`` in a thread or a
    ``ProcTransport`` in a forked shard."""

    def __init__(self, transport: Transport, spec: ServeSpec, *,
                 engine=None, stop: Optional[threading.Event] = None,
                 identity: str = "infer-shard"):
        self.spec = spec
        self.identity = identity
        self.engine = engine if engine is not None else spec.make_engine()
        self.requests = transport.channel(spec.topic, "requests")
        self.results = transport.channel(spec.topic, "results")
        self.batcher = MicroBatcher(
            max_batch=spec.max_batch, prompt_buckets=spec.prompt_buckets,
            max_batch_delay=spec.max_batch_delay_ms / 1000.0)
        self.stop = stop if stop is not None else threading.Event()
        self.groups: List[_ActiveGroup] = []
        self.lease_timeout = getattr(transport, "lease_timeout", 30.0)
        # lease id -> requests of that drained batch still unpublished;
        # the heartbeat thread reads the keys, the serve loop writes --
        # the only shared state between the two threads
        self._lease_refs: dict = {}
        self._lease_lock = threading.Lock()
        self.stats = {"requests": 0, "published": 0, "claim_lost": 0,
                      "errors": 0, "prefills": 0, "decode_steps": 0,
                      "compactions": 0, "leases_acked": 0}

    # -- lease bookkeeping ---------------------------------------------------

    def _register_lease(self, lid: Optional[int], count: int) -> None:
        if lid is None:
            return
        if count <= 0:
            self.requests.ack_lease(lid)
            return
        with self._lease_lock:
            self._lease_refs[lid] = count

    def _release_lease(self, lid: Optional[int]) -> None:
        """One request of the lease reached its terminal publish; the
        lease commits when the last one does."""
        if lid is None:
            return
        last = False
        with self._lease_lock:
            n = self._lease_refs.get(lid)
            if n is None:
                return
            if n <= 1:
                del self._lease_refs[lid]
                last = True
            else:
                self._lease_refs[lid] = n - 1
        if last:
            self.requests.ack_lease(lid)
            self.stats["leases_acked"] += 1

    def _heartbeat(self, hb_stop: threading.Event) -> None:
        """Renew every held lease at half its timeout, like pool workers
        do for long tasks: a shard chewing through a deep queue must not
        have its undelivered requests redelivered out from under it."""
        interval = max(self.lease_timeout / 2.0, 0.05)
        while not hb_stop.wait(interval):
            with self._lease_lock:
                lids = list(self._lease_refs)
            for lid in lids:
                try:
                    self.requests.renew(lid)
                except (ConnectionError, OSError):
                    return              # fabric is gone; leases will expire

    # -- request intake ------------------------------------------------------

    def _decode_request(self, env: Envelope, lid: Optional[int]
                        ) -> Optional[InferenceRequest]:
        task: msg.Task = msg.deserialize(env.data)
        tokens = list(task.kwargs.get("tokens", ()))
        max_new = int(task.kwargs.get("max_new")
                      or self.spec.default_max_new)
        max_new = min(max_new, self.spec.max_new_cap)
        req = InferenceRequest(task_id=task.task_id, tokens=tokens,
                               max_new=max_new, enqueue_t=now(), lease=lid)
        if env.meta.get("trace"):
            # sampled at submit; the attempt number distinguishes the
            # sub-traces a lease-expiry redelivery produces
            req.meta["trace"] = 1
            req.meta["attempt"] = int(env.meta.get("redelivered", 0) or 0)
        if not tokens or len(tokens) > max(self.spec.prompt_buckets):
            self._publish_error(
                req, f"prompt length {len(tokens)} outside buckets "
                     f"{tuple(self.spec.prompt_buckets)}")
            return None
        return req

    def _intake(self) -> None:
        """Drain newly arrived requests into the batcher.  Blocks only
        when there is nothing to decode; with active groups it polls, so
        admission happens *between* decode steps."""
        room = (sum(len(a.group) for a in self.groups)
                + self.batcher.pending_count()) < 2 * self.spec.max_batch
        if self.groups:
            timeout = ADMIT_POLL if room else 0.0
        elif self.batcher.pending_count():
            deadline = self.batcher.next_deadline()
            timeout = max(deadline - now(), 0.0)
        else:
            timeout = None                  # idle: park until work arrives
        envs = self.requests.get_batch(self.spec.max_batch,
                                       timeout=timeout, cancel=self.stop)
        if not envs:
            return
        lid = self.requests.detach_lease()
        if any(e.meta.get("stop") for e in envs):
            # a shutdown marker: requeue any real requests that shared
            # its drain batch (verbatim, like the launcher's rescue) so
            # only the marker is consumed, then commit and exit
            for env in envs:
                if not env.meta.get("stop"):
                    self.requests.put(env)
            self.requests.ack_lease(lid, flush=True)
            self.stop.set()
            return
        count = 0
        for env in envs:
            req = self._decode_request(env, lid)
            if req is not None:
                self.batcher.add(req)
                count += 1
            self.stats["requests"] += 1
        self._register_lease_counted(lid, len(envs), count)

    def _register_lease_counted(self, lid: Optional[int], total: int,
                                queued: int) -> None:
        """Register the drained batch's lease for ``total`` envelopes;
        rejected requests already published their error result, so their
        share is released immediately."""
        self._register_lease(lid, total)
        for _ in range(total - queued):
            self._release_lease(lid)

    # -- serving -------------------------------------------------------------

    def _publish(self, req: InferenceRequest, value, *, success: bool,
                 error: Optional[str] = None) -> None:
        t_fin = now()
        result = msg.Result(task_id=req.task_id, topic=self.spec.topic,
                            method="infer", success=success, value=value,
                            error=error, worker=self.identity)
        data = msg.serialize(result)
        meta = {"output_size": len(data), "task_id": req.task_id}
        if req.meta.get("trace"):
            meta["trace"] = 1               # keep the result hop sampled
        won = self.results.put(Envelope(t_fin, data, meta),
                               claim=req.task_id)
        if req.meta.get("trace"):
            obs.span(req.task_id, "retire", t_fin, now(),
                     attempt=req.meta.get("attempt", 0), claimed=bool(won))
        self.stats["published" if won else "claim_lost"] += 1
        self._release_lease(req.lease)

    def _publish_error(self, req: InferenceRequest, error: str) -> None:
        self.stats["errors"] += 1
        self._publish(req, None, success=False, error=error)

    def _finish_rows(self, active: _ActiveGroup) -> None:
        """Stream out rows that reached their target, then shrink the
        engine state when the survivors fit a smaller batch bucket."""
        g = active.group
        done = g.finished()
        if not done:
            return
        t_fin = now()
        for req, toks in done:
            if req.meta.get("trace"):
                obs.span(req.task_id, "decode", active.t_decode0, t_fin,
                         attempt=req.meta.get("attempt", 0),
                         new_tokens=len(toks))
            self._publish(req, list(toks), success=True)
        g.retire_finished()
        target = g.compaction(active.state.padded_b)
        if target is not None:
            idx = list(g.slots)
            idx += [idx[0]] * (target - len(idx))
            active.state = self.engine.gather_rows(active.state, idx)
            g.reset_slots()
            self.stats["compactions"] += 1

    def _admit(self) -> tuple:
        """Prefill every micro-batch the batcher deems ready.  Returns
        (requests admitted, padded rows prefilled)."""
        admitted = rows = 0
        for mb in self.batcher.pop_ready(now()):
            t_admit = now()
            obs.observe("batch_occupancy",
                        len(mb.requests) / self.spec.max_batch)
            for req in mb.requests:
                obs.observe("infer_queue_delay", t_admit - req.enqueue_t)
                obs.layer_at("infer_queue", round(req.enqueue_t * 1e9),
                             round(t_admit * 1e9), rid=req.task_id)
                if req.meta.get("trace"):
                    obs.span(req.task_id, "infer_queue", req.enqueue_t,
                             t_admit, attempt=req.meta.get("attempt", 0),
                             bucket=mb.bucket)
            padded_b = batch_bucket(len(mb.requests), self.spec.max_batch)
            reserve = mb.bucket + _pow2_at_most(mb.max_new,
                                                self.spec.max_new_cap)
            admitted += len(mb.requests)
            rows += padded_b
            try:
                first, state = self.engine.prefill_batch(
                    mb.padded_tokens(padded_b), reserve=reserve)
            except Exception as exc:        # noqa: BLE001
                for req in mb.requests:
                    self._publish_error(req, f"prefill failed: {exc!r}")
                continue
            self.stats["prefills"] += 1
            obs.counter("prefills").inc()
            t_prefilled = now()
            for req in mb.requests:
                if req.meta.get("trace"):
                    obs.span(req.task_id, "prefill", t_admit, t_prefilled,
                             attempt=req.meta.get("attempt", 0),
                             rows=len(mb.requests))
            active = _ActiveGroup(DecodeGroup(mb, first, self.spec.max_batch),
                                  state)
            active.t_decode0 = t_prefilled
            self._finish_rows(active)       # max_new == 1 rows
            if not active.group.done:
                self.groups.append(active)
        return admitted, rows

    def _step(self) -> None:
        """One decode step per active group (round-robin), streaming out
        rows as they finish.  Returning to the caller between steps is
        what interleaves intake/admission with decode."""
        survivors = []
        for active in self.groups:
            try:
                nxt = self.engine.decode_batch(active.state)
            except Exception as exc:        # noqa: BLE001
                for req in active.group.rows:
                    self._publish_error(req, f"decode failed: {exc!r}")
                continue
            self.stats["decode_steps"] += 1
            obs.counter("decode_steps").inc()
            active.group.record_step(nxt)
            self._finish_rows(active)
            if not active.group.done:
                survivors.append(active)
        self.groups = survivors

    def run(self) -> None:
        hb_stop = threading.Event()
        hb = threading.Thread(target=self._heartbeat, args=(hb_stop,),
                              daemon=True,
                              name=f"infer-hb-{self.spec.topic}")
        hb.start()
        try:
            while not self.stop.is_set():
                # layer spans (obs.layer): always on, in memory
                drained = self.stats["requests"]
                with obs.layer("serve.intake",
                               groups=len(self.groups)) as sp:
                    self._intake()
                    sp.attrs["requests"] = self.stats["requests"] - drained
                if self.stop.is_set():
                    break
                with obs.layer("serve.admit") as sp:
                    sp.attrs["requests"], sp.attrs["rows"] = self._admit()
                # each group decodes once: its live rows, its padded rows
                with obs.layer("serve.step",
                               real=sum(len(a.group) for a in self.groups),
                               rows=sum(a.state.padded_b
                                        for a in self.groups)):
                    self._step()
                obs.flush_metrics()         # throttled cumulative snapshot
        finally:
            hb_stop.set()
            hb.join(timeout=2)
            obs.flush_metrics(force=True)   # final cumulative snapshot
            try:
                self.results.ack(flush=True)    # flush piggybacked acks
            except (ConnectionError, OSError):
                pass


# -- process wrapper ---------------------------------------------------------

def inference_shard_main(address: tuple, spec: ServeSpec, *,
                         lease_timeout: float = 30.0,
                         identity: str = "infer-shard",
                         env: Optional[dict] = None) -> None:
    """Entry point of a forked shard process: dial the broker that homes
    the serve topic, build the engine (first jax import happens here,
    inside the child), serve until a stop envelope or SIGTERM.  ``env``
    entries (``ClusterSpec.env_for``) are applied before the engine
    build so XLA-style variables precede the first jax import."""
    from repro_torch.core.transport.proc import ProcTransport

    if env:
        os.environ.update(env)
    stop = threading.Event()

    def _sigterm(signum, frame):
        stop.set()
        raise SystemExit(0)                 # unblocks a parked get_batch

    signal.signal(signal.SIGTERM, _sigterm)
    transport = ProcTransport(address=address, lease_timeout=lease_timeout)
    ref, offset = "", None
    if obs.enabled():
        try:
            offset = obs.calibrate(transport.clock_sync)
            ref = obs.addr_str(address)
        except (ConnectionError, OSError, RuntimeError, KeyError,
                TypeError, ValueError):
            offset = None                   # telemetry only: never fatal
    obs.configure(role="infer", ref=ref, offset=offset)
    loop = ServeLoop(transport, spec, stop=stop, identity=identity)
    try:
        loop.run()
    except SystemExit:
        pass
    os._exit(0)


def start_inference_shard(address: tuple, spec: ServeSpec, *,
                          lease_timeout: float = 30.0,
                          identity: str = "infer-shard",
                          env: Optional[dict] = None):
    """Fork one shard process against ``address`` (a broker reachable
    with the serve topic).  Used by the cluster launcher, the serving
    bench, and the chaos tests."""
    p = _mp.Process(target=inference_shard_main, args=(address, spec),
                    kwargs={"lease_timeout": lease_timeout,
                            "identity": identity, "env": env},
                    daemon=True, name=f"colmena-{identity}")
    p.start()
    return p


def send_shard_stop(transport: Transport, topic: str, n: int = 1) -> None:
    """Graceful shutdown: enqueue ``n`` stop markers on the serve topic
    (one per shard draining it)."""
    ch = transport.channel(topic, "requests")
    for _ in range(n):
        ch.put(Envelope(now(), b"", {"stop": True}))


class InferenceClient:
    """Client-side batching façade over ``ColmenaQueues``: splits a list
    of prompts into one request per prompt (the shard re-batches them by
    bucket -- possibly alongside other clients' traffic), then drains
    the serve topic's results and reassembles them in submission order.
    """

    def __init__(self, queues, *, topic: Optional[str] = None):
        self.queues = queues
        self.topic = topic or queues.serve_topic

    def submit(self, prompts: Sequence[Sequence[int]], *,
               max_new: Optional[int] = None) -> List[str]:
        return [self.queues.send_inference(list(p), max_new=max_new,
                                           topic=self.topic)
                for p in prompts]

    def gather(self, task_ids: Sequence[str], *,
               timeout: Optional[float] = None) -> List[msg.Result]:
        """Block until every id has a result; returns them in the order
        of ``task_ids`` regardless of completion order."""
        want = set(task_ids)
        got: dict = {}
        deadline = None if timeout is None else now() + timeout
        while want - set(got):
            remaining = None
            if deadline is not None:
                remaining = deadline - now()
                if remaining <= 0:
                    raise TimeoutError(
                        f"{len(want - set(got))} of {len(want)} inference"
                        " results still missing")
            for r in self.queues.get_results(self.topic, max_n=64,
                                             timeout=remaining):
                got[r.task_id] = r
        return [got[t] for t in task_ids]

    def infer(self, prompts: Sequence[Sequence[int]], *,
              max_new: Optional[int] = None,
              timeout: Optional[float] = None) -> List[msg.Result]:
        """Submit + gather: transparent split/reassemble."""
        return self.gather(self.submit(prompts, max_new=max_new),
                           timeout=timeout)
