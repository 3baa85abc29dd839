"""SynApp: the paper's synthetic application for overhead measurement
(§IV-D1).  A Thinker + N workers; T identical tasks with duration D,
unique (non-cacheable) input of size I bytes and output of size O bytes.
The Thinker submits one task per worker, then one new task per completed
result, until T tasks are done -- measuring the full task lifecycle for
each {T, D, I, O, N} configuration (Figs. 5, 6, 9).

SynApp doubles as the checkpoint/resume demo: with
``checkpoint_every=K`` the Thinker writes a fabric checkpoint (queued +
in-flight envelopes, claim window, Value Server contents, Thinker
progress, the full config) every K results, and
``run_synapp(cfg, resume_from=path)`` continues a ``kill -9``'d run from
the last checkpoint without resubmitting completed work.  The Value
Server may stay enabled: its snapshot travels inside the checkpoint, so
restored task/result proxies resolve in the new incarnation.  The same
works at cluster scale -- the transport snapshot becomes a federation
bundle and the VS snapshot spans the shard ring::

    PYTHONPATH=src python -m repro_torch.apps.synapp --backend proc -T 200 \
        -D 0.05 --checkpoint-every 25 --ckpt /tmp/syn.ckpt
    PYTHONPATH=src python -m repro_torch.apps.synapp --cluster 2 -T 200 \
        -D 0.05 --vs-replicas 2 --checkpoint-every 25 --ckpt /tmp/syn.ckpt
    # kill -9 either mid-run, then:
    PYTHONPATH=src python -m repro_torch.apps.synapp --resume /tmp/syn.ckpt
"""
from __future__ import annotations

import os
import tempfile
import threading
import time
from dataclasses import dataclass

import numpy as np

from repro_torch import observability as obs
from repro_torch.core import (ColmenaQueues, ProcessPoolTaskServer,
                        ShardedValueServer, TaskServer, ValueServer,
                        streaming)
from repro_torch.core.thinker import BaseThinker, agent, result_processor


@dataclass
class SynConfig:
    T: int = 200                 # total tasks
    D: float = 0.0               # task duration (s)
    I: int = 1 << 20             # input bytes
    O: int = 0                   # output bytes
    N: int = 8                   # workers
    use_value_server: bool = True
    proxy_threshold: int = 1 << 14
    seed: int = 0
    backend: str = "local"       # "local": thread workers, in-process queues;
                                 # "proc": broker-backed queues + N worker OS
                                 # processes + sharded socket Value Server
                                 # (the paper's multi-process topology)
    vs_shards: int = 2           # Value Server shards on the proc backend
    vs_replicas: int = 1         # copies of every VS key on the shard ring
                                 # (>=2 survives a shard/node loss)
    cluster_hosts: int = 0       # >=2: the multi-host topology -- that many
                                 # simulated hosts over TCP, each a federated
                                 # broker + worker pool (workers split across
                                 # hosts), Thinker attached to host 0
    cluster_thinker_remote: bool = False
                                 # all pools on hosts != the thinker's, so
                                 # every task crosses the federation relay
                                 # (the bench's relay-cost configuration)
    checkpoint_every: int = 0    # write a checkpoint every K results (0: off)
    checkpoint_path: str = ""    # where checkpoints go (required if K > 0)
    lease_timeout: float = 10.0  # unacked-delivery expiry; bounds how long a
                                 # resumed run waits to re-run in-flight work
    score_candidates: int = 0    # >0: Colmena-style steering -- the proxy
                                 # model (served by an inference shard) ranks
                                 # this many candidate inputs per submission
                                 # and the Thinker submits the best one
    inference_shards: int = 1    # scorer shard processes (proc/cluster
                                 # backends; the local backend serves the
                                 # proxy model from an in-process thread)
    trace_sample: float = 0.0    # >0: distributed tracing, sampling this
                                 # fraction of tasks (1.0 traces them all)
    trace_dir: str = ""          # span sink directory (default: a fresh
                                 # temp dir; feed it to
                                 # ``repro_torch.observability.report``)
    cull_losers: float = 0.0     # >0: streaming steering -- tasks publish
                                 # partial results mid-run and the Thinker
                                 # preempts (broker-side cancel) the bottom
                                 # ``cull_losers`` fraction on their first
                                 # partial, resubmitting into the freed slot
    cull_steps: int = 4          # partials per task when culling: the task
                                 # duration is spent in this many slices
                                 # with report_intermediate between them


def proxy_scorer_factory():
    """The synapp "proxy model": a numpy LCG that maps a token prompt to
    a deterministic pseudo-score stream.  It exercises the full serving
    path -- bucketing, micro-batching, continuous decode, put-claim
    results -- without importing jax, so the steering demo runs on any
    backend at test speed.  Swap in
    ``repro_torch.serving.shard.default_engine_factory`` for the real reduced
    model."""

    class _State:
        def __init__(self, cur, padded_b):
            self.cur = cur
            self.padded_b = padded_b

    class _ProxyModel:
        def prefill_batch(self, tokens, *, reserve=None, frames=None):
            first = (tokens.astype(np.int64).sum(axis=1) * 31 + 7) % 997
            return first, _State(first, tokens.shape[0])

        def decode_batch(self, state):
            state.cur = (state.cur * 31 + 7) % 997
            return state.cur

        def gather_rows(self, state, rows):
            idx = np.asarray(list(rows))
            return _State(state.cur[idx], len(idx))

    return _ProxyModel()


def _serve_spec(cfg: SynConfig):
    from repro_torch.serving.shard import ServeSpec
    return ServeSpec(engine_factory=proxy_scorer_factory,
                     max_batch=max(cfg.score_candidates, 4),
                     max_batch_delay_ms=5.0)


class SynThinker(BaseThinker):
    def __init__(self, queues, cfg: SynConfig, *, submitted: int = 0,
                 completed: int = 0, scorer=None):
        """submitted/completed seed the progress counters when resuming
        from a checkpoint: already-completed work is never resubmitted,
        and the restored in-flight tasks drive the submit-per-completion
        loop forward.  scorer: an ``InferenceClient`` on the fabric's
        scorer shard; each submission then ranks
        ``cfg.score_candidates`` candidate inputs through it and submits
        the best-scored one (the paper's ML-in-the-loop steering)."""
        super().__init__(queues)
        self.cfg = cfg
        self.scorer = scorer
        self.scored = 0
        self.results = []
        self.submitted = submitted
        self.completed = completed
        # serializes submissions against checkpoints: a snapshot taken
        # between a submission being counted and its envelope landing
        # would record a task the restored queues don't contain
        self._sub_lock = threading.Lock()
        self._ckpt_due = False

    def _payload(self, idx: int, cand: int = 0):
        # unique (non-cacheable) input, keyed by submission index so a
        # resumed run continues the stream instead of replaying payloads
        # the original incarnation already sent
        rng = np.random.default_rng((self.cfg.seed, idx, cand))
        return rng.integers(0, 255, size=self.cfg.I,
                            dtype=np.uint8).tobytes()

    def _choose(self, idx: int) -> bytes:
        """Steered submission: score ``score_candidates`` candidate
        inputs through the proxy-model shard (one request per candidate;
        the shard micro-batches them) and return the best one."""
        k = self.cfg.score_candidates
        if self.scorer is None or k <= 1:
            return self._payload(idx)
        cands = [self._payload(idx, c) for c in range(k)]
        prompts = [list(c[:16]) for c in cands]
        results = self.scorer.infer(prompts, max_new=4, timeout=60.0)
        scores = [r.value[-1] if r.success else -1 for r in results]
        self.scored += k
        return cands[int(np.argmax(scores))]

    def _submit(self) -> bool:
        with self._sub_lock:
            if self.submitted >= self.cfg.T:
                return False
            idx = self.submitted
            self.submitted += 1
            # send inside the lock: count and envelope move together
            # relative to any concurrent checkpoint.  Scoring sits
            # inside too -- the candidates' infer round trip must not
            # race a checkpoint either, or the snapshot could capture
            # the scorer requests without the submission they feed
            self.queues.send_task(self._choose(idx), self.cfg.D,
                                  self.cfg.O, self.cfg.cull_steps
                                  if self.cfg.cull_losers else 0,
                                  method="syntask", topic="syntask")
        return True

    def _checkpoint(self):
        with self._sub_lock:
            self.queues.checkpoint(
                self.cfg.checkpoint_path,
                extra={"submitted": self.submitted,
                       "completed": self.completed,
                       "T": self.cfg.T, "cfg": dict(self.cfg.__dict__)})

    @agent
    def planner(self):
        # top up to N in flight (on a fresh run: submit N; on resume the
        # restored in-flight tasks already count toward the window)
        while (self.submitted - self.completed < self.cfg.N
               and self._submit()):
            pass
        if self.completed >= self.cfg.T:    # resumed post-completion
            self.done.set()

    @result_processor(topic="syntask")
    def consumer(self, result):
        assert result.success, result.error
        self.results.append(result)
        self._advance()

    def _advance(self):
        """Count one campaign outcome -- a delivered result, or (in the
        culling subclass) a preemption decision -- and keep the
        submit-per-outcome loop moving.  The count mutates under
        ``_sub_lock``: the consumer thread and the stream-drain threads
        both land here."""
        with self._sub_lock:
            self.completed += 1
            completed = self.completed
        if (self.cfg.checkpoint_every
                and completed % self.cfg.checkpoint_every == 0):
            # defer to the batch boundary: mid-batch, sibling results of
            # this drain are decoded (acked out of the broker) but not
            # yet counted -- a snapshot here would lose them on resume
            self._ckpt_due = True
        if completed >= self.cfg.T:
            # done.set() suppresses the batch-boundary hook, so flush a
            # pending checkpoint here -- at T every delivered result is
            # counted, which is exactly the boundary the hook waits for
            if self._ckpt_due:
                self._ckpt_due = False
                self._checkpoint()
            self.done.set()
        else:
            self._submit()

    def after_result_batch(self, topic):
        if self._ckpt_due:
            self._ckpt_due = False
            self._checkpoint()


class CullingSynThinker(SynThinker):
    """Streaming steering (``cull_losers``): syntask spends its duration
    in ``cull_steps`` slices, publishing a partial after each; this
    Thinker reads the first partial's pseudo-score and preempts the
    bottom ``cull_losers`` fraction via broker-side ``cancel`` -- the
    loser stops burning its worker after one slice instead of running to
    completion, and the freed slot is resubmitted immediately.  A cull
    counts as a campaign outcome (the steering policy *decided* that
    task), so T outcomes still terminate the run."""

    def __init__(self, queues, cfg: SynConfig, **kw):
        super().__init__(queues, cfg, **kw)
        self.culled = 0
        self._decided: set = set()

    def process_intermediate(self, ob):
        if ob.value["score"] >= self.cfg.cull_losers:
            return                      # keeper: let it run out
        if ob.task_id in self._decided:
            return                      # later slices of a known loser
        self._decided.add(ob.task_id)
        if self.queues.cancel(ob.task_id, "syntask"):
            # won the cancel-vs-completion race: the task will never
            # deliver a result, so the cull itself is the outcome
            with self._sub_lock:
                self.culled += 1
            self._advance()
        # lost the race: the completion is already enqueued and the
        # consumer counts it -- nothing to do here


def syntask(payload: bytes, duration: float, out_bytes: int,
            steps: int = 0) -> bytes:
    """steps=0: the paper's opaque synthetic task (sleep D, emit O
    bytes).  steps>0: the streaming variant -- the duration is spent in
    that many slices with a partial published after each, carrying a
    pseudo-score derived from the payload (deterministic, so local and
    pool workers rank identically).  ``report_intermediate`` raises
    ``TaskCancelled`` between slices once the Thinker culls this task."""
    if steps:
        score = int.from_bytes(payload[:8].ljust(8, b"\0"),
                               "little") / 2 ** 64
        dt = duration / steps
        for i in range(steps):
            if dt:
                time.sleep(dt)
            streaming.report_intermediate({"step": i, "score": score})
        return b"\0" * out_bytes
    if duration:
        time.sleep(duration)
    return b"\0" * out_bytes


def _cluster_spec(cfg: SynConfig):
    """The synapp cluster topology: ``cluster_hosts`` simulated hosts,
    each a federated broker, with the N workers split across the pool
    hosts.  Default: every host pools syntask and the Thinker sits with
    host 0 (its topic traffic is broker-local; other hosts relay).
    ``cluster_thinker_remote``: host 0 runs *no* pool, so every task
    submission and result crosses exactly one relay hop -- the
    configuration the relay-cost bench row measures."""
    from repro_torch.core.cluster import ClusterSpec, HostSpec
    k = cfg.cluster_hosts
    pool_hosts = list(range(1, k)) if cfg.cluster_thinker_remote \
        else list(range(k))
    share, rem = divmod(cfg.N, len(pool_hosts))
    workers = {h: share + (1 if i < rem else 0)
               for i, h in enumerate(pool_hosts)}
    shards = {}
    if cfg.use_value_server:
        for i in range(cfg.vs_shards):
            h = pool_hosts[i % len(pool_hosts)]
            shards[h] = shards.get(h, 0) + 1
    infer = cfg.inference_shards if cfg.score_candidates else 0
    hosts = [HostSpec(f"h{i}", thinker=(i == 0),
                      pools=({"syntask": workers[i]} if workers.get(i)
                             else {}),
                      vs_shards=shards.get(i, 0),
                      # scorer shards sit with the Thinker's host so the
                      # steering round trip stays broker-local
                      inference_shards=(infer if i == 0 else 0))
             for i in range(k)]
    return ClusterSpec(hosts, lease_timeout=cfg.lease_timeout,
                       vs_replicas=(cfg.vs_replicas if cfg.use_value_server
                                    else 1))


def _run_cluster(cfg: SynConfig, progress, resume_from: str = "",
                 ckpt_payload=None):
    """Materialize the spec, attach the Thinker to its host's broker,
    and run the campaign across the simulated hosts.  ``resume_from``
    restores the federation bundle + Value Server snapshot into the
    fresh cluster before the Thinker starts submitting (host names are
    derived from the config, so the restored per-member cuts land on
    their namesakes)."""
    from repro_torch.core.cluster import ClusterLauncher
    threshold = cfg.proxy_threshold if cfg.use_value_server else None
    serve = _serve_spec(cfg) if cfg.score_candidates else None
    launcher = ClusterLauncher(
        _cluster_spec(cfg),
        methods=[(syntask, {"topic": "syntask"})],
        proxy_threshold=threshold, serve_spec=serve)
    t0 = time.perf_counter()
    with launcher:
        vs = launcher.value_server() if cfg.use_value_server else None
        queues = launcher.connect(["syntask"], value_server=vs,
                                  proxy_threshold=threshold,
                                  serve_spec=serve)
        scorer = None
        if serve is not None:
            from repro_torch.serving.shard import InferenceClient
            scorer = InferenceClient(queues)
        try:
            if resume_from:
                progress = queues.resume(resume_from, payload=ckpt_payload)
                cfg.T = progress.get("T", cfg.T)
            cls = CullingSynThinker if cfg.cull_losers else SynThinker
            thinker = cls(queues, cfg,
                          submitted=progress["submitted"],
                          completed=progress["completed"],
                          scorer=scorer)
            thinker.run(timeout=600)
            makespan = time.perf_counter() - t0
        finally:
            queues.shutdown()
            queues.transport.client.close()
    return thinker, makespan


def run_synapp(cfg: SynConfig, resume_from: str = ""):
    """Returns per-component median lifecycle times + utilization.
    ``resume_from``: continue from a checkpoint file instead of starting
    fresh (the fabric state is restored *before* workers start)."""
    ckpt_payload = None
    if resume_from:
        # the campaign's config travels with the checkpoint: a resume
        # continues *that* run (same durations, sizes, backend, paths),
        # so peek at it before building the fabric it configures (one
        # read -- the payload is handed to resume() below)
        ckpt_payload = ColmenaQueues.load_checkpoint(resume_from)
        for k, v in (ckpt_payload["extra"] or {}).get("cfg", {}).items():
            setattr(cfg, k, v)
    if cfg.checkpoint_every and not cfg.checkpoint_path:
        raise ValueError("checkpoint_every is set but checkpoint_path is "
                         "empty -- the first checkpoint would fail inside "
                         "the consumer thread and hang the run")
    if cfg.trace_sample:
        # export before any fabric process exists: forked brokers,
        # shards and agents inherit the sink config (the cluster path
        # additionally stamps per-host identity into agent/shard env)
        cfg.trace_dir = (cfg.trace_dir or os.environ.get(obs.ENV_DIR)
                         or tempfile.mkdtemp(prefix="repro_torch-obs-"))
        os.environ[obs.ENV_DIR] = cfg.trace_dir
        os.environ[obs.ENV_SAMPLE] = repr(cfg.trace_sample)
    if cfg.cluster_hosts:
        if cfg.cluster_hosts < 2:
            raise ValueError("cluster_hosts simulates a multi-host fabric:"
                             " use >= 2 (or 0 for single-host backends)")
        thinker, makespan = _run_cluster(
            cfg, {"submitted": 0, "completed": 0},
            resume_from=resume_from, ckpt_payload=ckpt_payload)
        return _metrics(cfg, thinker, makespan)
    proc = cfg.backend == "proc"
    if not cfg.use_value_server:
        vs = None
    elif proc:
        if cfg.vs_replicas > cfg.vs_shards:
            # same contract as ClusterSpec: an unsatisfiable replica
            # factor is a misconfiguration, not a silent downgrade
            raise ValueError(
                f"vs_replicas={cfg.vs_replicas} exceeds vs_shards="
                f"{cfg.vs_shards}: the replica factor cannot be satisfied")
        vs = ShardedValueServer(cfg.vs_shards, replicas=cfg.vs_replicas)
    else:
        vs = ValueServer()
    serve = _serve_spec(cfg) if cfg.score_candidates else None
    queues = ColmenaQueues(
        ["syntask"], backend=cfg.backend, value_server=vs,
        proxy_threshold=cfg.proxy_threshold if cfg.use_value_server
        else None, lease_timeout=cfg.lease_timeout, serve_spec=serve)
    scorer = None
    shard_procs: list = []
    serve_thread = None
    if serve is not None:
        from repro_torch.serving.shard import (InferenceClient, ServeLoop,
                                         start_inference_shard)
        scorer = InferenceClient(queues)
        if proc:
            shard_procs = [
                start_inference_shard(queues.transport.address, serve,
                                      lease_timeout=cfg.lease_timeout,
                                      identity=f"infer@proc:{i}")
                for i in range(max(cfg.inference_shards, 1))]
        else:
            # local backend: no process to fork -- serve the proxy model
            # from a thread over the same in-process transport
            loop = ServeLoop(queues.transport, serve,
                             identity="infer@local:0")
            serve_thread = threading.Thread(target=loop.run, daemon=True,
                                            name="synapp-scorer")
            serve_thread.start()
    progress = {"submitted": 0, "completed": 0}
    if resume_from:
        progress = queues.resume(resume_from, payload=ckpt_payload)
        cfg.T = progress.get("T", cfg.T)    # totals travel with the ckpt
    if proc:
        server = ProcessPoolTaskServer(queues, workers_per_topic=cfg.N)
    else:
        server = TaskServer(queues, workers_per_topic=cfg.N)
    server.register(syntask, topic="syntask")
    cls = CullingSynThinker if cfg.cull_losers else SynThinker
    thinker = cls(queues, cfg, submitted=progress["submitted"],
                  completed=progress["completed"], scorer=scorer)
    t0 = time.perf_counter()
    try:
        with server:
            thinker.run(timeout=600)
        makespan = time.perf_counter() - t0
    finally:
        if serve is not None:
            # graceful: one stop marker per consumer of the serve topic
            from repro_torch.serving.shard import send_shard_stop
            try:
                send_shard_stop(queues.transport, serve.topic,
                                n=len(shard_procs) or 1)
            except (ConnectionError, OSError):
                pass
            if serve_thread is not None:
                serve_thread.join(timeout=5)
            for p in shard_procs:
                p.join(timeout=5)
                if p.is_alive():
                    p.terminate()
        queues.shutdown()
        if vs is not None and hasattr(vs, "shutdown"):
            vs.shutdown()
    return _metrics(cfg, thinker, makespan)


def _metrics(cfg: SynConfig, thinker: SynThinker, makespan: float):
    comps = {}
    for r in thinker.results:
        for k, v in r.timer.intervals.items():
            comps.setdefault(k, []).append(v)
    medians = {k: float(np.median(v)) for k, v in comps.items()}
    busy = sum(r.task_runtime for r in thinker.results)
    overhead = {k: v for k, v in medians.items() if k != "execute"}
    n = len(thinker.results)
    return {
        "config": cfg.__dict__,
        "medians": medians,
        "total_overhead_median": float(sum(overhead.values())),
        "makespan": makespan,
        # end-to-end wall time amortized per task: at D=0 this exposes any
        # dispatch-latency floor the lifecycle medians could hide
        "per_task_wall": makespan / n if n else float("inf"),
        "utilization": busy / (cfg.N * makespan) if makespan else 0.0,
        "n_results": n,
        "completed_total": thinker.completed,
        # steering: candidate inputs ranked through the scorer shard
        "scored": thinker.scored,
        # streaming steering: tasks preempted on their first partial
        "culled": getattr(thinker, "culled", 0),
        # cluster runs: which hosts actually executed work (from the
        # winning worker identities)
        "hosts_seen": sorted({r.worker.split("/", 1)[0]
                              for r in thinker.results if r.worker}),
        # where the span/metric sinks landed (empty when untraced):
        # ``python -m repro_torch.observability.report <dir>`` renders them
        "trace_dir": cfg.trace_dir if cfg.trace_sample else "",
    }


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("-T", type=int, default=200, help="total tasks")
    p.add_argument("-D", type=float, default=0.0, help="task duration (s)")
    p.add_argument("-I", type=int, default=1 << 20, help="input bytes")
    p.add_argument("-N", type=int, default=8, help="workers")
    p.add_argument("--backend", choices=("local", "proc"), default="local")
    p.add_argument("--cluster", type=int, default=0, metavar="K",
                   help="run on K simulated hosts over TCP (federated "
                        "brokers + per-host worker pools; implies the "
                        "proc-style topology)")
    p.add_argument("--no-value-server", action="store_true")
    p.add_argument("--vs-replicas", type=int, default=1, metavar="R",
                   help="Value Server replica factor (>=2 keeps keys "
                        "readable through a shard/node loss)")
    p.add_argument("--score-candidates", type=int, default=0, metavar="C",
                   help="rank C candidate inputs per task through the "
                        "proxy-model inference shard and submit the best "
                        "(ML-in-the-loop steering)")
    p.add_argument("--inference-shards", type=int, default=1,
                   help="scorer shard processes (proc/cluster backends)")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="K",
                   help="checkpoint the fabric every K results")
    p.add_argument("--ckpt", default="synapp.ckpt",
                   help="checkpoint file path")
    p.add_argument("--resume", default="",
                   help="resume from this checkpoint file")
    p.add_argument("--cull-losers", type=float, default=0.0, metavar="F",
                   help="streaming steering: tasks publish partials and "
                        "the bottom F fraction (by first-partial score) "
                        "is preempted mid-run, freeing its worker slot")
    p.add_argument("--cull-steps", type=int, default=4, metavar="S",
                   help="partials per task when culling (the duration is "
                        "spent in S slices)")
    p.add_argument("--trace", nargs="?", const=1.0, type=float,
                   default=0.0, metavar="RATE",
                   help="distributed tracing: sample RATE of tasks "
                        "(bare --trace samples all of them)")
    p.add_argument("--trace-dir", default="", metavar="DIR",
                   help="span sink directory (default: a fresh temp dir, "
                        "printed at the end)")
    args = p.parse_args(argv)
    cfg = SynConfig(T=args.T, D=args.D, I=args.I, N=args.N,
                    backend=args.backend, cluster_hosts=args.cluster,
                    use_value_server=not args.no_value_server,
                    vs_replicas=args.vs_replicas,
                    score_candidates=args.score_candidates,
                    inference_shards=args.inference_shards,
                    checkpoint_every=args.checkpoint_every,
                    checkpoint_path=args.ckpt,
                    cull_losers=args.cull_losers, cull_steps=args.cull_steps,
                    trace_sample=args.trace, trace_dir=args.trace_dir)
    res = run_synapp(cfg, resume_from=args.resume)
    hosts = (f"  hosts {','.join(res['hosts_seen'])}"
             if args.cluster else "")
    scored = f"  scored {res['scored']}" if res["scored"] else ""
    scored += f"  culled {res['culled']}" if res["culled"] else ""
    print(f"completed {res['completed_total']}/{cfg.T} "
          f"({res['n_results']} this run)  "
          f"makespan {res['makespan']:.2f}s  "
          f"per-task wall {res['per_task_wall']*1e3:.2f}ms  "
          f"median overhead {res['total_overhead_median']*1e3:.2f}ms"
          f"{hosts}{scored}")
    if res["trace_dir"]:
        print(f"trace sinks: {res['trace_dir']}  (render: "
              f"python -m repro_torch.observability.report {res['trace_dir']})")
    return res


if __name__ == "__main__":
    main()
