"""Materialize a ClusterSpec: brokers, shards, host agents, teardown.

``ClusterLauncher`` turns the declarative spec into running processes:

1. binds one TCP listening socket per broker host (in the launcher
   process, so by the time ``start`` returns every address is
   connectable -- no readiness race), then forks one
   ``federated_broker_main`` per member with the shared partition map
   and peer addresses; the coordinator also gets the federation's
   auto-snapshot config;
2. forks Value Server shard processes for hosts that declare
   ``vs_shards`` (the shard address list, in spec order, is the ring
   every client connects to);
3. forks one **host agent** per pool-running host (``cluster.agent``):
   a process-group-leader subprocess that dials its local broker and
   runs the host's ``ProcessPoolTaskServer`` -- the "simulated host".
   Real hosts instead run the same agent over ssh
   (``ssh_commands``/``write_agent_configs``);
4. tears everything down in reverse on ``stop`` (SIGTERM agents,
   shutdown frames to shards and brokers, a final shared-memory scope
   sweep for segments no registry could see).

Host failure needs no launcher-side rescue machinery on the direct
data plane: queued work only ever lives on the global request topics at
their home brokers (never relayed into per-host queues), and a dead
host's workers merely leave unacked leases there -- which expire and
redeliver to any surviving host's directly-subscribed workers.
Completions the dead host already published are deduped by the claim on
the result put: zero lost, zero duplicated, with nothing to supervise.

Every broker member is forked with the same shared-memory **scope
token**, so co-located clients can ride the shm payload lane
(``transport.shm``) against any member, and ``stop`` can sweep exactly
this cluster's leftover segments.

The Thinker lives in the *caller's* process: ``connect()`` returns a
``ColmenaQueues`` dialing the thinker host's broker; its channels
discover the federation's endpoints and dial each topic's home broker
directly, so steady-state task traffic takes zero relay hops end to end.
"""
from __future__ import annotations

import os
import pickle
import signal
import sys
import tempfile
import threading
from typing import Dict, List, Optional

from repro_torch import observability as obs
from repro_torch.core.cluster.agent import AgentConfig, host_agent_main
from repro_torch.core.cluster.federation import federated_broker_main
from repro_torch.core.cluster.spec import ClusterSpec, HostSpec
from repro_torch.core.queues import ColmenaQueues
from repro_torch.core.transport import frames, shm
from repro_torch.core.transport.proc import ProcTransport
from repro_torch.observability.monitor import CampaignMonitor

import multiprocessing

_mp = multiprocessing.get_context("fork")


class ClusterLauncher:
    def __init__(self, spec: ClusterSpec, methods=(), *,
                 proxy_threshold: Optional[int] = None,
                 straggler_factor: Optional[float] = None,
                 straggler_min_history: int = 5,
                 vs_capacity_bytes: Optional[int] = None,
                 vs_spill: bool = False,
                 serve_spec=None):
        """methods: ``[(fn, register_kwargs), ...]`` applied to every
        host pool (fn may be a ``"module:qualname"`` string for the ssh
        path).  proxy_threshold: forwarded to every host agent so
        workers proxy large *results* through the cluster's Value Server
        shards -- pass the same value to ``connect`` for the Thinker
        side.  straggler_factor / straggler_min_history: enable each
        host pool's straggler monitor (backups then prefer a different
        host).  vs_capacity_bytes / vs_spill: per-shard memory bound and
        spill-to-disk tier for the cluster's Value Server shards.
        serve_spec: a ``repro_torch.serving.shard.ServeSpec`` for the hosts
        that declare ``inference_shards`` (required iff any does); its
        topic must match ``spec.serve_topic`` so the partition homes the
        serving traffic where the shards drain it."""
        self.spec = spec
        self.methods = list(methods)
        self.serve_spec = serve_spec
        if spec.inference_hosts:
            if serve_spec is None:
                raise ValueError(
                    f"hosts {spec.inference_hosts} declare inference"
                    " shards but the launcher got no serve_spec")
            if serve_spec.topic != spec.serve_topic:
                raise ValueError(
                    f"serve_spec.topic {serve_spec.topic!r} !="
                    f" spec.serve_topic {spec.serve_topic!r}: the"
                    " partition would home the traffic away from the"
                    " shards")
        self.proxy_threshold = proxy_threshold
        self.straggler_factor = straggler_factor
        self.straggler_min_history = straggler_min_history
        self.vs_capacity_bytes = vs_capacity_bytes
        self.vs_spill = vs_spill
        self._addresses: Dict[str, tuple] = {}
        self._brokers: Dict[str, _mp.Process] = {}
        self._agents: Dict[str, _mp.Process] = {}
        self._shards: list = []             # [{host, idx, sid, proc, addr}]
        self._infer_shards: list = []       # [{host, idx, proc}]
        self._next_sid = 0
        self.vs_addresses: list = []
        self._dir: Optional[str] = None
        self._stop = threading.Event()
        self._threads: list = []
        self._lock = threading.Lock()
        self._shm_scope: Optional[str] = None
        self.monitor: Optional[CampaignMonitor] = None

    # -- bring-up -----------------------------------------------------------

    def start(self) -> "ClusterLauncher":
        self._dir = tempfile.mkdtemp(prefix="colmena-cluster-")
        spec = self.spec
        # 1) bind every broker address first: the peer map must be
        # complete before any member starts
        socks = {}
        for name in spec.broker_hosts:
            h = spec.host(name)
            if h.address is not None:
                self._addresses[name] = tuple(h.address)  # external broker
                continue
            sock, addr = frames.make_server_socket(
                os.path.join(self._dir, f"{name}.sock"), tcp=True)
            socks[name] = sock
            self._addresses[name] = addr
        partition = spec.partition()
        # one shm scope for the whole cluster: every member advertises
        # it (endpoints op), co-located clients ride the payload lane
        # against any member, and stop() sweeps exactly these segments
        if shm.shm_dir() is not None:
            self._shm_scope = shm.new_scope()
        for name, sock in socks.items():
            every, path = 0.0, None
            if name == spec.coordinator and spec.snapshot_every:
                every, path = spec.snapshot_every, spec.snapshot_path
            p = _mp.Process(
                target=federated_broker_main,
                args=(sock, name, partition, dict(self._addresses),
                      every, path, self._shm_scope),
                daemon=True, name=f"colmena-broker-{name}")
            p.start()
            sock.close()
            self._brokers[name] = p
        # 2) Value Server shards (spec order -> the consistent-hash ring),
        # then push the versioned ring (stable sids + replica factor) to
        # every shard so connected clients agree on placement and stale
        # ones are redirected after a membership change
        for h in spec.hosts:
            for i in range(h.vs_shards):
                self._start_shard(h.name, i)
        if self._shards:
            self._push_vs_ring()
        # 2b) inference shards: forked and supervised like VS shards,
        # but they are *consumers* -- each dials its host's local broker
        # and drains the serve topic (homed there by the partition)
        for h in spec.hosts:
            for i in range(h.inference_shards):
                self._start_infer_shard(h.name, i)
        # 3) host agents (simulated hosts; ssh hosts are started by the
        # operator with ssh_commands)
        for h in spec.hosts:
            if h.pools and h.ssh is None:
                self._start_agent(h)
        # 4) the campaign monitor: a launcher-side daemon scraping every
        # broker's stats_scrape op on a cadence (live depth/lease/shm
        # gauges -> stats-monitor.jsonl next to the trace sinks)
        if obs.enabled():
            self.monitor = CampaignMonitor(dict(self._addresses),
                                           obs.obs_dir()).start()
        return self

    def _host_env(self, name: str) -> Dict[str, str]:
        """The environment a host's agent and inference shards get: the
        spec's map (perf-env idioms + per-host overrides) over an
        observability base.  The obs variables matter on both launch
        paths: forked processes inherit the launcher's REPRO_OBS_DIR /
        sample but need the per-host identity, and the ssh exec path
        inherits nothing at all."""
        env: Dict[str, str] = {}
        if obs.enabled():
            env[obs.ENV_DIR] = obs.obs_dir()
            env[obs.ENV_SAMPLE] = str(obs.sample_rate())
            env[obs.ENV_HOST] = name
        env.update(self.spec.env_for(name))
        return env

    def _start_shard(self, host: str, idx: int) -> dict:
        from repro_torch.core.transport.shards import _shard_main
        sid = self._next_sid
        self._next_sid += 1
        sock, addr = frames.make_server_socket(
            os.path.join(self._dir, f"vs-{host}-{sid}.sock"), tcp=True)
        spill_dir = (os.path.join(self._dir, f"spill-{host}-{sid}")
                     if self.vs_spill else None)
        p = _mp.Process(target=_shard_main,
                        args=(sock, self.vs_capacity_bytes, spill_dir, None),
                        daemon=True, name=f"colmena-vs-{host}-{sid}")
        p.start()
        sock.close()
        entry = {"host": host, "idx": idx, "sid": sid, "proc": p,
                 "addr": addr}
        self._shards.append(entry)
        self.vs_addresses.append(addr)
        return entry

    def _start_infer_shard(self, host: str, idx: int) -> dict:
        from repro_torch.serving.shard import start_inference_shard
        p = start_inference_shard(
            self._addresses[self.spec.local_broker_of(host)],
            self.serve_spec,
            lease_timeout=self.spec.lease_timeout,
            identity=f"infer@{host}:{idx}",
            env=self._host_env(host) or None)
        entry = {"host": host, "idx": idx, "proc": p}
        self._infer_shards.append(entry)
        return entry

    def _live_shards(self) -> list:
        return [e for e in self._shards if e["proc"].is_alive()]

    def _push_vs_ring(self) -> None:
        """Install ring epoch 1 on every shard: stable sids in spec
        order plus the spec's replica factor.  Every
        ``ShardedValueServer.connect`` then adopts the identical
        membership from the shards themselves."""
        ring = {"epoch": 1,
                "members": [(e["sid"], e["addr"]) for e in self._shards],
                "replicas": self.spec.vs_replicas}
        for e in self._shards:
            client = frames.FrameClient(e["addr"])
            try:
                client.request({"op": "vs_set_ring", "ring": ring},
                               retry=True)
            finally:
                client.close()

    def _agent_config(self, h: HostSpec) -> AgentConfig:
        backup = {t: [peer for peer in self.spec.pool_hosts(t)
                      if peer != h.name]
                  for t in h.pools}
        return AgentConfig(
            host=h.name, pools=dict(h.pools),
            broker_address=self._addresses[self.spec.local_broker_of(h.name)],
            lease_timeout=self.spec.lease_timeout,
            backup_hosts=backup, methods=list(self.methods),
            vs_addresses=list(self.vs_addresses) or None,
            proxy_threshold=self.proxy_threshold,
            straggler_factor=self.straggler_factor,
            straggler_min_history=self.straggler_min_history,
            env=self._host_env(h.name))

    def _start_agent(self, h: HostSpec) -> None:
        p = _mp.Process(target=host_agent_main, args=(self._agent_config(h),),
                        name=f"colmena-host-{h.name}")
        p.start()
        self._agents[h.name] = p

    # -- the real-multi-host hook -------------------------------------------

    def write_agent_configs(self, config_dir: str) -> Dict[str, str]:
        """Write one pickled AgentConfig per ssh host (methods must be
        ``"module:qualname"`` strings -- code cannot fork over ssh).
        Returns host -> config path."""
        os.makedirs(config_dir, exist_ok=True)
        out = {}
        for h in self.spec.hosts:
            if h.pools and h.ssh is not None:
                for fn, _ in self.methods:
                    if callable(fn):
                        raise ValueError(
                            f"host {h.name!r} launches over ssh: register"
                            " methods as 'module:qualname' strings, not"
                            " callables")
                path = os.path.join(config_dir, f"{h.name}.agent.pkl")
                with open(path, "wb") as f:
                    pickle.dump(self._agent_config(h), f,
                                protocol=pickle.HIGHEST_PROTOCOL)
                out[h.name] = path
        return out

    def ssh_commands(self, config_dir: str) -> Dict[str, List[str]]:
        """The command an operator (or a future auto-launcher) runs per
        real host: ship the host's config file there and exec the agent
        module against it.  Host environment (perf-env idioms +
        ``HostSpec.env``) rides an ``env`` prefix -- the exec path is
        the one where ``LD_PRELOAD``-style variables actually bite."""
        paths = self.write_agent_configs(config_dir)
        out = {}
        for name, path in paths.items():
            env = self._host_env(name)
            prefix = (["env"] + [f"{k}={v}" for k, v in sorted(env.items())]
                      if env else [])
            out[name] = (["ssh", self.spec.host(name).ssh] + prefix
                         + [sys.executable, "-m", "repro_torch.core.cluster.agent",
                            "--config", path])
        return out

    # -- client-side wiring -------------------------------------------------

    def address_of(self, host: str) -> tuple:
        return self._addresses[host]

    def value_server(self):
        """A fresh client for the cluster's shard ring (None when the
        spec declares no shards).  The client adopts the launcher-pushed
        ring -- stable shard ids, current epoch, and the spec's
        ``vs_replicas`` factor -- from the shards themselves."""
        if not self.vs_addresses:
            return None
        from repro_torch.core.transport.shards import ShardedValueServer
        return ShardedValueServer.connect(
            [e["addr"] for e in self._live_shards()] or self.vs_addresses)

    def connect(self, topics=None, **queues_kw) -> ColmenaQueues:
        """A ``ColmenaQueues`` dialing the thinker host's broker --
        construct the Thinker on it.  Pass ``value_server=`` /
        ``proxy_threshold=`` to proxy large payloads through the
        cluster's shards (``launcher.value_server()``)."""
        transport = ProcTransport(
            address=self.address_of(
                self.spec.local_broker_of(self.spec.thinker_host)),
            lease_timeout=self.spec.lease_timeout)
        return ColmenaQueues(topics or self.spec.topics(),
                             transport=transport, **queues_kw)

    # -- chaos ---------------------------------------------------------------

    def kill_host(self, host: str) -> None:
        """Chaos: SIGKILL the host's whole process group (agent + its
        forked workers -- a node loss) AND its Value Server and
        inference shard processes (they live on that node too).  No
        rescue follows: the dead workers' request-queue leases expire at
        their home brokers and redeliver straight to surviving hosts'
        directly-subscribed workers.  With ``spec.vs_replicas >= 2`` the
        dead VS shards' keys stay readable via their ring successors;
        ``restore_host_shards`` / ``restore_host_inference_shards``
        bring the capacity back afterwards.  A killed inference shard's
        in-flight request leases expire and redeliver to surviving
        shards; rows it already streamed out are deduped by the result
        claim."""
        self.spec.host(host)                # typo'd names raise, not no-op
        if (host not in self._agents
                and not any(e["host"] == host for e in self._shards)
                and not any(e["host"] == host
                            for e in self._infer_shards)):
            raise ValueError(
                f"host {host!r} runs neither a pool agent nor shards:"
                " nothing to kill (a silent no-op here would let a chaos"
                " test pass without injecting its fault)")
        p = self._agents.get(host)
        if p is not None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
            p.join(timeout=5)
        for e in self._shards:
            if e["host"] == host and e["proc"].is_alive():
                e["proc"].kill()
                e["proc"].join(timeout=2)
        for e in self._infer_shards:
            if e["host"] == host and e["proc"].is_alive():
                e["proc"].kill()
                e["proc"].join(timeout=2)

    def restore_host_inference_shards(self, host: str) -> list:
        """Refork every dead inference shard on ``host``.  No ring or
        state to rebuild: a shard is a stateless consumer, and the
        requests its predecessor died holding redeliver by lease expiry
        (to surviving shards, or to these replacements).  Returns the
        replacement entries."""
        dead = [e for e in self._infer_shards
                if e["host"] == host and not e["proc"].is_alive()]
        replaced = []
        for e in dead:
            self._infer_shards.remove(e)
            replaced.append(self._start_infer_shard(host, e["idx"]))
        return replaced

    def restore_host_shards(self, host: str) -> list:
        """Launcher-driven shard recovery: for every dead shard on
        ``host``, fork a replacement (fresh address), then drive one
        ring rebalance per replacement through a management client --
        the new shard joins, lost copies re-replicate from survivors,
        and the dead member leaves the ring.  Stale connected clients
        pick the new ring up via redirect frames on their next request.
        Returns the replacement entries."""
        from repro_torch.core.transport.shards import ShardedValueServer
        dead = [e for e in self._shards
                if e["host"] == host and not e["proc"].is_alive()]
        if not dead:
            return []
        live = self._live_shards()
        if not live:
            raise RuntimeError("no surviving shard to rebalance from")
        # one management client for the whole recovery: its ring tracks
        # each replace_shard's epoch bump as it drives them
        mgmt = ShardedValueServer.connect([x["addr"] for x in live])
        replaced = []
        try:
            for e in dead:
                entry = self._start_shard(host, e["idx"])
                # adopt the sid the ring actually assigned (max+1 rule)
                # so launcher bookkeeping and ring membership never drift
                entry["sid"] = mgmt.replace_shard(e["sid"],
                                                  address=entry["addr"])
                self._next_sid = max(self._next_sid, entry["sid"] + 1)
                self._shards.remove(e)
                if e["addr"] in self.vs_addresses:
                    self.vs_addresses.remove(e["addr"])
                replaced.append(entry)
        finally:
            mgmt.close()
        return replaced

    # -- teardown -----------------------------------------------------------

    def stop(self) -> None:
        self._stop.set()
        if self.monitor is not None:
            # one last scrape while every broker is still up, so the
            # stats log always ends with a complete cluster-wide sample
            self.monitor.stop(final_scrape=True)
            self.monitor = None
        for name, p in self._agents.items():
            if p.is_alive():
                try:
                    os.kill(p.pid, signal.SIGTERM)
                except ProcessLookupError:
                    pass
        for name, p in self._agents.items():
            p.join(timeout=5)
            if p.is_alive():
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass
                p.join(timeout=2)
        for e in self._infer_shards:
            if e["proc"].is_alive():
                e["proc"].terminate()   # SIGTERM: shard exits its loop
        for e in self._infer_shards:
            e["proc"].join(timeout=5)
            if e["proc"].is_alive():
                e["proc"].kill()
                e["proc"].join(timeout=2)
        for e in self._shards:
            try:
                frames.FrameClient(e["addr"]).request({"op": "shutdown"})
            except (ConnectionError, OSError):
                pass
            e["proc"].join(timeout=2)
            if e["proc"].is_alive():
                e["proc"].terminate()
        for name, p in self._brokers.items():
            try:
                frames.FrameClient(
                    self._addresses[name]).request({"op": "shutdown"})
            except (ConnectionError, OSError):
                pass
            p.join(timeout=2)
            if p.is_alive():
                p.terminate()
        for th in self._threads:
            th.join(timeout=2)
        if self._shm_scope is not None:
            # brokers released live segments on graceful shutdown; this
            # reclaims what no registry could see (producers that died
            # pre-handoff, SIGKILLed members) -- safe only now, with
            # every member down
            shm.sweep_scope(self._shm_scope)
        if self._dir is not None:
            import shutil
            shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "ClusterLauncher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
