"""Declarative cluster topology: which hosts exist and what they run.

A ``ClusterSpec`` is a list of ``HostSpec``s -- name, whether the host
runs a broker, which worker pools (topic -> worker count), how many
Value Server shards, and whether the Thinker attaches there.  From it
the spec derives the two pieces of shared knowledge every federation
member must agree on byte-for-byte:

- ``broker_hosts``: the sorted list of hosts that run brokers (the
  federation membership; its first element is the **coordinator**, the
  broker that standalone claims route to and that runs the federation's
  auto-snapshot).
- ``partition()``: the topic -> home-broker map.  An application topic
  is homed at the broker of the first host (spec order) that pools it,
  so worker dispatch traffic stays on-host; per-host pool channels
  (``pool@<host>:...``) are homed at that host's broker by a naming
  rule the federation applies directly; anything else hashes
  deterministically across the broker hosts.

The spec is pure data (picklable): the launcher forks simulated hosts
that inherit it, and the ssh hook ships it to real hosts as a file.
"""
from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# Where a tcmalloc shared object may live (Debian/Ubuntu layout).  The
# perf-env idiom only sets LD_PRELOAD when one actually exists: pointing
# the loader at a missing library stalls *every* exec on the host.
_TCMALLOC_CANDIDATES = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so.4",
    "/usr/lib/libtcmalloc.so.4",
)


def perf_env_vars(n_local_workers: int) -> Dict[str, str]:
    """The HPC launcher environment idioms, as data:

    - ``XLA_FLAGS=--xla_force_host_platform_device_count=N`` partitions
      the host CPU into one XLA device per local worker, so jax-based
      methods sharing a node each get a device instead of fighting over
      one.
    - tcmalloc via ``LD_PRELOAD`` (only when the library is actually
      installed), with its large-alloc report threshold raised so
      multi-GB device buffers don't spam stderr.
    - ``TF_CPP_MIN_LOG_LEVEL=4`` silences XLA's C++ chatter on worker
      stdout, which on a many-node run otherwise drowns the logs.

    ``LD_PRELOAD`` takes effect on *exec* -- it reaches agents launched
    over ssh (fresh interpreter) but not fork-only simulated hosts,
    which inherit the launcher's already-loaded allocator.  The XLA and
    logging variables just need to be set before the first jax/XLA
    import and work on both paths."""
    env = {
        "XLA_FLAGS": ("--xla_force_host_platform_device_count="
                      f"{max(n_local_workers, 1)}"),
        "TF_CPP_MIN_LOG_LEVEL": "4",
    }
    for so in _TCMALLOC_CANDIDATES:
        if os.path.exists(so):
            env["LD_PRELOAD"] = so
            env["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"] = "60000000000"
            break
    return env


def host_hash_index(name: str, n: int) -> int:
    """Deterministic (process-independent) index of a string into n
    buckets -- md5, matching the Value Server's ring hashing rather than
    Python's salted ``hash``."""
    h = hashlib.md5(name.encode()).digest()
    return int.from_bytes(h[:8], "big") % n


@dataclass
class HostSpec:
    """One host and the roles it runs.

    address: a pre-bound broker address for real multi-host deployments
    (``("tcp", host, port)``); None lets the launcher bind one on
    loopback for a simulated host.  ssh: the ssh destination the real
    multi-host hook targets (``user@node``); None means this host is
    simulated as a local process group.  env: extra environment
    variables for this host's agent and inference shards, applied on
    top of the spec-level perf-env idioms (``ClusterSpec(perf_env=)``)
    so a per-host override always wins."""

    name: str
    broker: bool = True
    pools: Dict[str, int] = field(default_factory=dict)  # topic -> workers
    vs_shards: int = 0
    inference_shards: int = 0    # continuous-batching serving processes
    thinker: bool = False
    address: Optional[tuple] = None
    ssh: Optional[str] = None
    env: Dict[str, str] = field(default_factory=dict)


class ClusterSpec:
    def __init__(self, hosts: List[HostSpec], *,
                 partition: Optional[Dict[str, str]] = None,
                 lease_timeout: float = 30.0,
                 snapshot_every: float = 0.0,
                 snapshot_path: str = "",
                 vs_replicas: int = 1,
                 serve_topic: str = "infer",
                 perf_env: bool = False):
        """partition: explicit topic -> home-broker-host overrides (the
        derived default homes each topic at its first pool host).
        snapshot_every/snapshot_path: periodic auto-snapshot of the
        whole federation, written by the coordinator broker.
        vs_replicas: copies of every Value Server key across the shard
        ring (>=2 keeps keys readable through a shard/node loss; the
        launcher pushes the factor to the shards with the ring, so every
        connected client replicates identically).
        serve_topic: the inference request topic, relevant only when a
        host declares ``inference_shards``: the partition homes it at
        the first such host's broker so serving traffic stays on-host,
        and ``topics()`` registers it for connecting clients.
        perf_env: apply the launcher performance-environment idioms
        (``perf_env_vars``: per-worker XLA host devices, tcmalloc when
        installed, quiet XLA logging) to every host's agent and
        inference shards.  Off by default; ``HostSpec.env`` entries
        override it per host either way."""
        if not hosts:
            raise ValueError("a ClusterSpec needs at least one host")
        if vs_replicas < 1:
            raise ValueError("vs_replicas must be >= 1")
        total_shards = sum(h.vs_shards for h in hosts)
        if vs_replicas > 1 and total_shards and vs_replicas > total_shards:
            raise ValueError(
                f"vs_replicas={vs_replicas} exceeds the {total_shards}"
                " declared Value Server shard(s): a replica factor above"
                " the shard count cannot be satisfied")
        self.vs_replicas = vs_replicas
        self.serve_topic = serve_topic
        self.perf_env = perf_env
        bad_infer = [h.name for h in hosts if h.inference_shards < 0]
        if bad_infer:
            raise ValueError(
                f"negative inference_shards on hosts {bad_infer}")
        names = [h.name for h in hosts]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate host names in spec: {names}")
        for h in hosts:
            if "/" in h.name or ":" in h.name or "@" in h.name:
                raise ValueError(
                    f"host name {h.name!r} may not contain '/', ':' or '@'"
                    " (they delimit worker identities and pool channels)")
        self.hosts = list(hosts)
        self.lease_timeout = lease_timeout
        self.snapshot_every = snapshot_every
        self.snapshot_path = snapshot_path
        self._overrides = dict(partition or {})
        if not self.broker_hosts:
            raise ValueError("no host in the spec runs a broker")
        bad = [t for t, h in self._overrides.items()
               if h not in self.broker_hosts]
        if bad:
            raise ValueError(
                f"partition overrides {bad} name hosts without brokers")
        if snapshot_every and not snapshot_path:
            raise ValueError("snapshot_every is set but snapshot_path is"
                             " empty")
        thinkers = [h.name for h in hosts if h.thinker]
        if len(thinkers) > 1:
            raise ValueError(f"more than one thinker host: {thinkers}")

    # -- derived membership --------------------------------------------------

    @property
    def broker_hosts(self) -> List[str]:
        """Sorted: every federation member derives the identical list
        (and the identical coordinator, its first element)."""
        return sorted(h.name for h in self.hosts if h.broker)

    @property
    def coordinator(self) -> str:
        return self.broker_hosts[0]

    @property
    def thinker_host(self) -> str:
        """Where the Thinker attaches: the flagged host, else the
        coordinator.  (The Thinker itself is the caller's process; this
        only selects which broker it dials.)"""
        for h in self.hosts:
            if h.thinker:
                return h.name
        return self.coordinator

    def local_broker_of(self, name: str) -> str:
        """The broker a client on ``name`` dials: the host's own when it
        runs one, else the coordinator.  Shared by the launcher's agent
        wiring and ``connect`` so a brokerless host's clients always
        have a valid local broker."""
        return name if self.host(name).broker else self.coordinator

    def host(self, name: str) -> HostSpec:
        for h in self.hosts:
            if h.name == name:
                return h
        raise KeyError(name)

    def topics(self) -> List[str]:
        seen = []
        for h in self.hosts:
            for t in h.pools:
                if t not in seen:
                    seen.append(t)
        if self.inference_hosts and self.serve_topic not in seen:
            seen.append(self.serve_topic)
        return seen

    @property
    def inference_hosts(self) -> List[str]:
        """Hosts running inference shards, in spec order."""
        return [h.name for h in self.hosts if h.inference_shards > 0]

    def env_for(self, name: str) -> Dict[str, str]:
        """The environment the launcher applies to ``name``'s agent and
        inference shards: the perf-env idioms (when ``perf_env`` is on,
        sized to the host's own worker + shard count) overlaid with the
        host's explicit ``env`` map.  Empty when neither is set, so the
        default path touches nothing."""
        h = self.host(name)
        env: Dict[str, str] = {}
        if self.perf_env:
            n = sum(h.pools.values()) + h.inference_shards
            env.update(perf_env_vars(n))
        env.update(h.env)
        return env

    def pool_hosts(self, topic: str) -> List[str]:
        """Hosts running a pool for ``topic``, in spec order -- each
        pool's ``backup_hosts`` (cross-host straggler placement) is the
        others."""
        return [h.name for h in self.hosts if topic in h.pools]

    # -- the partition -------------------------------------------------------

    def partition(self) -> Dict[str, str]:
        """Topic -> home broker host for every application topic, with
        explicit overrides applied.  Default rule: the first host (spec
        order) pooling the topic that also runs a broker; else the
        coordinator.  Every broker and the launcher derive this from the
        same spec, which is what makes the federation's routing
        agreement total."""
        part: Dict[str, str] = {}
        for topic in self.topics():
            home = None
            for h in self.hosts:
                if topic in h.pools and h.broker:
                    home = h.name
                    break
                if (topic == self.serve_topic and h.inference_shards
                        and h.broker):
                    # serving traffic is homed with its first shard host
                    # for the same reason pool topics are: the shard's
                    # drain loop stays broker-local
                    home = h.name
                    break
            part[topic] = home or self.coordinator
        part.update(self._overrides)
        return part

    def home_of(self, topic: str) -> str:
        """Resolve any topic (application or generated pool channel) to
        its home broker -- the same rule ``FederatedBroker.home``
        applies frame by frame."""
        return resolve_home(topic, self.partition(), self.broker_hosts)


def resolve_home(topic: str, partition: Dict[str, str],
                 broker_hosts: List[str]) -> str:
    """Shared routing rule (spec side and broker side must never drift):
    explicit partition entry first; then per-host pool channels
    (``pool@<host>:...``, named by ``process_pool.dispatch_topic`` /
    ``control_topic``) home at that host's broker when it has one;
    everything else hashes deterministically over the broker hosts."""
    from repro_torch.core.process_pool import POOL_PREFIX
    home = partition.get(topic)
    if home is not None:
        return home
    if topic.startswith(POOL_PREFIX):
        host = topic[len(POOL_PREFIX):].split(":", 1)[0]
        if host in broker_hosts:
            return host
    return broker_hosts[host_hash_index(topic, len(broker_hosts))]
