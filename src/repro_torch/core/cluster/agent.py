"""The host agent: what actually runs on a (simulated or real) host.

One agent process per pool-running host.  It dials the host's *local*
broker, builds a ``ColmenaQueues`` over that connection, registers the
campaign's methods, and runs a ``ProcessPoolTaskServer`` with the host's
identity and per-topic backup peers -- then parks until told to stop
(SIGTERM; the launcher's ``stop``), shutting the pool down cleanly.

Simulated hosts are **forked** by the launcher, so method callables
(closures included) travel by inheritance; each agent makes itself a
process-group leader so a chaos ``kill_host`` can take out the agent
*and* its forked workers in one ``killpg`` -- exactly the blast radius
of a real node loss.

Real hosts run the same code via ``python -m repro_torch.core.cluster.agent
--config <file>`` (see ``ClusterLauncher.ssh_commands``): the config is
a pickled ``AgentConfig`` whose methods are ``"module:qualname"``
strings resolved by import, since code cannot fork across machines.
"""
from __future__ import annotations

import importlib
import os
import signal
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch import observability as obs
from repro_torch.core.process_pool import ProcessPoolTaskServer
from repro_torch.core.queues import ColmenaQueues
from repro_torch.core.transport.proc import ProcTransport


@dataclass
class AgentConfig:
    host: str
    pools: Dict[str, int]                   # topic -> worker count
    broker_address: tuple                   # this host's local broker
    lease_timeout: float = 30.0
    backup_hosts: Dict[str, List[str]] = field(default_factory=dict)
    # [(fn_or_"module:qualname", register_kwargs), ...]
    methods: list = field(default_factory=list)
    vs_addresses: Optional[list] = None     # Value Server shard addresses
    proxy_threshold: Optional[int] = None
    straggler_factor: Optional[float] = None
    straggler_min_history: int = 5
    # extra environment for this host (ClusterSpec.env_for): applied to
    # os.environ before the pool forks, so workers inherit it ahead of
    # their first jax/XLA import
    env: Dict[str, str] = field(default_factory=dict)


def resolve_method(fn):
    """A callable passes through (fork inheritance); a
    ``"module:qualname"`` string imports (the ssh path)."""
    if callable(fn):
        return fn
    mod, _, qual = fn.partition(":")
    obj = importlib.import_module(mod)
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


def build_pool(cfg: AgentConfig) -> ProcessPoolTaskServer:
    transport = ProcTransport(address=cfg.broker_address,
                              lease_timeout=cfg.lease_timeout)
    vs = None
    if cfg.vs_addresses:
        from repro_torch.core.transport.shards import ShardedValueServer
        # the ring (stable shard ids, epoch, replica factor) comes from
        # the shards themselves -- pushed there by the launcher -- so
        # every host's workers replicate and fail over identically, and
        # a post-rebalance agent restart adopts the current membership
        # even when its pickled address list has gone stale
        vs = ShardedValueServer.connect(cfg.vs_addresses)
    queues = ColmenaQueues(sorted(cfg.pools), transport=transport,
                           value_server=vs,
                           proxy_threshold=cfg.proxy_threshold)
    pool = ProcessPoolTaskServer(
        queues, workers_per_topic=dict(cfg.pools), host=cfg.host,
        backup_hosts=dict(cfg.backup_hosts),
        straggler_factor=cfg.straggler_factor,
        straggler_min_history=cfg.straggler_min_history,
        # control-event drain batch, sized to this host's worker count
        # (each in-flight task produces a couple of events)
        intake_batch=max(2 * max(cfg.pools.values(), default=1), 2))
    for fn, kwargs in cfg.methods:
        pool.register(resolve_method(fn), **kwargs)
    return pool


def host_agent_main(cfg: AgentConfig) -> None:
    """Process entry: run the host's pools until SIGTERM."""
    os.setpgrp()                            # killpg takes workers with us
    if cfg.env:
        # before the pool forks: workers inherit this, and XLA-style
        # variables only matter if set ahead of the first jax import
        os.environ.update(cfg.env)
    # claim the trace identity before build_pool's ColmenaQueues would
    # default this process to "thinker": the sink header is written once
    obs.configure(role="agent", host=cfg.host)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    pool = build_pool(cfg)
    try:
        with pool:
            stop.wait()
    except (ConnectionError, OSError):
        pass                                # broker died first: fabric gone
    os._exit(0)


def main(argv=None) -> None:
    import argparse
    import pickle
    p = argparse.ArgumentParser(
        description="Colmena cluster host agent (real-multi-host entry)")
    p.add_argument("--config", required=True,
                   help="pickled AgentConfig (methods as module:qualname)")
    args = p.parse_args(argv)
    with open(args.config, "rb") as f:
        cfg: AgentConfig = pickle.load(f)
    host_agent_main(cfg)


if __name__ == "__main__":
    main()
