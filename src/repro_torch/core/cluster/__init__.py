"""Multi-host cluster fabric (the paper's §V scale-out topology).

The transport fabric of ``repro_torch.core.transport`` crosses *process*
boundaries; this package crosses *host* boundaries:

- ``spec``       -- declarative ``ClusterSpec``/``HostSpec``: which hosts
  exist, who runs a broker / worker pools / Value Server shards, where
  the Thinker attaches, and the derived topic partition every member
  agrees on.
- ``federation`` -- per-host brokers, each owning a partition of topics,
  with a verbatim-frame relay so any client reaches any topic through
  its local broker (one extra hop only for non-local topics; leases,
  claims and snapshots keep their exact single-broker semantics).
- ``launcher``   -- materializes the spec: simulated hosts as supervised
  local process groups over TCP, an ssh command hook for real hosts,
  rescue of a dead host's queued work, clean teardown.
- ``agent``      -- the per-host process that runs the pools.

Quick start (two simulated hosts)::

    from repro_torch.core.cluster import ClusterSpec, HostSpec, ClusterLauncher

    spec = ClusterSpec([
        HostSpec("h0", pools={"simulate": 4}, thinker=True),
        HostSpec("h1", pools={"simulate": 4}),
    ])
    with ClusterLauncher(spec, methods=[(my_sim_fn,
                                         {"topic": "simulate"})]) as lc:
        queues = lc.connect()
        MyThinker(queues).run()
"""
from repro_torch.core.cluster.launcher import ClusterLauncher  # noqa: F401
from repro_torch.core.cluster.spec import ClusterSpec, HostSpec  # noqa: F401
