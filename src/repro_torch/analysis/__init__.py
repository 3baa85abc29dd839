"""Static + runtime checking of the port's dispatch fabric's concurrency
invariants: copies of ``repro.analysis``, retargeted at ``repro_torch``.

Two halves:

- ``fabriclint`` -- an AST analyzer over ``src/repro_torch/core/**`` and
  ``src/repro_torch/serving/**`` whose named
  passes encode the invariants the fabric's correctness rests on
  (predicate loops around ``Condition.wait``, the idempotent-op registry
  behind reconnect-resend, lock-guarded lazy init, daemon-thread
  lifecycle, monotonic deadlines, single-pickle-per-hop frame hygiene).
  Run as ``python -m repro_torch.analysis.fabriclint --check``; its
  baseline is ``src/repro_torch/analysis/baseline.json``.

- ``witness`` -- an opt-in runtime lock-order witness: instrumented
  Lock/RLock/Condition wrappers that record each thread's acquisition
  chain, build the global acquisition graph, and fail fast on a cycle.
  The known-good edge set is checked in at
  ``src/repro_torch/analysis/lock_order.toml``; the pytest plugin
  ``repro_torch.analysis.pytest_witness`` (``-p
  repro_torch.analysis.pytest_witness --torch-lock-witness``) activates it
  for a whole test run.
"""
