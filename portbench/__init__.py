"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

``python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON line. Everything that belongs to one configuration, one
traffic mix or one per-layer metric sits in a file of its own, found by the
name that ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the model's sizes as they are run;
- ``traffic/<traffic>.json``: the parameters of a traffic mix, read by the
  general driver it names (``drivers/<driver>.py``);
- ``limits/<workload>.json``: the limits of the cell's correctness check;
- ``metrics/<metric>.py``: the reader of one per-layer metric, with its
  operation and byte counts.

``reference/`` holds the plain references that decide ``correct``;
``gen/`` the frozen generators of the inputs; ``harness/`` the window, the
profiler's reduction and the table of peaks.
"""
