"""``idle.rescore``: the share of the traced window in which no operation ran
on the device, in % (``harness/window.py``: the union of the device
operations' intervals)."""
from portbench.harness.window import read_idle as read  # noqa: F401
