"""``mfu.serve``: the operations of every prefill and decode call in the
untraced part of the window (``harness/flops.py``, over each call's real
rows and tokens: padding is not counted), over that part's length times
the bfloat16 dense peak (989 TFLOP/s), in %."""
from portbench.harness import flops
from portbench.harness.peaks import H100


def read(ctx):
    calls, win = ctx["untraced"], ctx["win"]
    if not calls:
        return None
    total = sum(flops.lm_call_flops(ctx["config"], c[0], c[6])
                for c in calls)
    return 100.0 * total / (win.untraced_seconds() * H100["bf16_flops"])
