"""``prefill_ms.serve``: the mean host time of a ``prefill_batch`` call,
which ends on the first tokens' host copy, over the untraced calls, in
ms."""


def read(ctx):
    ms = [1e3 * (c[2] - c[1]) for c in ctx["untraced"] if c[0] == "prefill"]
    return sum(ms) / len(ms) if ms else None
