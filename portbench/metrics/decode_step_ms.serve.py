"""``decode_step_ms.serve``: the mean host time of a ``decode_batch`` call,
which ends on the tokens' host copy, over the untraced calls, in ms."""


def read(ctx):
    ms = [1e3 * (c[2] - c[1]) for c in ctx["untraced"] if c[0] == "decode"]
    return sum(ms) / len(ms) if ms else None
