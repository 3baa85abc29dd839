"""``mpnn_mp_roofline``: the re-score's message steps against the card's
roofline, in %.

The bound is counted from the model's own inputs to a message step, not
from today's kernel interface: for each step, h (E B N Hd) in, the bond
types (B N N, as the features hold them) and the E x nb edge matrices
(Hd x Hd) in, the adjacency (B N N, float32) in and m (E B N Hd) out, each
byte once; and 2 Hd^2 operations per member for each atom pair the
adjacency holds, in float32 (67 TFLOP/s; bytes at 3.35 TB/s). The least
time of a step is the larger of the two; a re-score takes ``message_steps``
of them over the whole space. The device time is that of the kernels named
``message_pass`` in the traced re-scores. A kernel that never builds the
edge tensor, or that skips empty pairs, reads against the same bound.
"""
import numpy as np

from portbench.harness import flops
from portbench.harness.peaks import bound_seconds

FLOAT32 = 4


def step_bound_seconds(config: dict, feats: dict) -> float:
    E, hd, nb = config["ensemble"], config["hidden"], config["num_bond_types"]
    B, N = np.asarray(feats["mask"]).shape
    pairs = float(np.sum(flops.adjacency_pairs(feats["bonds"],
                                               feats["mask"])))
    nbytes = (2 * E * B * N * hd * FLOAT32                  # h in, m out
              + np.asarray(feats["bonds"]).nbytes           # bond types
              + E * nb * hd * hd * FLOAT32                  # edge matrices
              + B * N * N * FLOAT32)                        # adjacency
    return bound_seconds(2.0 * hd * hd * E * pairs, nbytes, "float32")


def read(ctx):
    trace, win = ctx["trace"], ctx["win"]
    if trace is None:
        return None
    n = sum(1 for t0, _ in ctx["units"] if win.in_traced_part(t0))
    kernel_s = trace.seconds_of(lambda name: "message_pass" in name)
    if n == 0 or kernel_s <= 0:
        return None
    bound = n * ctx["config"]["message_steps"] * step_bound_seconds(
        ctx["config"], ctx["feats"])
    return 100.0 * bound / kernel_s
