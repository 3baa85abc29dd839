"""``mfu.train``: a retrain's forward and backward operations (three times
the forward's, ``harness/flops.py``, each member over its own bootstrap
sample) per epoch, over the untraced retrains' wall per epoch times the
float32 peak (67 TFLOP/s), in %."""
import numpy as np

from portbench.harness import flops
from portbench.harness.peaks import H100


def read(ctx):
    units = ctx["untraced"]
    if not units:
        return None
    f, idx = ctx["feats"], np.asarray(ctx["idx"])
    mask, bonds = np.asarray(f["mask"])[idx], np.asarray(f["bonds"])[idx]
    per_epoch = 3 * flops.mpnn_forward_flops(
        ctx["config"], mask, flops.adjacency_pairs(bonds, mask))
    epochs = sum(e for _, _, e in units)
    wall = sum(b - a for a, b, _ in units)
    return 100.0 * per_epoch * epochs / (wall * H100["f32_flops"])
