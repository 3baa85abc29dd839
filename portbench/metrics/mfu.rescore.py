"""``mfu.rescore``: the re-score's forward operations over the wall of the
untraced re-scores times the float32 peak (67 TFLOP/s), in %. The count
(``harness/flops.py``) covers the message steps over the adjacency's pairs,
the GRU over the real atoms and the readout, every member over the whole
space."""
from portbench.harness import flops
from portbench.harness.peaks import H100


def read(ctx):
    units = ctx["untraced"]
    if not units:
        return None
    f = ctx["feats"]
    per = flops.mpnn_forward_flops(
        ctx["config"], f["mask"], flops.adjacency_pairs(f["bonds"], f["mask"]))
    wall = units[-1][1] - ctx["win"].t0
    return 100.0 * per * len(units) / (wall * H100["f32_flops"])
