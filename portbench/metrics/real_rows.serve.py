"""``real_rows.serve``: the share of the decode rows that serve a request
still short of its tokens, in %: over the ``serve.step`` layer spans (one
decode round of ``ServeLoop`` over every group) of the untraced part of the
window, their real rows (the groups' live requests) over their padded rows
(the engine's batch rows). A row that pads a batch to its pow-2 bucket, or
that finished and waits for a compaction, is padding. None where no round
decoded in that part, where the ring dropped spans of the window, or where
the program keeps no ring."""


def read(ctx):
    from repro_torch import observability as obs

    win = ctx["win"]
    if not hasattr(obs, "layer_spans") or not obs.layer_complete_since(
            round(win.t0 * 1e9)):
        return None
    steps = [s.attrs for s in obs.layer_spans()
             if s.name == "serve.step" and win.in_untraced_part(s.t0 / 1e9)
             and win.in_untraced_part(s.t1 / 1e9)]
    rows = sum(a.get("rows", 0) for a in steps)
    real = sum(a.get("real", 0) for a in steps)
    return 100.0 * real / rows if rows else None
