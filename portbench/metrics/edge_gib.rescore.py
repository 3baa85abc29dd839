"""``edge_gib.rescore``: the mean bytes of edge tensor a re-score's
``Surrogate.predict`` allocates, in GiB (2^30 bytes): the ``edge_bytes``
attribute of the ``mpnn.predict`` layer spans that started in the window,
which is the increase over the call of the program's ``edge_bytes`` counter
(``MPNNEnsemble.forward`` adds the bytes of each edge tensor it builds). A
forward that builds no edge tensor reads 0. None where no re-score started
in the window, where the ring dropped spans of the window, or where the
program keeps no ring."""


def read(ctx):
    from repro_torch import observability as obs

    win = ctx["win"]
    if not hasattr(obs, "layer_spans") or not obs.layer_complete_since(
            round(win.t0 * 1e9)):
        return None
    got = [s.attrs["edge_bytes"] for s in obs.layer_spans()
           if s.name == "mpnn.predict" and s.t0 >= win.t0 * 1e9
           and "edge_bytes" in s.attrs]
    return sum(got) / len(got) / 2**30 if got else None
