"""``queue_wait_ms.serve``: the mean time from a request's arrival at the
shard (its decode from the request channel) to its admission into a
prefill, over the requests admitted in the untraced part of the window, in
ms: the program's ``infer_queue`` layer spans, one a request. None where
no request was admitted in that part, where the ring dropped spans of the
window, or where the program keeps no ring."""


def read(ctx):
    from repro_torch import observability as obs

    win = ctx["win"]
    if not hasattr(obs, "layer_spans") or not obs.layer_complete_since(
            round(win.t0 * 1e9)):
        return None
    ms = [(s.t1 - s.t0) / 1e6 for s in obs.layer_spans()
          if s.name == "infer_queue" and win.in_untraced_part(s.t1 / 1e9)]
    return sum(ms) / len(ms) if ms else None
