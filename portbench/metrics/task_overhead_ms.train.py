"""``task_overhead_ms.train``: the mean time a retrain task spends outside
``Surrogate.train``, in ms. For each retrain of the untraced part of the
window (the driver's units: from ``send_task`` to its result's arrival),
its wall less the ``mpnn.train`` layer span inside it (the whole
``Surrogate.train`` call, which ends on the loss's host read): the queues,
the Value Server, the task's pickles, the worker's hand-off and the
weights' copy to the host. None where no retrain of that part holds exactly
one such span, where the ring dropped spans of the window, or where the
program keeps no ring."""


def read(ctx):
    from repro_torch import observability as obs

    win = ctx["win"]
    if not hasattr(obs, "layer_spans") or not obs.layer_complete_since(
            round(win.t0 * 1e9)):
        return None
    trains = [s for s in obs.layer_spans() if s.name == "mpnn.train"]
    ms = []
    for t_send, t_result, _ in ctx["untraced"]:
        a, b = t_send * 1e9, t_result * 1e9
        inside = [s for s in trains if a <= s.t0 and s.t1 <= b]
        if len(inside) == 1:
            ms.append((b - a - (inside[0].t1 - inside[0].t0)) / 1e6)
    return sum(ms) / len(ms) if ms else None
