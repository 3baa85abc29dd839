"""``admit_poll_ms.serve``: the mean host time of a ``serve.intake`` layer
span (``ServeLoop._intake``, the request channel's wait included) over the
intakes made with at least one decode group active, in the untraced part of
the window, in ms. With groups active the intake waits up to the
admission poll (``ADMIT_POLL``) between decode rounds. None where no such
intake lies in that part, where the ring dropped spans of the window, or
where the program keeps no ring."""


def read(ctx):
    from repro_torch import observability as obs

    win = ctx["win"]
    if not hasattr(obs, "layer_spans") or not obs.layer_complete_since(
            round(win.t0 * 1e9)):
        return None
    ms = [(s.t1 - s.t0) / 1e6 for s in obs.layer_spans()
          if s.name == "serve.intake" and s.attrs.get("groups", 0) >= 1
          and win.in_untraced_part(s.t0 / 1e9)
          and win.in_untraced_part(s.t1 / 1e9)]
    return sum(ms) / len(ms) if ms else None
