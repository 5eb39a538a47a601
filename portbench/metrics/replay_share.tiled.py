"""The share of the profiled tiled dispatches that the program served by
replaying its captured dispatch plan, from the ``replay`` arg (0 or 1) of
the program's ``tiled.dispatch`` events (`repro_torch.obs.trace`'s global
tracer, which records while a profiler does)."""


def share(events, n_dispatches: int):
    """100 × Σ replay / ``n_dispatches`` over the events named
    ``tiled.dispatch``; None unless there is one for each of the
    ``n_dispatches``, each with its ``replay`` arg."""
    evs = [e["args"] for e in events if e.get("name") == "tiled.dispatch"]
    if not n_dispatches or len(evs) != n_dispatches:
        return None
    if not all("replay" in a for a in evs):
        return None
    return 100.0 * sum(a["replay"] for a in evs) / n_dispatches


def read(ctx, peaks):
    disp = ctx.get("dispatches")
    if not disp:
        return None
    from repro_torch.obs.trace import get_tracer
    return share(get_tracer().events(), len(disp))
