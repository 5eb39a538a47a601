"""Kernel 2's useful rows in the profiled dispatches: the requests that
get the factor path's slate (real and not a fallback, whose slate is
overwritten) over the rows launched (padding included), summed from the
args of the program's ``engine.serve_microbatch`` events
(`repro_torch.obs.trace`'s global tracer, which records while a profiler
does)."""


def share(events, n_dispatches: int):
    """100 × Σ(n_real − n_fallback) / Σ rows over the events named
    ``engine.serve_microbatch``; None unless there is one for each of the
    ``n_dispatches``, each with its counts."""
    evs = [e["args"] for e in events if e.get("name") == "engine.serve_microbatch"]
    if not n_dispatches or len(evs) != n_dispatches:
        return None
    if not all({"rows", "n_real", "n_fallback"} <= a.keys() for a in evs):
        return None
    return (100.0 * sum(a["n_real"] - a["n_fallback"] for a in evs)
            / sum(a["rows"] for a in evs))


def read(ctx, peaks):
    disp = ctx.get("dispatches")
    if not disp:
        return None
    from repro_torch.obs.trace import get_tracer
    return share(get_tracer().events(), len(disp))
