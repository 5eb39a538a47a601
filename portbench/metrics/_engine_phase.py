"""Shared by the readers of the dispatch's phase spans: a phase's host
milliseconds a dispatch, from the program's own spans in the trace."""


def host_ms_per_dispatch(ctx, phase: str):
    """The wall time of the ``phase`` spans (``torch.profiler`` user
    annotations the program opens inside `serve_microbatch`) less the
    device-busy union inside them, over the dispatches, as
    ``host_ms_per_dispatch.refresh`` reads the whole dispatch. None unless
    every profiled dispatch holds exactly one span of the phase."""
    disp = ctx.get("dispatches")
    if not disp:
        return None
    tr = ctx["trace"]
    spans = tr.spans(phase)
    if len(spans) != len(disp):
        return None
    for (s, e, _, _), (a, b) in zip(disp, spans):
        if not s <= a <= b <= e:
            return None
    host_us = sum((b - a) - tr.busy(a, b) for a, b in spans)
    return host_us / 1e3 / len(disp)
