"""Host milliseconds a dispatch of `ServingEngine.serve_microbatch` (the
fallback mask, the ids' upload, ``U[uids]``, the launch, the two copies
back): the traced wall time of the dispatches less the device-busy time
inside them, over the dispatches."""


def read(ctx, peaks):
    disp = ctx.get("dispatches")
    if not disp:
        return None
    tr = ctx["trace"]
    host_us = sum((e - s) - tr.busy(s, e) for s, e, _, _ in disp)
    return host_us / 1e3 / len(disp)
