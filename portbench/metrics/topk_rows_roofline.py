"""Kernel 2's share of its roofline in the refresh passes: the least time
of the profiled dispatches' real users (`counts/topk_rows.py`) over the
device time of ``topk_rows_kernel`` in them."""
from portbench.counts import least_seconds, topk_rows

PATTERN = r"\btopk_rows_kernel\b"


def read(ctx, peaks):
    disp = ctx.get("dispatches")
    if not disp or peaks is None:
        return None
    tr = ctx["trace"]
    kern = tr.kernels(*ctx["window"], PATTERN)
    if len(kern) != len(disp):
        return None
    least = sum(least_seconds(*topk_rows.count(n, ctx["n_items"], ctx["dim"], ctx["k"], seen),
                              peaks) for _, _, n, seen in disp)
    return 100.0 * least / (sum(e - s for s, e, _, _ in kern) / 1e6)
