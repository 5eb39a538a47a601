"""Kernel 6's share of its roofline in the traced tiled refresh passes:
the least time of the traced dispatches' real users
(`counts/tiled_quant.py`) over the device time of ``serve_topk_kernel`` on
the int8 tiled store (`TiledQuant<int8_t>`, `int8_t` named ``signed
char`` by the compiler) in them, one launch a dispatch."""
from portbench.counts import least_seconds

PATTERN = r"\bserve_topk_kernel\b.*\bTiledQuant<(signed char|int8_t)>"


def read(ctx, peaks):
    counts = ctx.get("dispatch_counts")
    if not counts or peaks is None:
        return None
    kern = ctx["trace"].kernels(*ctx["window"], PATTERN)
    if len(kern) != len(counts):
        return None
    least = sum(least_seconds(nbytes, ops, peaks) for nbytes, ops in counts)
    return 100.0 * least / (sum(e - s for s, e, _, _ in kern) / 1e6)
