"""The whole tiled refresh pass's share of the chip's peak: a pass's least
time at the published peaks (every user's slate through kernel 6's count,
`counts/tiled_quant.py`) over the pass's traced wall time, over the traced
passes."""
from portbench.counts import least_seconds


def read(ctx, peaks):
    passes, counts = ctx.get("passes"), ctx.get("pass_counts")
    if not passes or not counts or len(passes) != len(counts) or peaks is None:
        return None
    least = sum(least_seconds(nbytes, ops, peaks) for nbytes, ops in counts)
    return 100.0 * least / (sum(e - s for s, e in passes) / 1e6)
