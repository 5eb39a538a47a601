"""The whole pass's share of the chip's peak: the least time of a full
refresh pass (every user's slate through kernel 2's count, as
`counts/topk_rows.py` has it) at the published peaks over the pass's
traced wall time, over the profiled passes."""
from portbench.counts import least_seconds, topk_rows


def read(ctx, peaks):
    passes = ctx.get("passes")
    if not passes or peaks is None:
        return None
    least = least_seconds(*topk_rows.count(ctx["n_users"], ctx["n_items"], ctx["dim"], ctx["k"],
                                           ctx["seen_total"]), peaks)
    return 100.0 * least * len(passes) / (sum(e - s for s, e in passes) / 1e6)
