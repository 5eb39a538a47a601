"""The whole epoch's share of the chip's peak: the least time of each
profiled epoch's events in whole rounds (`counts/train_epoch.py`, with
the senders the reference's sampler draws again and the fan-out of the
reference's walk table) at the published peaks over the epoch's traced
wall time."""
from portbench.counts import least_seconds, train_epoch


def read(ctx, peaks):
    epochs = ctx.get("epochs")
    if not epochs or peaks is None or ctx.get("fanout") is None:
        return None
    if len(epochs) != len(ctx["senders"]):
        return None
    least = sum(least_seconds(*train_epoch.count(s, ctx["fanout"], ctx["dim"]), peaks)
                for s in ctx["senders"])
    return 100.0 * least / (sum(e - s for s, e in epochs) / 1e6)
