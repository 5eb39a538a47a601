"""The whole round's share of the chip's peak: the least time of each
traced round at the published peaks (its ingest's rows over the steps as
`counts/train_epoch.py` counts an epoch's events, with the reference's
walk fan-out, plus its refreshed users' slates as `counts/topk_rows.py`
counts them) over the round's traced wall time."""
from portbench.counts import least_seconds, topk_rows, train_epoch


def read(ctx, peaks):
    rounds = ctx.get("rounds")
    if not rounds or peaks is None or ctx.get("fanout") is None:
        return None
    if len(rounds) != len(ctx["senders"]):
        return None
    least = 0.0
    for senders, n, seen in zip(ctx["senders"], ctx["touched"], ctx["seen_touched"]):
        least += least_seconds(*train_epoch.count(senders, ctx["fanout"], ctx["dim"]), peaks)
        least += least_seconds(*topk_rows.count(n, ctx["n_items"], ctx["dim"], ctx["k"], seen),
                               peaks)
    return 100.0 * least / (sum(e - s for s, e in rounds) / 1e6)
