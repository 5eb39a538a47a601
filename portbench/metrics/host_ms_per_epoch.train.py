"""Host milliseconds an epoch of `dmf.fit` (`train_epoch`: sampling, the
uploads, the round dispatches, the per-epoch read): the traced wall time of
the profiled epochs less the device-busy time inside them, over the
epochs."""


def read(ctx, peaks):
    epochs = ctx.get("epochs")
    if not epochs:
        return None
    tr = ctx["trace"]
    return sum((e - s) - tr.busy(s, e) for s, e in epochs) / 1e3 / len(epochs)
