"""The 95th percentile of the window's epoch wall times on the host clock
(the epochs of unprofiled jobs after the first): the tail of a host-paced
loop, so not an end-to-end metric."""
import numpy as np


def read(ctx, peaks):
    ms = ctx.get("epoch_ms")
    if not ms:
        return None
    return float(np.percentile(ms, 95))
