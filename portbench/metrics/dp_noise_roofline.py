"""Kernel 8's share of its roofline in the private online refresh: the
least time of its launches over the update batches that ran the mechanism
(the program's ``online.update`` spans with ``dp`` 1, `counts/dp_clip_noise.py`
over each batch's real rows) over the device time of
``dp_clip_noise_kernel`` inside the traced ingests. None where the program
records no ``dp`` arg, and unless the kernel ran once in each such batch."""
from portbench.counts import dp_clip_noise, least_seconds

PATTERN = r"\bdp_clip_noise_kernel\b"


def read(ctx, peaks):
    ingests, batches, dp = ctx.get("ingests"), ctx.get("batches"), ctx.get("dp_batches")
    if not ingests or not batches or not dp or peaks is None:
        return None
    rows = [n for b, f in zip(batches, dp) for n, on in zip(b, f) if on]
    tr = ctx["trace"]
    kern = [k for a, b in ingests for k in tr.kernels(a, b, PATTERN)]
    if not rows or len(kern) != len(rows):
        return None
    least = sum(least_seconds(*dp_clip_noise.count(n, ctx["dim"]), peaks) for n in rows)
    return 100.0 * least / (sum(e - s for s, e, _, _ in kern) / 1e6)
