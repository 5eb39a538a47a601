"""Kernel 3's share of its roofline in the online refresh: the least time
of its launches over the rounds' update batches (`counts/dmf_step.py`,
the real rows of each batch) over the device time of
``dmf_fused_step_kernel`` inside the traced ingests. None unless the
kernel ran once a batch."""
from portbench.counts import dmf_step, least_seconds

PATTERN = r"\bdmf_fused_step_kernel\b"


def read(ctx, peaks):
    ingests, batches = ctx.get("ingests"), ctx.get("batches")
    if not ingests or not batches or peaks is None:
        return None
    tr = ctx["trace"]
    kern = [k for a, b in ingests for k in tr.kernels(a, b, PATTERN)]
    rows = [n for b in batches for n in b]
    if not kern or len(kern) != len(rows):
        return None
    least = sum(least_seconds(*dmf_step.count(n, ctx["dim"]), peaks) for n in rows)
    return 100.0 * least / (sum(e - s for s, e, _, _ in kern) / 1e6)
