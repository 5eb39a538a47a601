"""Kernel 3's share of its roofline in training: the least time of its
launches over full rounds (`counts/dmf_step.py`) over the device time of
``dmf_fused_step_kernel`` in the profiled jobs."""
from portbench.counts import dmf_step, least_seconds

PATTERN = r"\bdmf_fused_step_kernel\b"


def read(ctx, peaks):
    jobs = ctx.get("jobs")
    if not jobs or peaks is None:
        return None
    tr = ctx["trace"]
    kern = [k for a, b in jobs for k in tr.kernels(a, b, PATTERN)]
    if not kern:
        return None
    least = len(kern) * least_seconds(*dmf_step.count(ctx["batch_size"], ctx["dim"]), peaks)
    return 100.0 * least / (sum(e - s for s, e, _, _ in kern) / 1e6)
