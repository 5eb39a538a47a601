"""Device kernels a round of training: the kernels the profiled jobs
launched over their rounds (epochs times whole rounds an epoch)."""


def read(ctx, peaks):
    jobs = ctx.get("jobs")
    if not jobs:
        return None
    tr = ctx["trace"]
    n = sum(len(tr.kernels(s, e)) for s, e in jobs)
    return n / (len(ctx["epochs"]) * ctx["rounds_per_epoch"])
