"""Device milliseconds a round in the deterministic scatters
(`core/scatter.py` `scatter_add_rows_`, `index_put_(accumulate=True)` on
the card): the sort of the linear indices and the accumulation, by kernel
name, over the profiled jobs' rounds."""

PATTERN = r"indexing_backward|RadixSort|radix_sort|radixSort|index_put"


def read(ctx, peaks):
    jobs = ctx.get("jobs")
    if not jobs:
        return None
    tr = ctx["trace"]
    us = sum(e - s for a, b in jobs for s, e, _, _ in tr.kernels(a, b, PATTERN))
    return us / 1e3 / (len(ctx["epochs"]) * ctx["rounds_per_epoch"])
