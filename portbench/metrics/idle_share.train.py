"""The device's idle share over the profiled training jobs: the traced
window less the union of kernel, memcpy and memset intervals."""


def read(ctx, peaks):
    if "window" not in ctx:
        return None
    a, b = ctx["window"]
    return 100.0 * (1.0 - ctx["trace"].busy(a, b) / (b - a))
