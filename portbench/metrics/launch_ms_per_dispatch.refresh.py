"""Host milliseconds a dispatch in `serve_microbatch`'s ``engine.launch``
phase (`U[uids]`, kernel 2's wrapper (checks, layout, output) and its
launch): the span's traced wall time less the device-busy time inside
it, over the dispatches."""
from portbench.metrics._engine_phase import host_ms_per_dispatch


def read(ctx, peaks):
    return host_ms_per_dispatch(ctx, "engine.launch")
