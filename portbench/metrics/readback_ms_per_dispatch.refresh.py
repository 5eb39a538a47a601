"""Host milliseconds a dispatch in `serve_microbatch`'s ``engine.readback``
phase (the two copies back, the wait for the kernel included): the
span's traced wall time less the device-busy time inside it, over the
dispatches."""
from portbench.metrics._engine_phase import host_ms_per_dispatch


def read(ctx, peaks):
    return host_ms_per_dispatch(ctx, "engine.readback")
