"""Host milliseconds a dispatch in `TiledServingEngine.recommend`'s
``tiled.readback`` phase (both slates copied to the host, which waits for
the card): the span's traced wall time less the device-busy time inside
it, over the dispatches."""
from portbench.metrics._engine_phase import host_ms_per_dispatch


def read(ctx, peaks):
    return host_ms_per_dispatch(ctx, "tiled.readback")
