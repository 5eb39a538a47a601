"""Host milliseconds a dispatch in `TiledServingEngine.recommend`'s
``tiled.finish`` phase (the copy into the call's outputs and the stats):
the span's traced wall time less the device-busy time inside it, over the
dispatches."""
from portbench.metrics._engine_phase import host_ms_per_dispatch


def read(ctx, peaks):
    return host_ms_per_dispatch(ctx, "tiled.finish")
