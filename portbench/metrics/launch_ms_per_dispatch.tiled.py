"""Host milliseconds a dispatch in `TiledServingEngine.recommend`'s
``tiled.launch`` phase (the kernel's wrapper: its checks, its layout and
the launch): the span's traced wall time less the device-busy time inside
it, over the dispatches."""
from portbench.metrics._engine_phase import host_ms_per_dispatch


def read(ctx, peaks):
    return host_ms_per_dispatch(ctx, "tiled.launch")
