"""Host milliseconds a dispatch of `TiledServingEngine.recommend` (the
padded ids, their upload, the kernel's wrapper, the two copies back, the
copy into the call's outputs and the stats): the traced wall time of the
program's ``tiled.dispatch`` spans less the device-busy time inside them,
over the dispatches."""
from portbench.metrics._engine_phase import host_ms_per_dispatch


def read(ctx, peaks):
    return host_ms_per_dispatch(ctx, "tiled.dispatch")
