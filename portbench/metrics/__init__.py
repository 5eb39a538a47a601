"""Per-layer metric readers, one file a metric, named as the metric is in
`BENCHMARK.json`. Each has ``read(ctx, peaks) -> float | None``: ``ctx`` is
what the cell's loop gathered (`layer_context`), ``peaks`` the device's
published peaks or None. A reader that finds nothing to read returns None,
and the metric is left out of the run's line."""
