"""The one latency-percentile definition — port of `latency_percentiles`
in `src/repro/obs/metrics.py`. The metrics registry, span tracer and
telemetry are not ported yet."""
from __future__ import annotations

import numpy as np


def latency_percentiles(latencies_s, qs=(50, 95, 99)) -> dict[str, float]:
    """Seconds in, ``{"p50_ms": ..., "p95_ms": ..., "p99_ms": ...}`` out
    (NaN for an empty stream). Accepts any iterable."""
    lat = np.asarray(list(latencies_s), np.float64)
    if lat.size == 0:
        return {f"p{q}_ms": float("nan") for q in qs}
    lat_ms = lat * 1e3
    return {f"p{q}_ms": float(np.percentile(lat_ms, q)) for q in qs}
