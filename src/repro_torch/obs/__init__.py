"""Observability layer of the port — mirrors `repro.obs`'s exports
(`src/repro/obs/__init__.py:22-27`):

* `obs.metrics`   — process-wide registry of counters, gauges and
  histograms with labels, and the one `latency_percentiles` definition;
* `obs.trace`     — nestable span tracing exported as Chrome-trace JSON,
  with a `torch.profiler` bridge and device-memory snapshots;
* `obs.telemetry` — per-epoch training telemetry assembled on the host
  from fixed-shape device reductions summed through the epoch.

All off by default. Telemetry on leaves factor trajectories bit for bit
those of a run with it off (reductions only, no rng draws).
"""
from repro_torch.obs.metrics import (MetricsRegistry, get_registry,  # noqa: F401
                                     latency_percentiles, set_registry)
from repro_torch.obs.telemetry import (TELE_KEYS, TELE_W, EpochCollector,  # noqa: F401
                                       device_stats_to_dict)
from repro_torch.obs.trace import (Tracer, configure_tracing, get_tracer,  # noqa: F401
                                   set_tracer, span)
