"""Process-wide metrics registry: counters, gauges and histograms with
labels, a JSONL sink, and the one latency-percentile definition — port of
`src/repro/obs/metrics.py` (`latency_percentiles`, `Counter`, `Gauge`,
`Histogram`, `MetricsRegistry`, `get_registry`, `set_registry`).

Metrics are plain-Python accumulators: no lock on the read path, one
registry lock on series creation. Hot loops never call in; the serving
and scheduling stats objects keep their own fields and `publish()` into a
registry at report time.

A series is (metric name, frozen label set). Labels are keyword arguments
keyed order-insensitively: ``c.inc(shard=0, path="dense")`` and
``c.inc(path="dense", shard=0)`` hit the same series. Registering a name
again with the same kind returns the same metric; a kind clash raises.
"""
from __future__ import annotations

import json
import threading
import time

import numpy as np


def latency_percentiles(latencies_s, qs=(50, 95, 99)) -> dict[str, float]:
    """Seconds in, ``{"p50_ms": ..., "p95_ms": ..., "p99_ms": ...}`` out
    (NaN for an empty stream) — the one percentile definition shared by
    `serving.engine.EngineStats`, `scheduling.metrics` and histograms.
    Accepts any iterable (generators included)."""
    lat = np.asarray(list(latencies_s), np.float64)
    if lat.size == 0:
        return {f"p{q}_ms": float("nan") for q in qs}
    lat_ms = lat * 1e3
    return {f"p{q}_ms": float(np.percentile(lat_ms, q)) for q in qs}


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: tuple) -> str:
    return ",".join(f"{k}={v}" for k, v in key)


class _Metric:
    kind = "abstract"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._series: dict[tuple, object] = {}

    def labels(self) -> list[tuple]:
        return sorted(self._series)


class Counter(_Metric):
    """Monotone accumulator: `inc` only (a `Gauge` sets a value)."""
    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name}: negative inc {value}")
        key = _label_key(labels)
        self._series[key] = self._series.get(key, 0.0) + value

    def value(self, **labels) -> float:
        return float(self._series.get(_label_key(labels), 0.0))

    def _snapshot(self):
        return {_label_str(k): v for k, v in sorted(self._series.items())}


class Gauge(_Metric):
    """Point-in-time value; `set` overwrites."""
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._series[_label_key(labels)] = float(value)

    def value(self, **labels) -> float:
        return float(self._series.get(_label_key(labels), float("nan")))

    def _snapshot(self):
        return {_label_str(k): v for k, v in sorted(self._series.items())}


class Histogram(_Metric):
    """Raw-observation histogram: exact percentiles at snapshot time."""
    kind = "histogram"

    def observe(self, value: float, **labels) -> None:
        self._series.setdefault(_label_key(labels), []).append(float(value))

    def observe_many(self, values, **labels) -> None:
        self._series.setdefault(_label_key(labels), []).extend(float(v) for v in values)

    def reset(self, **labels) -> None:
        self._series[_label_key(labels)] = []

    def values(self, **labels) -> list[float]:
        return list(self._series.get(_label_key(labels), []))

    def percentiles(self, qs=(50, 95, 99), **labels) -> dict[str, float]:
        """Percentiles of the raw observations in ms-suffixed keys; the
        observations are seconds (`latency_percentiles`)."""
        return latency_percentiles(self.values(**labels), qs)

    def _snapshot(self):
        out = {}
        for key, vals in sorted(self._series.items()):
            arr = np.asarray(vals, np.float64)
            s = {"count": int(arr.size)}
            if arr.size:
                s.update(sum=float(arr.sum()), min=float(arr.min()), max=float(arr.max()),
                         mean=float(arr.mean()), p50=float(np.percentile(arr, 50)),
                         p95=float(np.percentile(arr, 95)), p99=float(np.percentile(arr, 99)))
            out[_label_str(key)] = s
        return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _register(self, kind: str, name: str, help: str):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.kind != kind:
                    raise ValueError(f"metric {name!r} already registered as {m.kind}, "
                                     f"requested {kind}")
                return m
            m = _KINDS[kind](name, help)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register("counter", name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register("gauge", name, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._register("histogram", name, help)

    def names(self) -> list[str]:
        return sorted(self._metrics)

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()

    def snapshot(self) -> dict:
        """``{name: {"kind", "help", "values": {label-string: value}}}``:
        counters and gauges report numbers, histograms summary stats
        (count/sum/min/max/mean/p50/p95/p99)."""
        out = {}
        for name in self.names():
            m = self._metrics[name]
            out[name] = {"kind": m.kind, "help": m.help, "values": m._snapshot()}
        return out

    def write_jsonl(self, path, event: str = "snapshot") -> dict:
        """Append one ``{"event", "unix_time", "metrics"}`` line; returns
        the snapshot it wrote."""
        snap = self.snapshot()
        line = {"event": event, "unix_time": time.time(), "metrics": snap}
        with open(path, "a") as f:
            f.write(json.dumps(line) + "\n")
        return snap


_GLOBAL = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _GLOBAL


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    global _GLOBAL
    _GLOBAL = registry
    return registry
