"""Nestable span tracing with Chrome-trace/Perfetto export — port of
`src/repro/obs/trace.py` (`Tracer`, the shared null context, `get_tracer`,
`set_tracer`, `configure_tracing`, `span`), with the accelerator bridges
in PyTorch: `Tracer.torch_profiler` (the reference's `jax_profiler`,
:156-166) and `device_memory_snapshot` (:169-187), plus `device_busy`,
which reads a profiler trace's device intervals.

A `Tracer` records host wall-clock spans (monotonic `perf_counter_ns`,
thread-safe, nesting tracked per thread) and exports them as the Chrome
trace-event JSON that Perfetto and ``chrome://tracing`` load. The
module-level tracer is disabled by default: `span()` then returns a shared
null context manager (no allocation, no clock read), so instrumented paths
cost nothing until `configure_tracing(True)` (the ``--trace-out`` flag).

Spans time the host. A span around an asynchronous launch closes before
the kernel ends unless the block ends in a host copy of the result, as the
engine's dispatch spans do; the device's own timeline is the profiler's.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import pathlib
import threading
import time

import torch


class _NullContext:
    """Shared do-nothing context manager for the disabled-tracer path."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullContext()


class _Span:
    __slots__ = ("name", "t0_ns", "args", "depth", "parent")

    def __init__(self, name, t0_ns, args, depth, parent):
        self.name = name
        self.t0_ns = t0_ns
        self.args = args
        self.depth = depth
        self.parent = parent


class Tracer:
    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._events: list[dict] = []   # completed chrome "X" events
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._t0_ns = time.perf_counter_ns()   # trace-relative origin
        self.profiler_traces: list[pathlib.Path] = []   # written by torch_profiler

    # -- recording ---------------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    @contextlib.contextmanager
    def span(self, name: str, **args):
        """Time a block. Nesting is tracked per thread: the exported
        event carries its depth and parent span name in ``args``."""
        if not self.enabled:
            yield None
            return
        stack = self._stack()
        parent = stack[-1].name if stack else None
        sp = _Span(name, time.perf_counter_ns(), args, len(stack), parent)
        stack.append(sp)
        try:
            yield sp
        finally:
            stack.pop()
            t1 = time.perf_counter_ns()
            ev_args = {"depth": sp.depth}
            if sp.parent is not None:
                ev_args["parent"] = sp.parent
            ev_args.update(sp.args)
            ev = {
                "name": name,
                "ph": "X",
                "ts": (sp.t0_ns - self._t0_ns) / 1e3,    # µs
                "dur": (t1 - sp.t0_ns) / 1e3,            # µs
                "pid": os.getpid(),
                "tid": threading.get_ident(),
                "args": ev_args,
            }
            with self._lock:
                self._events.append(ev)

    def traced(self, name: str | None = None):
        """Decorator form of `span` (the span name defaults to the
        function's qualified name)."""
        def deco(fn):
            label = name or fn.__qualname__

            @functools.wraps(fn)
            def wrapper(*a, **kw):
                with self.span(label):
                    return fn(*a, **kw)
            return wrapper
        return deco

    def instant(self, name: str, **args) -> None:
        """Zero-duration marker event (chrome ``ph: "i"``)."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "i", "s": "p",
              "ts": (time.perf_counter_ns() - self._t0_ns) / 1e3,
              "pid": os.getpid(), "tid": threading.get_ident(), "args": dict(args)}
        with self._lock:
            self._events.append(ev)

    # -- export ------------------------------------------------------------
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def chrome_trace(self) -> dict:
        """The Chrome trace-event document Perfetto loads as is."""
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path) -> dict:
        doc = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(doc, f)
        return doc

    def span_stats(self) -> dict[str, dict]:
        """Per-span-name aggregates over the recorded complete events:
        ``{name: {count, total_s, mean_s, max_s}}``."""
        agg: dict[str, list[float]] = {}
        for ev in self.events():
            if ev.get("ph") == "X":
                agg.setdefault(ev["name"], []).append(ev["dur"] / 1e6)
        return {
            name: {"count": len(d), "total_s": sum(d), "mean_s": sum(d) / len(d),
                   "max_s": max(d)}
            for name, d in sorted(agg.items())
        }

    # -- accelerator bridges ----------------------------------------------
    @contextlib.contextmanager
    def torch_profiler(self, logdir, device="cuda"):
        """Run a block under `torch.profiler.profile` when the tracer is
        enabled (a no-op yielding None otherwise): CPU activity, plus CUDA
        activity (kernels, copies, memsets) when ``device`` is cuda. Yields
        the profile; on exit writes its Chrome trace into ``logdir`` and
        appends the file's path to `profiler_traces`."""
        if not self.enabled:
            yield None
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        logdir = pathlib.Path(logdir)
        logdir.mkdir(parents=True, exist_ok=True)
        with profile(activities=acts) as prof:
            yield prof
        path = logdir / f"torch_profiler_{os.getpid()}_{len(self.profiler_traces)}.json"
        prof.export_chrome_trace(str(path))
        self.profiler_traces.append(path)


DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def device_busy(trace) -> dict:
    """The device's busy share over a profiled window, from a profiler
    Chrome trace (a path or the loaded document): the union of the CUDA
    kernel, memcpy and memset intervals over the span of all the trace's
    complete events. Raises `ValueError` on a trace with no device event,
    which would otherwise read as an idle device."""
    doc = trace if isinstance(trace, dict) else json.loads(pathlib.Path(trace).read_text())
    evs = [e for e in doc.get("traceEvents", ()) if e.get("ph") == "X" and "dur" in e]
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in evs if e.get("cat") in DEVICE_CATEGORIES)
    if not dev:
        raise ValueError("the trace holds no CUDA kernel, memcpy or memset event")
    t0 = min(float(e["ts"]) for e in evs)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in evs)
    busy, (s, e) = 0.0, dev[0]
    for a, b in dev[1:]:
        if a > e:
            busy += e - s
            s, e = a, b
        else:
            e = max(e, b)
    busy += e - s
    counts = {c: sum(ev.get("cat") == c for ev in evs) for c in DEVICE_CATEGORIES}
    window = t1 - t0
    return {"n_kernel": counts["kernel"], "n_memcpy": counts["gpu_memcpy"],
            "n_memset": counts["gpu_memset"], "busy_ms": busy / 1e3, "window_ms": window / 1e3,
            "busy_share": busy / window if window > 0 else 1.0,
            "idle_share": 1.0 - busy / window if window > 0 else 0.0}


def device_memory_snapshot() -> list[dict]:
    """Per-device `torch.cuda.memory_stats` on each card (numeric entries
    only); on a machine with no card one cpu entry with empty stats."""
    if not torch.cuda.is_available():
        return [{"device": "cpu", "platform": "cpu", "memory_stats": {}}]
    return [{"device": f"cuda:{i}", "platform": "gpu",
             "memory_stats": {k: int(v) for k, v in torch.cuda.memory_stats(i).items()
                              if isinstance(v, (int, float))}}
            for i in range(torch.cuda.device_count())]


_GLOBAL = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _GLOBAL


def set_tracer(tracer: Tracer) -> Tracer:
    global _GLOBAL
    _GLOBAL = tracer
    return tracer


def configure_tracing(enabled: bool = True) -> Tracer:
    """Flip the global tracer; returns it (the event buffer is kept:
    `clear()` empties it)."""
    _GLOBAL.enabled = enabled
    return _GLOBAL


def span(name: str, **args):
    """Span on the global tracer: a shared null context (no allocation)
    while tracing is disabled, so call sites on hot paths stay free."""
    if not _GLOBAL.enabled:
        return _NULL
    return _GLOBAL.span(name, **args)
