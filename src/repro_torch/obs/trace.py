"""Nestable span tracing with Chrome-trace/Perfetto export — port of
`src/repro/obs/trace.py` (`Tracer`, the shared null context, `get_tracer`,
`set_tracer`, `configure_tracing`, `span`), with the accelerator bridges
in PyTorch: `Tracer.torch_profiler` (the reference's `jax_profiler`,
:156-166) and `device_memory_snapshot` (:169-187).

A `Tracer` records host spans (thread-safe, nesting tracked per thread)
and exports them as the Chrome trace-event JSON that Perfetto and
``chrome://tracing`` load. A span is stamped with the monotonic
`perf_counter_ns`, mapped onto the wall-clock epoch by one offset taken
when the tracer starts: that is the clock of `torch.profiler`'s traces,
and the export writes ``baseTimeNanoseconds`` as the profiler's does
(an event's absolute time is that base plus its ``ts`` in µs), so the
two files line up.

A tracer records while it is enabled (`configure_tracing(True)`, the
``--trace-out`` flag) or while a torch profiler is recording in the
process. Otherwise the module-level `span()` returns a shared null
context manager (no allocation, no clock read), so instrumented paths
cost one attribute read more than none. While a profiler records, each
span also opens what `torch.profiler.record_function` of its name opens,
and so lands in the profiler's trace as a ``user_annotation`` on the
profiler's own clock, nested with the operations it launched. The
profiler keeps no arguments of such an annotation: a span's counts are in
the tracer's own events.

Spans time the host. A span around an asynchronous launch closes before
the kernel ends unless the block ends in a host copy of the result, as the
engine's dispatch spans do; the device's own timeline is the profiler's.
"""
from __future__ import annotations

import contextlib
import json
import os
import pathlib
import threading
import time

import torch
from torch.autograd import profiler as _profiler   # `_is_profiler_enabled`: a profiler records

# what `torch.profiler.record_function` opens and closes (a user annotation),
# called without its Python wrapper: a fifth of the cost between two spans
_annotation_enter = torch._C._autograd._record_function_with_args_enter
_annotation_exit = torch._C._autograd._record_function_with_args_exit


class _NullContext:
    """Shared do-nothing context manager for the disabled-tracer path."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullContext()


def _epoch_offset_ns() -> int:
    """Wall-clock epoch ns less `perf_counter_ns`, from the tightest of a
    few paired reads."""
    best = None
    for _ in range(8):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


class _Span:
    """One recording span, its own context manager: entered, it yields
    itself, and a caller may add to ``args`` until it exits. Under a
    profiler it opens the profiler's user annotation first and closes it
    last, so that its own bookkeeping lies inside the annotation."""
    __slots__ = ("tracer", "name", "args", "depth", "parent", "t0_ns", "_rf", "_stack")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self.tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self):
        self._rf = _annotation_enter(self.name) if _profiler._is_profiler_enabled else None
        self.t0_ns = time.perf_counter_ns()
        stack = self._stack = self.tracer._stack()
        self.depth = len(stack)
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        return self

    def __exit__(self, *exc):
        self._stack.pop()
        # one list append: atomic, so threads need no lock to record
        self.tracer._events.append((self.name, self.t0_ns, time.perf_counter_ns(),
                                    threading.get_ident(), self.depth, self.parent, self.args))
        if self._rf is not None:
            _annotation_exit(self._rf)
        return False


class Tracer:
    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._events: list[tuple] = []   # completed spans, as `_Span.__exit__` records them
        self._tls = threading.local()
        self._t0_ns = time.perf_counter_ns()   # trace-relative origin
        self.base_time_ns = self._t0_ns + _epoch_offset_ns()   # its wall-clock epoch ns
        self.profiler_traces: list[pathlib.Path] = []   # written by torch_profiler

    # -- recording ---------------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def span(self, name: str, **args):
        """Time a block while enabled or a torch profiler records (the
        shared null context otherwise). Nesting is tracked per thread: the
        exported event carries its depth and parent span name in ``args``."""
        if not (self.enabled or _profiler._is_profiler_enabled):
            return _NULL
        return _Span(self, name, args)

    # -- export ------------------------------------------------------------
    def events(self) -> list[dict]:
        """Completed spans as Chrome ``X`` events, in completion order:
        ``ts`` and ``dur`` in µs, ``ts`` from `base_time_ns`."""
        raw = list(self._events)
        pid, t0 = os.getpid(), self._t0_ns
        out = []
        for name, a, b, tid, depth, parent, args in raw:
            ev_args = {"depth": depth}
            if parent is not None:
                ev_args["parent"] = parent
            ev_args.update(args)
            out.append({"name": name, "ph": "X", "ts": (a - t0) / 1e3, "dur": (b - a) / 1e3,
                        "pid": pid, "tid": tid, "args": ev_args})
        return out

    def clear(self) -> None:
        self._events.clear()

    def chrome_trace(self) -> dict:
        """The Chrome trace-event document Perfetto loads as is."""
        return {"traceEvents": self.events(), "displayTimeUnit": "ms",
                "baseTimeNanoseconds": self.base_time_ns}

    def export_chrome_trace(self, path) -> dict:
        doc = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(doc, f)
        return doc

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
    unless it is enabled or a torch profiler records, so call sites on hot
    paths stay free."""
    if not (_GLOBAL.enabled or _profiler._is_profiler_enabled):
        return _NULL
    return _Span(_GLOBAL, name, args)
