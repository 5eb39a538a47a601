"""Device traces of a run's profiled slice: `capture` runs a block under
`torch.profiler` and hands back a `Trace` of its Chrome trace events, read
from a temporary file under ``TMPDIR`` that is removed at once.

The busy-union arithmetic is that of the program's `obs/trace.py`
`device_busy` (kernel, memcpy and memset intervals merged), with queries
over any interval of the slice. Spans come from the benchmark's own
`torch.profiler.record_function` annotations around its calls into the
program, so they share the trace's clock.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime")


class Trace:
    """The complete events of one profiled slice, times in microseconds."""

    def __init__(self, doc: dict):
        evs = [e for e in doc.get("traceEvents", ()) if e.get("ph") == "X" and "dur" in e]
        self.device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", ""),
                              e.get("cat")) for e in evs if e.get("cat") in DEVICE_CATS)
        self.host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", ""))
                           for e in evs if e.get("cat") in HOST_CATS)
        self._host_starts = [h[0] for h in self.host]
        self.annotations: dict[str, list] = {}
        for e in evs:
            if e.get("cat") == "user_annotation":
                self.annotations.setdefault(e.get("name", ""), []).append(
                    (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        for v in self.annotations.values():
            v.sort()
        merged: list[list[float]] = []
        for a, b, _, _ in self.device:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.merged = merged
        self._starts = [m[0] for m in merged]

    def spans(self, name: str) -> list[tuple[float, float]]:
        return self.annotations.get(name, [])

    def busy(self, a: float, b: float) -> float:
        """Microseconds in [a, b] during which a device operation ran."""
        if b <= a or not self.merged:
            return 0.0
        i = max(bisect.bisect_right(self._starts, a) - 1, 0)
        j = bisect.bisect_left(self._starts, b)
        total = 0.0
        for s, e in self.merged[i:j]:
            total += max(0.0, min(e, b) - max(s, a))
        return total

    def kernels(self, a: float, b: float, pattern: str | None = None) -> list[tuple]:
        """Kernel events starting in [a, b), optionally those whose name
        matches the regular expression ``pattern``."""
        rx = re.compile(pattern) if pattern else None
        i = bisect.bisect_left(self.device, (a,))
        out = []
        for ev in self.device[i:]:
            if ev[0] >= b:
                break
            if ev[3] == "kernel" and (rx is None or rx.search(ev[2])):
                out.append(ev)
        return out

    def breakdown(self, a: float, b: float, n: int = 10) -> dict:
        """The device operations that took most time in [a, b] and the
        idle time between them summed by what the host was doing (the
        innermost host event over the gap's middle), each as [[name,
        seconds], ...], at most ``n`` entries."""
        ops: dict[str, float] = {}
        for s, e, name, _ in self.device:
            if s < b and e > a:
                ops[name] = ops.get(name, 0.0) + (min(e, b) - max(s, a)) / 1e6
        gaps: dict[str, float] = {}
        prev = a
        for s, e in self.merged + [[b, b]]:
            s, e = max(s, a), min(e, b)
            if s > prev:
                who = self._host_at((prev + s) / 2)
                gaps[who] = gaps.get(who, 0.0) + (s - prev) / 1e6
            prev = max(prev, e)
            if prev >= b:
                break
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
        return {"device_ops": top(ops), "idle_gaps": top(gaps)}

    def _host_at(self, t: float, reach: int = 4000) -> str:
        """The host event over ``t`` that started last (scanning back at
        most ``reach`` events, then the benchmark's own spans)."""
        i = bisect.bisect_right(self._host_starts, t)
        for s, e, name in reversed(self.host[max(i - reach, 0):i]):
            if e >= t:
                return name
        inner = [(s, name) for name, v in self.annotations.items() for s, e in v if s <= t <= e]
        return max(inner)[1] if inner else "host outside any traced op"


@contextlib.contextmanager
def capture(device: torch.device):
    """Profile the block (CPU and, on a card, CUDA activity); the yielded
    dict holds the `Trace` under ``"trace"`` once the block has ended."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    out: dict = {}
    with profile(activities=acts) as prof:
        yield out
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            out["trace"] = Trace(json.load(f))
    finally:
        os.unlink(path)
