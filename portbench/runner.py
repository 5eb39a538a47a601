"""One run of one cell: set-up, the measured window, the read of the
device's peak memory, the program's state freed, the reference's check,
and the metrics. `run_cell` returns the result line's object and the
checks' lines; `run.py` is the command that prints them.
"""
from __future__ import annotations

import time

import torch

from portbench import compare
from portbench.counts import peaks_for
from portbench.manifest import Manifest


def device_of(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             t_start: float | None = None, config_overrides: dict | None = None,
             traffic_overrides: dict | None = None, manifest: Manifest | None = None):
    """Run ``workload`` once. Returns (result, check lines): the result
    holds ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
    with ``trace`` also ``breakdown``, and last ``checks``. ``device="cpu"``
    runs the program's plain-kernel path (for tests at small sizes)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import repro_torch  # noqa: F401  (the program under test: a checkout without it fails here)
    man = manifest or Manifest()
    cell = man.cell(workload)
    config = man.config(workload, config_overrides)
    traffic = man.traffic(workload, traffic_overrides)
    limits = man.limits(workload)
    dev = device_of(device)
    bench = man.loop(traffic["loop"]).Bench(config, traffic, seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start

    bench.run_window(seconds, trace)
    on_card = dev.type == "cuda"
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    e2e = bench.end_to_end()
    bench.free()

    readings = bench.judge()
    ok, checks = compare.verdict(readings, limits)
    correct = ok and bench.attempted > 0 and bench.failed == 0

    device_info = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                   "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": bench.attempted, "failed": bench.failed}
    if not trace:
        metrics = {}
        for m in man.end_to_end(workload):
            value = setup_s if m["name"] == "setup_s" else e2e[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result.update(metrics=metrics, device=device_info)
    else:
        ctx = bench.layer_context()
        peaks = peaks_for(kind)
        metrics = {}
        for m in man.per_layer(workload):
            value = man.reader(m["name"]).read(ctx, peaks)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result.update(metrics=metrics, device=device_info)
        if "window" in ctx:
            a, b = ctx["window"]
            tr = ctx["trace"]
            device_info.update(busy_s=tr.busy(a, b) / 1e6, window_s=(b - a) / 1e6)
            result["breakdown"] = tr.breakdown(a, b)
    checks["failed"] = {"value": bench.failed, "limit": 0}
    result["checks"] = checks
    return result, [f"check {name} {c['value']!r} limit {c['limit']!r}"
                    for name, c in checks.items()]
