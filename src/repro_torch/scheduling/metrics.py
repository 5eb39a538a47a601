"""Request-level serving metrics: records, queue gauges, goodput under an
SLO — port of `src/repro/scheduling/metrics.py` (the status constants,
`RequestRecord`, `QueueGauge`, `latency_percentiles`, `summarize`).

One latency definition everywhere: arrival → completion, per request (the
definition of `EngineStats.request_seconds`). The headline metric is
goodput under a p99 SLO: the rate of requests completed within their
deadline over the serving horizon; a request served late, or never,
counts for nothing.

Definitions in every report:

  offered_load_rps  (n_arrivals - 1) / (last_arrival - first_arrival) —
                    the MLE of a Poisson rate over the arrival window (n
                    arrivals delimit n-1 gaps). A degenerate window (one
                    arrival, or all at one instant) falls back to
                    n / horizon.
  goodput_rps       n_served_within_deadline / horizon,
                    horizon = last_completion - first_arrival
  slo_attainment    n_served_within_deadline / n_arrivals (rejected and
                    expired requests count against it)
  p99_slo_met       p99(latency of served) <= SLO
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.obs import metrics as obs_metrics

# terminal request states
SERVED = "served"
REJECTED_QUEUE_FULL = "rejected_queue_full"   # waiting queue at capacity
REJECTED_DEADLINE = "rejected_deadline"       # admission: SLO infeasible
EXPIRED = "expired"                           # deadline passed while queued


@dataclasses.dataclass
class RequestRecord:
    """Lifecycle of one request through the scheduler."""
    rid: int
    user: int
    shard: int
    arrival: float               # seconds, virtual clock
    deadline: float              # arrival + SLO (inf = no SLO)
    priority: int = 0
    status: str = SERVED
    dispatch_start: float = float("nan")
    completion: float = float("nan")
    fallback: bool = False       # served from the popularity slate
    ingest_epoch: int = 0        # ingest windows applied before dispatch
    vals: np.ndarray | None = None   # served slate (for exactness checks)
    idx: np.ndarray | None = None

    @property
    def latency(self) -> float:
        return self.completion - self.arrival

    @property
    def met_slo(self) -> bool:
        return self.status == SERVED and self.completion <= self.deadline


@dataclasses.dataclass
class QueueGauge:
    """Queue state sampled at each dispatch decision."""
    t: float
    shard: int
    depth: int                   # waiting-queue depth after batch formation
    oldest_age: float            # age of the oldest request still waiting
    batch_occupancy: float       # n_real / microbatch of the fired batch


def latency_percentiles(latencies_s, qs=(50, 95, 99)) -> dict[str, float]:
    """{p50_ms, ...} over per-request latencies (seconds in, ms out):
    `obs.metrics.latency_percentiles`, re-exported here."""
    return obs_metrics.latency_percentiles(latencies_s, qs)


def summarize(records: list[RequestRecord], gauges: list[QueueGauge] | None = None,
              slo_ms: float | None = None) -> dict:
    """A scheduler (or lockstep) run as the report dict; an empty run
    summarizes to zeros."""
    n = len(records)
    served = [r for r in records if r.status == SERVED]
    within = [r for r in served if r.completion <= r.deadline]
    arrivals = np.asarray([r.arrival for r in records], np.float64)
    out = {
        "n_requests": n,
        "n_served": len(served),
        "n_rejected_queue_full": sum(r.status == REJECTED_QUEUE_FULL for r in records),
        "n_rejected_deadline": sum(r.status == REJECTED_DEADLINE for r in records),
        "n_expired": sum(r.status == EXPIRED for r in records),
        "n_fallback": sum(r.fallback for r in served),
    }
    out["rejected_frac"] = (
        (out["n_rejected_queue_full"] + out["n_rejected_deadline"]) / n if n else 0.0)
    out["expired_frac"] = out["n_expired"] / n if n else 0.0
    if n >= 2 and arrivals.max() > arrivals.min():
        # the MLE Poisson rate over the arrival window: n arrivals, n-1 gaps
        out["offered_load_rps"] = float((n - 1) / (arrivals.max() - arrivals.min()))
    elif n >= 1:
        # a degenerate window carries no rate: n / serving horizon
        horizon = (max((r.completion for r in served), default=float("nan"))
                   - float(arrivals.min()))
        out["offered_load_rps"] = float(n / horizon) if served and horizon > 0 else 0.0
    else:
        out["offered_load_rps"] = 0.0
    if served:
        horizon = max(r.completion for r in served) - float(arrivals.min())
        out["goodput_rps"] = len(within) / horizon if horizon > 0 else 0.0
        out["latency_ms"] = latency_percentiles(r.latency for r in served)
    else:
        out["goodput_rps"] = 0.0
        out["latency_ms"] = latency_percentiles(())
    out["slo_attainment"] = len(within) / n if n else 0.0
    if slo_ms is not None:
        p99 = out["latency_ms"]["p99_ms"]
        out["p99_slo_met"] = bool(served) and bool(p99 <= slo_ms)
    if gauges:
        depth = np.asarray([g.depth for g in gauges], np.float64)
        age = np.asarray([g.oldest_age for g in gauges], np.float64)
        occ = np.asarray([g.batch_occupancy for g in gauges], np.float64)
        out["queue"] = {
            "depth_mean": float(depth.mean()),
            "depth_max": int(depth.max()),
            "oldest_age_ms_mean": float(age.mean() * 1e3),
            "oldest_age_ms_max": float(age.max() * 1e3),
            "batch_occupancy_mean": float(occ.mean()),
        }
    return out
