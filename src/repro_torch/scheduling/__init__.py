"""Scheduling subsystem of the port: continuous-batching request serving
over `ServingEngine` (mirrors `repro.scheduling`'s exports).

  workload.py  — arrival-process load generators (Poisson, bursty on/off,
                 trace replay; uniform / power-law user popularity) + CLI
  scheduler.py — per-shard waiting queues, SLO/priority admission control,
                 independent microbatch dispatch, ingest interleaving,
                 and the lockstep baseline
  metrics.py   — per-request (arrival → completion) records, queue gauges,
                 goodput under a p99 SLO
"""
from repro_torch.scheduling.metrics import (QueueGauge, RequestRecord, latency_percentiles,
                                            summarize)
from repro_torch.scheduling.scheduler import (Scheduler, SchedulerConfig, SchedulerReport,
                                              simulate_lockstep)
from repro_torch.scheduling.workload import Request, WorkloadConfig, generate, replay

__all__ = [
    "QueueGauge",
    "Request",
    "RequestRecord",
    "Scheduler",
    "SchedulerConfig",
    "SchedulerReport",
    "WorkloadConfig",
    "generate",
    "latency_percentiles",
    "replay",
    "simulate_lockstep",
    "summarize",
]
