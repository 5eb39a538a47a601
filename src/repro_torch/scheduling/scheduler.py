"""Continuous-batching request scheduler with SLO-aware admission control
— port of `src/repro/scheduling/scheduler.py` (`SchedulerConfig`,
`SchedulerReport` with `publish`, `Scheduler`, `simulate_lockstep`) for
the port's one-device `ServingEngine`.

The scheduler sits in front of the engine and replaces its drain
discipline with a serving loop:

  * **Per-shard waiting queues, dispatched independently.** A queue fires
    its own `engine.serve_microbatch` once it holds a full microbatch and
    its shard is free. The port's engine serves one device, so there is
    one queue (D = 1) and requests route on ``engine._n_users``; learner
    sharding will set D.
  * **Deadline- and priority-aware admission.** A request whose SLO cannot
    be met behind the queue's backlog is rejected at arrival; one whose
    deadline passes while it waits expires at batch formation. Within a
    queue, higher priority dispatches first.
  * **Tail-batch coalescing**: a partial batch waits at most
    ``max_wait_ms`` for company.
  * **Ingest interleaving.** Online refresh windows (`engine.ingest`) run
    only in idle slots: every queue empty and the refresh's estimated cost
    (a measured EMA, seeded by ``ingest_cost_init_s``) fits before the
    next arrival. `_warm_refresh` builds the kernels and makes the
    refresh's first launches off the clock.

Time model: a virtual clock over real measured compute. Arrivals carry
the workload's timestamps; each dispatch really runs, and its measured
wall time (to the slate's copy back to the host) advances the clock.
Latency is arrival → completion on that clock. Served slates are the
engine's outputs, bit for bit a direct `ServingEngine.recommend` of the
same users at the same factor snapshot.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as trace_lib
from repro_torch.scheduling import metrics as metrics_lib
from repro_torch.scheduling.metrics import (EXPIRED, REJECTED_DEADLINE, REJECTED_QUEUE_FULL,
                                            SERVED, QueueGauge, RequestRecord)
from repro_torch.scheduling.workload import Request

_INF = float("inf")


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    max_wait_ms: float = 2.0     # tail-batch coalescing timer
    queue_cap: int = 256         # per-shard waiting-queue capacity
    admission: str = "deadline"  # "deadline": reject SLO-infeasible arrivals
                                 #   (plus queue_cap); "queue_only": only
                                 #   queue_cap; "none": admit everything
    service_ema: float = 0.3     # EMA weight of the service-time estimate
    expire_undispatchable: bool = True   # at batch formation, drop waiting
                                 # requests that can no longer meet their
                                 # deadline even if served at once
    ingest_cost_init_s: float = 0.25     # assumed cost of an ingest window
                                 # before one has been measured: keeps the
                                 # first refresh out of short idle slivers

    def __post_init__(self):
        if self.admission not in ("deadline", "queue_only", "none"):
            raise ValueError(f"admission {self.admission!r} (deadline, queue_only or none)")


@dataclasses.dataclass
class SchedulerReport:
    records: list[RequestRecord]
    gauges: list[QueueGauge]
    n_dispatches_per_shard: list[int]
    ingest_intervals: list[tuple[float, float]]   # (start, end) virtual seconds
    ingest_reports: list                          # online.RefreshReport per window

    @property
    def n_ingest_windows(self) -> int:
        return len(self.ingest_intervals)

    def served(self) -> list[RequestRecord]:
        """Served records in arrival (rid) order."""
        return sorted((r for r in self.records if r.status == SERVED), key=lambda r: r.rid)

    def summary(self, slo_ms: float | None = None) -> dict:
        return metrics_lib.summarize(self.records, self.gauges, slo_ms)

    def publish(self, registry=None, prefix: str = "scheduler",
                slo_ms: float | None = None) -> dict:
        """Mirror this report's summary into a metrics registry (the global
        one by default); returns the summary it published. Rates,
        fractions and terminal-state totals land as gauges (a report is a
        finished run); the served latencies replace the
        ``{prefix}_request_seconds`` histogram's series."""
        reg = registry if registry is not None else obs_metrics.get_registry()
        s = self.summary(slo_ms)
        for f in ("n_requests", "n_served", "n_rejected_queue_full", "n_rejected_deadline",
                  "n_expired", "n_fallback", "rejected_frac", "expired_frac",
                  "offered_load_rps", "goodput_rps", "slo_attainment"):
            reg.gauge(f"{prefix}_{f}").set(s[f])
        reg.gauge(f"{prefix}_n_ingest_windows").set(self.n_ingest_windows)
        for k, v in s.get("queue", {}).items():   # QueueGauge aggregates
            reg.gauge(f"{prefix}_queue_{k}").set(v)
        h = reg.histogram(f"{prefix}_request_seconds")
        h.reset()
        h.observe_many(r.latency for r in self.served())
        return s


def _warm_refresh(engine, ocfg) -> None:
    """Build the kernels and make the online refresh's first launches
    before the clock starts: one all-padding refresh step (valid = 0
    everywhere) on clones of the engine's U/P/Q, then a synchronise.
    Without it the first ingest window's measured cost holds the kernel
    build, and both the ingest-cost EMA and the window's place on the
    virtual clock are wrong. The clones keep even a zero update's signed
    zeros off the served factors."""
    from repro_torch.core import dmf

    st, cap, dev = engine.state, ocfg.batch_cap, engine.device
    zi = torch.zeros(cap, dtype=torch.int64, device=dev)
    zf = torch.zeros(cap, dtype=torch.float32, device=dev)
    dmf._sparse_batch_update(
        st.U.clone(), st.P.clone(), st.Q.clone(), engine.nbr.idx, engine.nbr.wgt, zi, zi, zf, zf,
        engine.dmf_cfg, valid=zf, rid=torch.arange(cap, dtype=torch.int32, device=dev),
        dp_seed=0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Scheduler:
    """Wraps a `ServingEngine`; `run()` plays a timestamped request stream
    through admission → the per-shard queues → independent microbatch
    dispatch.

    Routing: user u lives on shard ``u // rows`` with rows =
    ``engine._n_users`` on one device (ids outside [0, n_users) are
    clamped for routing; they pass admission like any request and get the
    engine's flagged fallback slate at dispatch)."""

    def __init__(self, engine, cfg: SchedulerConfig = SchedulerConfig()):
        self.engine = engine
        self.cfg = cfg
        self.n_shards = 1
        self._rows = engine._n_users
        self._svc_est: float | None = None   # EMA of measured dispatch seconds
        self._ingest_est: float | None = None

    # ------------------------------------------------------------ routing
    def shard_of(self, user: int) -> int:
        safe = min(max(int(user), 0), self.engine._n_users - 1)
        return min(safe // self._rows, self.n_shards - 1)

    # ---------------------------------------------------------- admission
    def _admit(self, req: Request, queues, busy, now, records) -> None:
        d = self.shard_of(req.user)
        rec = RequestRecord(rid=req.rid, user=req.user, shard=d, arrival=req.arrival,
                            deadline=req.deadline, priority=req.priority)
        records.append(rec)
        if self.cfg.admission != "none" and len(queues[d]) >= self.cfg.queue_cap:
            rec.status = REJECTED_QUEUE_FULL
            return
        if (self.cfg.admission == "deadline" and self._svc_est is not None
                and not math.isinf(req.deadline)):
            R = self.engine.cfg.microbatch
            waves_ahead = len(queues[d]) // R
            est_done = max(busy[d], now) + waves_ahead * self._svc_est + self._svc_est
            if est_done > req.deadline:
                rec.status = REJECTED_DEADLINE
                return
        queues[d].append(rec)

    # ------------------------------------------------------------ dispatch
    def _form_batch(self, queue: list[RequestRecord], now: float) -> list[RequestRecord]:
        """Expire the unservable, then take up to `microbatch` requests in
        (priority desc, arrival, rid) order. Mutates `queue` in place."""
        horizon = now + (self._svc_est or 0.0) if self.cfg.expire_undispatchable else now
        keep = []
        for rec in queue:
            if rec.deadline < horizon:
                rec.status = EXPIRED
            else:
                keep.append(rec)
        keep.sort(key=lambda r: (-r.priority, r.arrival, r.rid))
        R = self.engine.cfg.microbatch
        take, rest = keep[:R], keep[R:]
        queue[:] = rest
        return take

    def _dispatch(self, d: int, take: list[RequestRecord], now: float,
                  n_ingested: int) -> float:
        with trace_lib.span("scheduler.dispatch", shard=d, n=len(take)):
            vals, idx, flags, dt = self.engine.serve_microbatch(
                [r.user for r in take], return_flags=True)
        if self._svc_est is None:
            self._svc_est = dt
        else:
            a = self.cfg.service_ema
            self._svc_est = a * dt + (1 - a) * self._svc_est
        done = now + dt
        for i, rec in enumerate(take):
            rec.status = SERVED
            rec.dispatch_start = now
            rec.completion = done
            rec.fallback = bool(flags[i])
            rec.ingest_epoch = n_ingested
            rec.vals = vals[i]
            rec.idx = idx[i]
        return dt

    # ---------------------------------------------------------------- run
    def run(self, requests: list[Request], ingest_events=(), ocfg=None) -> SchedulerReport:
        """Play the stream to completion. ``ingest_events`` is a sequence of
        (m, 2) check-in arrays; each is one `engine.ingest` window, run
        only in idle slots (a window still pending when the stream ends
        runs after it). Returns the per-request report."""
        from repro_torch.serving import online as online_lib

        eng, D = self.engine, self.n_shards
        R = eng.cfg.microbatch
        max_wait = self.cfg.max_wait_ms / 1e3
        reqs = sorted(requests, key=lambda r: (r.arrival, r.rid))
        queues: list[list[RequestRecord]] = [[] for _ in range(D)]
        busy = [0.0] * D
        records: list[RequestRecord] = []
        gauges: list[QueueGauge] = []
        n_disp = [0] * D
        ingest_pending = list(ingest_events)
        ingest_intervals: list[tuple[float, float]] = []
        ingest_reports = []
        ocfg = ocfg or online_lib.OnlineConfig()
        if ingest_pending:
            _warm_refresh(eng, ocfg)
        clock = reqs[0].arrival if reqs else 0.0
        i = 0
        n = len(reqs)

        def run_ingest_window(at: float) -> float:
            ev = ingest_pending.pop(0)
            t0 = time.perf_counter()
            with trace_lib.span("scheduler.ingest_window", n_events=len(ev)):
                ingest_reports.append(eng.ingest(np.asarray(ev), ocfg))
            din = time.perf_counter() - t0
            self._ingest_est = din if self._ingest_est is None else (
                0.5 * din + 0.5 * self._ingest_est)
            ingest_intervals.append((at, at + din))
            for d in range(D):     # the factors change: serving waits it out
                busy[d] = max(busy[d], at + din)
            return din

        while i < n or any(queues):
            while i < n and reqs[i].arrival <= clock:
                self._admit(reqs[i], queues, busy, clock, records)
                i += 1
            next_arrival = reqs[i].arrival if i < n else _INF
            # the earliest shard that can and should fire
            t_fire, shard = _INF, -1
            for d in range(D):
                if not queues[d]:
                    continue
                t = max(busy[d], clock)
                if len(queues[d]) < R:
                    t = max(t, min(r.arrival for r in queues[d]) + max_wait)
                if t < t_fire:
                    t_fire, shard = t, d
            if shard < 0:
                # everything idle: ingest if it fits, else jump to the next arrival
                est_in = (self._ingest_est if self._ingest_est is not None
                          else self.cfg.ingest_cost_init_s)
                if ingest_pending and (next_arrival == _INF or clock + est_in <= next_arrival):
                    run_ingest_window(clock)
                    continue
                if next_arrival == _INF:
                    break
                clock = next_arrival
                continue
            if next_arrival < t_fire:
                clock = next_arrival   # an arrival may fill a batch earlier
                continue
            clock = max(clock, t_fire)
            take = self._form_batch(queues[shard], clock)
            if not take:               # the queue was all expired
                continue
            dt = self._dispatch(shard, take, clock, len(ingest_intervals))
            busy[shard] = clock + dt
            n_disp[shard] += 1
            waiting = queues[shard]
            gauges.append(QueueGauge(
                t=clock, shard=shard, depth=len(waiting),
                oldest_age=(clock - min(r.arrival for r in waiting) if waiting else 0.0),
                batch_occupancy=len(take) / R))
        while ingest_pending:          # the stream is over: finish the refresh backlog
            clock += run_ingest_window(clock)
        return SchedulerReport(records, gauges, n_disp, ingest_intervals, ingest_reports)


def simulate_lockstep(engine, requests: list[Request]) -> SchedulerReport:
    """The pre-scheduler dispatch discipline on the same virtual clock:
    one wave at a time takes up to `microbatch` FIFO requests from every
    shard queue and completes together, with no admission control and no
    expiry. On one device (D = 1) a wave is one `serve_microbatch`."""
    D = 1
    R = engine.cfg.microbatch
    rows = engine._n_users
    reqs = sorted(requests, key=lambda r: (r.arrival, r.rid))
    queues: list[list[RequestRecord]] = [[] for _ in range(D)]
    records: list[RequestRecord] = []
    gauges: list[QueueGauge] = []
    n_disp = [0] * D
    free = 0.0
    i, n = 0, len(reqs)
    clock = reqs[0].arrival if reqs else 0.0

    def admit_up_to(t: float):
        nonlocal i
        while i < n and reqs[i].arrival <= t:
            r = reqs[i]
            safe = min(max(int(r.user), 0), engine._n_users - 1)
            d = min(safe // rows, D - 1)
            rec = RequestRecord(rid=r.rid, user=r.user, shard=d, arrival=r.arrival,
                                deadline=r.deadline, priority=r.priority)
            records.append(rec)
            queues[d].append(rec)
            i += 1

    while i < n or any(queues):
        admit_up_to(clock)
        if not any(queues):
            clock = reqs[i].arrival
            continue
        t_fire = max(clock, free)
        admit_up_to(t_fire)            # late arrivals still catch this wave
        takes = [q[:R] for q in queues]
        for d in range(D):
            queues[d] = queues[d][len(takes[d]):]
        flat = [rec for t in takes for rec in t]
        out_v, out_i, flags, dt = engine.serve_microbatch([r.user for r in flat],
                                                          return_flags=True)
        done = t_fire + dt
        for j, rec in enumerate(flat):
            rec.status = SERVED
            rec.dispatch_start = t_fire
            rec.completion = done
            rec.fallback = bool(flags[j])
            rec.vals = out_v[j]
            rec.idx = out_i[j]
        for d in range(D):
            if takes[d]:
                n_disp[d] += 1
            gauges.append(QueueGauge(
                t=t_fire, shard=d, depth=len(queues[d]),
                oldest_age=(t_fire - min(r.arrival for r in queues[d]) if queues[d] else 0.0),
                batch_occupancy=len(takes[d]) / R))
        clock = free = done
    return SchedulerReport(records, gauges, n_disp, [], [])
