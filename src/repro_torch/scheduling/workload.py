"""Arrival-process load generation: timestamped request streams for
serving — port of `src/repro/scheduling/workload.py` (`Request`,
`WorkloadConfig`, `arrival_times`, `sample_users`, `make_requests`,
`generate`, `replay`, `to_json`, `from_json` and the CLI). numpy only,
with the reference's draws in the reference's order, so one config gives
the same arrivals and users in both packages, bit for bit.

  * ``poisson`` — memoryless arrivals at a mean rate (open-loop load).
  * ``onoff``   — bursty Markov-modulated Poisson: ON windows at
    rate × burst_factor, OFF windows at the residual rate that keeps the
    long-run mean at ``rate_rps``; ``duty_cycle`` is the ON share of each
    period (the commute-peak shape of check-in traffic).
  * trace replay of explicit timestamps (`replay`).

User ids follow ``uniform`` or ``powerlaw`` popularity (p(rank) ∝
rank^-zipf_s over a seed-keyed permutation of the users). Every request
gets ``deadline = arrival + slo_ms`` and a priority drawn uniformly from
[0, priority_levels) (higher is more urgent). The CLI:

    PYTHONPATH=src python -m repro_torch.scheduling.workload \\
        --process onoff --rate 2000 --n 4096 --users powerlaw \\
        --n-users 1024 --slo-ms 50 -o trace.json
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    """One timestamped serving request (times in seconds)."""
    rid: int                    # arrival index — ties broken by rid
    user: int
    arrival: float
    deadline: float             # arrival + SLO; inf = best effort
    priority: int = 0           # higher = dispatched first within a queue

    @property
    def slo_s(self) -> float:
        return self.deadline - self.arrival


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    n_requests: int = 1024
    rate_rps: float = 2000.0        # long-run mean offered load
    process: str = "poisson"        # poisson | onoff
    burst_factor: float = 4.0       # ON-window rate multiplier (onoff);
                                    # burst_factor · duty_cycle ≤ 1 keeps
                                    # the OFF rate non-negative
    duty_cycle: float = 0.2         # ON fraction of each period (onoff)
    period_s: float = 0.05          # ON+OFF cycle length (onoff)
    users: str = "uniform"          # uniform | powerlaw
    zipf_s: float = 1.1             # power-law exponent (powerlaw)
    slo_ms: float = 50.0            # per-request deadline; <=0 or inf = none
    priority_levels: int = 1
    seed: int = 0

    def __post_init__(self):
        if self.process not in ("poisson", "onoff"):
            raise ValueError(f"process {self.process!r} (poisson or onoff)")
        if self.users not in ("uniform", "powerlaw"):
            raise ValueError(f"users {self.users!r} (uniform or powerlaw)")
        if self.process == "onoff":
            if not 0.0 < self.duty_cycle < 1.0:
                raise ValueError(f"onoff: duty_cycle {self.duty_cycle} not in (0, 1)")
            # the OFF rate rate·(1-φ·b)/(1-φ) must stay non-negative
            if self.burst_factor * self.duty_cycle > 1.0 + 1e-9:
                raise ValueError("onoff: burst_factor * duty_cycle must be <= 1 so the OFF "
                                 "rate is non-negative while the mean stays rate_rps")


def arrival_times(cfg: WorkloadConfig, rng: np.random.Generator) -> np.ndarray:
    """(n_requests,) sorted arrival seconds starting at 0."""
    n, rate = cfg.n_requests, cfg.rate_rps
    if n == 0:
        return np.zeros(0, np.float64)
    if not rate > 0:
        raise ValueError(f"rate_rps {rate} must be > 0")
    if cfg.process == "poisson":
        gaps = rng.exponential(1.0 / rate, n)
    else:  # onoff: piecewise-constant-intensity Poisson, cycle by cycle
        phi = cfg.duty_cycle
        p = cfg.period_s
        rate_on = rate * cfg.burst_factor
        rate_off = rate * (1.0 - cfg.burst_factor * phi) / (1.0 - phi)
        t, out = 0.0, []
        cycle = 0   # an integer cycle index: deriving it from t by floor
                    # division is float-unstable at the window boundaries
        while len(out) < n:
            on_end = (cycle + phi) * p
            cycle_end = (cycle + 1.0) * p
            if t >= cycle_end:
                cycle += 1
                continue
            in_on = t < on_end
            r = rate_on if in_on else rate_off
            boundary = on_end if in_on else cycle_end
            if r <= 0:  # dead OFF window: jump to the next ON edge
                t = boundary
                continue
            gap = rng.exponential(1.0 / r)
            if t + gap < boundary:
                t += gap
                out.append(t)
            else:
                t = boundary    # the rate changes at the boundary: restart the
                                # draw (memorylessness makes the restart exact)
        times = np.asarray(out, np.float64)
        return times - times[0]
    times = np.cumsum(gaps)
    return times - times[0]


def sample_users(cfg: WorkloadConfig, n_users: int, rng: np.random.Generator) -> np.ndarray:
    """(n_requests,) requesting user ids under the popularity model."""
    if cfg.users == "uniform":
        return rng.integers(0, n_users, cfg.n_requests).astype(np.int64)
    ranks = rng.permutation(n_users)            # which user is rank r
    p = (np.arange(1, n_users + 1, dtype=np.float64)) ** (-cfg.zipf_s)
    p /= p.sum()
    return ranks[rng.choice(n_users, cfg.n_requests, p=p)].astype(np.int64)


def make_requests(times: np.ndarray, users: np.ndarray, slo_ms: float,
                  priorities: np.ndarray | None = None) -> list[Request]:
    """Zip arrival times + users (+ priorities) into Request records."""
    if len(times) != len(users):
        raise ValueError(f"{len(times)} arrival times for {len(users)} users")
    slo = (np.inf if (slo_ms is None or slo_ms <= 0 or np.isinf(slo_ms))
           else slo_ms / 1e3)
    pr = np.zeros(len(times), np.int64) if priorities is None else priorities
    return [Request(rid=i, user=int(u), arrival=float(t), deadline=float(t) + slo,
                    priority=int(p))
            for i, (t, u, p) in enumerate(zip(times, users, pr))]


def generate(cfg: WorkloadConfig, n_users: int) -> list[Request]:
    """Seed-keyed generation: arrivals, then users, then priorities."""
    rng = np.random.default_rng(cfg.seed)
    times = arrival_times(cfg, rng)
    users = sample_users(cfg, n_users, rng)
    pr = (rng.integers(0, cfg.priority_levels, cfg.n_requests)
          if cfg.priority_levels > 1 else None)
    return make_requests(times, users, cfg.slo_ms, pr)


def replay(timestamps, users, slo_ms: float = 50.0, priorities=None) -> list[Request]:
    """Trace replay: explicit sorted arrival seconds + user ids, rebased to
    start at 0."""
    times = np.asarray(timestamps, np.float64)
    if not (np.diff(times) >= 0).all():
        raise ValueError("trace timestamps must be sorted")
    return make_requests(times - (times[0] if len(times) else 0.0),
                         np.asarray(users, np.int64), slo_ms,
                         None if priorities is None else np.asarray(priorities, np.int64))


def to_json(requests: list[Request]) -> dict:
    """Serializable trace (the CLI's output, `from_json`'s input); an
    infinite deadline becomes null."""
    return {
        "arrival_s": [r.arrival for r in requests],
        "user": [r.user for r in requests],
        "deadline_s": [None if np.isinf(r.deadline) else r.deadline for r in requests],
        "priority": [r.priority for r in requests],
    }


def from_json(obj: dict) -> list[Request]:
    return [Request(rid=i, user=int(u), arrival=float(t),
                    deadline=np.inf if d is None else float(d), priority=int(p))
            for i, (t, u, d, p) in enumerate(zip(
                obj["arrival_s"], obj["user"], obj["deadline_s"], obj["priority"]))]


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(prog="repro_torch.scheduling.workload",
                                 description="Generate a timestamped serving-request trace.")
    ap.add_argument("--process", default="poisson", choices=("poisson", "onoff"))
    ap.add_argument("--rate", type=float, default=2000.0, help="mean offered load, requests/sec")
    ap.add_argument("--n", type=int, default=1024, help="number of requests")
    ap.add_argument("--n-users", type=int, default=1024, help="user-id universe size")
    ap.add_argument("--users", default="uniform", choices=("uniform", "powerlaw"))
    ap.add_argument("--zipf-s", type=float, default=1.1)
    ap.add_argument("--burst-factor", type=float, default=4.0)
    ap.add_argument("--duty-cycle", type=float, default=0.2)
    ap.add_argument("--period-s", type=float, default=0.05)
    ap.add_argument("--slo-ms", type=float, default=50.0)
    ap.add_argument("--priority-levels", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("-o", "--out", default="", help="output JSON path (default: stdout)")
    args = ap.parse_args(argv)
    cfg = WorkloadConfig(
        n_requests=args.n, rate_rps=args.rate, process=args.process,
        burst_factor=args.burst_factor, duty_cycle=args.duty_cycle, period_s=args.period_s,
        users=args.users, zipf_s=args.zipf_s, slo_ms=args.slo_ms,
        priority_levels=args.priority_levels, seed=args.seed)
    payload = json.dumps(to_json(generate(cfg, args.n_users)), indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload)
        print(f"wrote {args.n} requests to {args.out}")
    else:
        print(payload)


if __name__ == "__main__":
    main()
