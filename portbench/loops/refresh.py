"""Traffic kind ``refresh``: a closed loop of full-catalogue slate
refreshes. A pass takes every user, in an order drawn from the seed, and
serves them ``microbatch`` at a time through
`ServingEngine.serve_microbatch` (the last call padded by the engine);
every slate comes back to the host before the next pass starts.

Set-up: the data set (the configuration's, from its own seed), the served
factors U, P, Q drawn on the device from ``--seed``, the engine over them
and the train pairs, and one warm-up pass (the kernel library is built or
loaded there). The window runs passes back to back until ``seconds`` have
passed; the pass in flight then completes and counts.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench import compare, devtrace
from portbench.data import synthetic_poi
from portbench.reference import dmf as ref
from portbench.seeds import sub_seed


def served_factors(seed: int, n_users: int, n_items: int, dim: int, scale: float, device):
    """U (I, K), P and Q (I, J, K), float32 normals times ``scale``, drawn
    on ``device`` from ``seed`` in three calls."""
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, "factors"))
    return tuple(torch.randn(shape, generator=g, device=device).mul_(scale)
                 for shape in ((n_users, dim), (n_users, n_items, dim), (n_users, n_items, dim)))


class Bench:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        from repro_torch.core import dmf
        from repro_torch.serving.candidates import build_candidate_index
        from repro_torch.serving.engine import ServingConfig, ServingEngine

        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        data = dict(config["dataset"])
        self.ds = synthetic_poi.generate({k: v for k, v in data.items() if k != "seed"},
                                         data["seed"])
        I, J, K = self.ds.n_users, self.ds.n_items, config["model"]["dim"]
        self.R, self.k = traffic["microbatch"], traffic["k"]
        U, P, Q = served_factors(seed, I, J, K, config["served_scale"], device)
        index = build_candidate_index(self.ds.item_city, self.ds.user_city, n_items=J)
        self.engine = ServingEngine(
            dmf.DMFState(U, P, Q), index,
            ServingConfig(microbatch=self.R, k=self.k, prune=traffic["prune"]),
            train=self.ds.train, device=device)
        del U, P, Q
        rng = np.random.default_rng(sub_seed(seed, "order"))
        self.orders = [rng.permutation(I) for _ in range(traffic["orders"])]
        self.seen_per_user = np.bincount(self.ds.train[:, 0], minlength=I)
        self.pass_ms: list[float] = []
        self.kept: list[tuple] = []
        self.n_slates = self.failed = 0
        self.elapsed = 0.0
        self.profiled: list[np.ndarray] = []     # the users of each profiled dispatch
        self.trace = None
        self._pass(self.orders[-1])           # warm-up: builds or loads the kernels

    def _pass(self, order: np.ndarray, annotate: bool = False):
        outs = []
        span = record_function("portbench.pass") if annotate else contextlib.nullcontext()
        with span:
            for s in range(0, len(order), self.R):
                ids = order[s:s + self.R]
                if annotate:
                    with record_function("portbench.dispatch"):
                        vals, idx, _ = self.engine.serve_microbatch(ids)
                    self.profiled.append(ids)
                else:
                    vals, idx, _ = self.engine.serve_microbatch(ids)
                outs.append((vals, idx))
        return outs

    def run_window(self, seconds: float, trace: bool) -> None:
        tr = self.traffic
        keep_rng = np.random.default_rng(sub_seed(self.seed, "check"))
        trace_from = None if not trace else tr["trace_after_share"] * seconds
        t_start = time.perf_counter()
        deadline = t_start + seconds
        p = 0
        while True:
            order = self.orders[p % len(self.orders)]
            if trace_from is not None and time.perf_counter() - t_start >= trace_from:
                trace_from = None
                with devtrace.capture(self.device) as cap:
                    for q in range(tr["trace_passes"]):
                        outs = self._pass(self.orders[(p + q) % len(self.orders)], annotate=True)
                        self._count(self.orders[(p + q) % len(self.orders)], outs)
                self.trace = cap["trace"]
                p += tr["trace_passes"]
                continue
            t0 = time.perf_counter()
            outs = self._pass(order)
            t1 = time.perf_counter()
            self.pass_ms.append((t1 - t0) * 1e3)
            self._count(order, outs)
            if len(self.kept) < tr["check_passes"] and (not self.kept or keep_rng.random()
                                                        < tr["check_share"]):
                self.kept.append((order, outs))
            p += 1
            if t1 >= deadline:
                break
        self.elapsed = t1 - t_start

    def _count(self, order: np.ndarray, outs: list) -> None:
        got = sum(len(v) for v, _ in outs)
        self.n_slates += got
        self.failed += len(order) - got

    @property
    def attempted(self) -> int:
        return self.n_slates + self.failed

    def end_to_end(self) -> dict:
        return {"slates_per_s": self.n_slates / self.elapsed,
                "refresh_p95_ms": float(np.percentile(self.pass_ms, 95))}

    def free(self) -> None:
        del self.engine

    def judge(self) -> dict:
        """The kept passes' slates against the reference, which draws the
        served factors again from the seed."""
        ref.tf32_off()
        cfg = self.config
        U, P, Q = served_factors(self.seed, self.ds.n_users, self.ds.n_items, cfg["model"]["dim"],
                                 cfg["served_scale"], self.device)
        users = np.concatenate([order for order, _ in self.kept])
        vals = np.concatenate([v for _, outs in self.kept for v, _ in outs])
        ids = np.concatenate([i for _, outs in self.kept for _, i in outs])
        readings = compare.judge_slates((users, vals, ids), U, P, Q, self.ds.train, self.k)
        del U, P, Q
        return readings

    def layer_context(self) -> dict:
        """What the per-layer readers read: the profiled slice, its
        dispatches (real users and their seen entries), its passes."""
        if self.trace is None or not self.trace.device:
            return {}
        spans = self.trace.spans("portbench.dispatch")
        if len(spans) != len(self.profiled):
            raise RuntimeError(f"{len(spans)} dispatch spans in the trace for "
                               f"{len(self.profiled)} profiled dispatches")
        disp = [(s, e, len(users), int(self.seen_per_user[users].sum()))
                for (s, e), users in zip(spans, self.profiled)]
        passes = self.trace.spans("portbench.pass")
        return {"trace": self.trace, "dispatches": disp, "passes": passes,
                "window": (passes[0][0], passes[-1][1]), "n_users": self.ds.n_users,
                "n_items": self.ds.n_items, "seen_total": len(self.ds.train),
                "dim": self.config["model"]["dim"], "k": self.k}
