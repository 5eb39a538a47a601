"""Traffic kind ``tiled_refresh``: a closed loop of full refreshes of a
million-user deployment served from the tiled store on the card. A pass
takes every user, in an order drawn from the seed, and serves them in one
`TiledServingEngine.recommend(order)` call, ``microbatch`` users a
dispatch (the last padded by the engine); every slate is on the host when
the call returns, before the next pass starts.

Set-up: the world (the benchmark's frozen `data/synthetic_world.py` at the
configuration's seed), the program's geohash index over it
(`build_hierarchical_index`), the factor tables B1, B2, s and U and the
users' check-ins drawn from ``--seed`` (each user's check-ins uniform, with
repeats, over the POIs of the user's own cell, as the reference's split
gives it), the store built from them by the program's
`TiledFactorStore.from_checkins`, its int8 codes, the engine, and one
warm-up pass (the kernel library is built or loaded there). The window
runs passes back to back until ``seconds`` have passed; the pass in flight
then completes and counts.

Host memory stays flat across the window: `EngineStats.request_seconds`
gains an entry a request, so the loop resets ``engine.stats`` after each
pass, as a deployment that reads its stats once a refresh would; a pass's
slates are dropped once counted, but for the passes kept for the check.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench import devtrace
from portbench.counts import tiled_quant
from portbench.data import synthetic_world
from portbench.reference import tiled as ref
from portbench.seeds import sub_seed


def draw_factors(seed: int, n_users: int, n_items: int, dim: int) -> dict:
    """B1 (J, K), B2 (J, K), s (I,), U (I, K) host float32, drawn from
    ``seed`` with the deployment's distributions: B1, s standard normal, B2
    0.1 times one, U one over sqrt(K) times one."""
    rng = np.random.default_rng(sub_seed(seed, "factors", 0))
    return {"B1": rng.standard_normal((n_items, dim)).astype(np.float32),
            "B2": (0.1 * rng.standard_normal((n_items, dim))).astype(np.float32),
            "s": rng.standard_normal(n_users).astype(np.float32),
            "U": (rng.standard_normal((n_users, dim)).astype(np.float32)
                  / np.float32(np.sqrt(dim)))}


def draw_checkins(seed: int, split, per_user: int) -> np.ndarray:
    """(m, 2) int64 (user, POI) pairs: ``per_user`` a user, each uniform
    with repeats over the POIs of the user's cell (none in an empty
    cell)."""
    cell_i, cell_u = split
    n_cells = int(max(cell_i.max(initial=-1), cell_u.max(initial=-1))) + 1
    size = np.bincount(cell_i, minlength=n_cells)
    by_cell = np.argsort(cell_i, kind="stable")
    start = np.concatenate([[0], np.cumsum(size)[:-1]])
    rng = np.random.default_rng(sub_seed(seed, "factors", 1))
    pos = np.floor(rng.random((len(cell_u), per_user)) * size[cell_u][:, None]).astype(np.int64)
    users = np.repeat(np.arange(len(cell_u)), per_user)
    has = np.repeat(size[cell_u] > 0, per_user)
    items = by_cell[(start[cell_u][:, None] + pos).ravel()[has]]
    return np.stack([users[has], items], 1)


class Bench:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        from repro_torch.serving.candidates import build_hierarchical_index
        from repro_torch.serving.engine import ServingConfig
        from repro_torch.serving.store import (SyntheticFactors, TiledFactorStore,
                                               TiledServingEngine)
        from_checkins = TiledFactorStore.from_checkins    # a program without it stops here

        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        w, sv = config["world"], config["serving"]
        I, J, K = w["n_users"], w["n_items"], config["model"]["dim"]
        self.R, self.k = traffic["microbatch"], sv["k"]
        self.world = synthetic_world.generate(I, J, w["n_cities"], w["seed"], w["zipf_a"],
                                              w["city_sigma"])
        user_city, item_city, user_coords, item_coords = self.world
        self.split = ref.cells(item_city, user_city, item_coords, user_coords, sv["cell_cap"])
        self.factors = draw_factors(seed, I, J, K)
        self.checkins = draw_checkins(seed, self.split, sv["seen_per_user"])
        index = build_hierarchical_index(item_city, user_city, item_coords, user_coords,
                                         cell_cap=sv["cell_cap"], pad_to=sv["pad_to"]).flat
        f = self.factors
        store = from_checkins(SyntheticFactors(B1=f["B1"], B2=f["B2"], s_user=f["s"], U=f["U"]),
                              index, self.checkins, device=device)
        store.quantize_int8()
        self.engine = TiledServingEngine(store, ServingConfig(microbatch=self.R, k=self.k),
                                         mode=sv["precision"])
        del store
        # the count's inputs: each user's cell and unseen POIs of that cell
        cell_i, self.cell_u = self.split
        distinct = np.unique(self.checkins[:, 0] * J + self.checkins[:, 1])
        u, j = distinct // J, distinct % J
        inside = np.bincount(u[cell_i[j] == self.cell_u[u]], minlength=I)
        self.cell_size = np.bincount(cell_i, minlength=int(self.cell_u.max()) + 1)
        self.live = self.cell_size[self.cell_u] - inside
        rng = np.random.default_rng(sub_seed(seed, "order"))
        self.orders = [rng.permutation(I) for _ in range(traffic["orders"])]
        self.pass_ms: list[float] = []
        self.kept: list[tuple] = []
        self.n_slates = self.failed = 0
        self.elapsed = 0.0
        self.profiled: list[np.ndarray] = []     # the traced passes' orders
        self.trace = None
        self._pass(self.orders[-1])           # warm-up: builds or loads the kernels
        self.engine.stats.reset()

    def _pass(self, order: np.ndarray, annotate: bool = False):
        span = record_function("portbench.pass") if annotate else contextlib.nullcontext()
        with span:
            return self.engine.recommend(order)

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
                        traced = self.orders[(p + q) % len(self.orders)]
                        self._count(traced, self._pass(traced, annotate=True))
                        self.engine.stats.reset()
                        self.profiled.append(traced)
                self.trace = cap["trace"]
                p += tr["trace_passes"]
                continue
            t0 = time.perf_counter()
            out = self._pass(order)
            t1 = time.perf_counter()
            self.engine.stats.reset()
            self.pass_ms.append((t1 - t0) * 1e3)
            self._count(order, out)
            if len(self.kept) < tr["check_passes"] and (not self.kept or keep_rng.random()
                                                        < tr["check_share"]):
                self.kept.append((order, *out))
            p += 1
            if t1 >= deadline:
                break
        self.elapsed = t1 - t_start

    def _count(self, order: np.ndarray, out) -> None:
        got = len(out[0])
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

    def reference(self) -> ref.Reference:
        sv = self.config["serving"]
        return ref.Reference(self.world, self.factors, self.checkins, cell_cap=sv["cell_cap"],
                             pad_to=sv["pad_to"], k=self.k, device=self.device, split=self.split)

    def judge(self) -> dict:
        """The kept passes' slates, put in user order, against the
        reference's truth."""
        passes = []
        for order, vals, idx in self.kept:
            by_user = (np.empty_like(vals), np.empty_like(idx))
            by_user[0][order], by_user[1][order] = vals, idx
            passes.append(by_user)
        return self.reference().judge(passes)

    def dispatch_counts(self, order: np.ndarray) -> list[tuple[int, int, int, int]]:
        """(real users, POIs of their cells summed over the users, POIs of
        the distinct cells, unseen POIs of their cells) of each dispatch of
        a pass in ``order``."""
        out = []
        for s in range(0, len(order), self.R):
            users = order[s:s + self.R]
            cells = self.cell_u[users]
            out.append((len(users), int(self.cell_size[cells].sum()),
                        int(self.cell_size[np.unique(cells)].sum()),
                        int(self.live[users].sum())))
        return out

    def layer_context(self) -> dict:
        """What the per-layer readers read: the traced passes, their
        window, the (bytes, operations) of each pass and of each dispatch
        (`counts/tiled_quant.py`), and, where the program's
        ``tiled.dispatch`` spans are in the trace one a dispatch, the
        dispatches as (start, end, real users, unseen POIs)."""
        if self.trace is None or not self.trace.device:
            return {}
        passes = self.trace.spans("portbench.pass")
        K = self.config["model"]["dim"]
        per_pass = [[(tiled_quant.count(n, cols, cells, live, K, self.k), n, live)
                     for n, cols, cells, live in self.dispatch_counts(order)]
                    for order in self.profiled]
        per = [d for p in per_pass for d in p]
        ctx = {"trace": self.trace, "passes": passes, "window": (passes[0][0], passes[-1][1]),
               "dispatch_counts": [c for c, _, _ in per],
               "pass_counts": [tuple(map(sum, zip(*(c for c, _, _ in p)))) for p in per_pass]}
        spans = self.trace.spans("tiled.dispatch")
        if len(spans) == len(per):
            ctx["dispatches"] = [(s, e, n, live) for (s, e), (_, n, live) in zip(spans, per)]
        return ctx
