"""Traffic kind ``ingest_refresh_dp``: `loops/ingest_refresh.py`'s closed
loop of online rounds with the DP mechanism on the gradient-exchange
channel. The engine's `DMFConfig` carries the configuration's ``dp``
(``sigma``, ``clip``) and a ``dp_seed`` drawn from ``--seed``
(`dp_seed`), so every outgoing ∂L/∂p message of every update batch is
clipped to C and noised with σC times the counter-keyed stream
(`_dp_message`, kernel 8) before the sender's own line-11 update and its
receivers' scatter. The draw, the rounds, the check-ins, the spans
(``portbench.round``, ``.ingest``, ``.refresh``), the window and the
checked rounds are the online cell's.

The check replays the warm-up and the checked rounds with
`reference/online_dp.py` (the mechanism in float64, its noise stream
written again from the spec) and holds the program to it with the online
cell's readings. At the window's end, with the clock stopped, the loop
also records ``factor_max``, the largest |U|, |P|, |Q| entry, which a
deployment whose noise drove its state to overflow would read as inf or
NaN.

The readers' context adds ``dp_batches``: for each traced round, each
update batch's ``dp`` arg (1 where it ran the mechanism) from the
program's ``online.update`` spans; None where the program records no such
arg.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import compare
from portbench.data import synthetic_poi
from portbench.loops import ingest_refresh as base
from portbench.loops.ingest_refresh import Draw, engine_seed, factor_readings
from portbench.loops.refresh import served_factors
from portbench.reference import dmf as ref_dmf
from portbench.reference import online_dp as ref_online_dp
from portbench.seeds import sub_seed


def dp_seed(seed: int) -> int:
    """The mechanism's base seed (`DMFConfig.dp_seed`), drawn from
    ``--seed``."""
    return sub_seed(seed, "jobs", 1) % 2 ** 31


class Bench(base.Bench):
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        from repro_torch.core import dmf, graph
        from repro_torch.serving.candidates import build_candidate_index
        from repro_torch.serving.engine import ServingConfig, ServingEngine
        from repro_torch.serving.online import OnlineConfig

        if not config.get("dp"):
            raise ValueError("the ingest_refresh_dp traffic runs DP on")
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        data = dict(config["dataset"])
        self.ds = synthetic_poi.generate({k: v for k, v in data.items() if k != "seed"},
                                         data["seed"])
        ds, m, dp = self.ds, config["model"], config["dp"]
        I, J, K = ds.n_users, ds.n_items, m["dim"]
        self.k = traffic["k"]
        cfg = dmf.DMFConfig(n_users=I, n_items=J, dim=K, alpha=m["alpha"], beta=m["beta"],
                            gamma=m["gamma"], lr=m["lr"], neg_samples=m["neg_samples"],
                            init_scale=m["init_scale"], seed=engine_seed(seed),
                            dp_sigma=dp["sigma"], dp_clip=dp["clip"], dp_seed=dp_seed(seed))
        gc = graph.GraphConfig(**config["graph"])
        W = graph.build_adjacency(ds.user_coords, ds.user_city, gc)
        nbr = graph.walk_neighbor_table(W, gc, device=device)
        del W
        U, P, Q = served_factors(seed, I, J, K, config["served_scale"], device)
        index = build_candidate_index(ds.item_city, ds.user_city, n_items=J)
        self.engine = ServingEngine(
            dmf.DMFState(U, P, Q), index,
            ServingConfig(microbatch=traffic["microbatch"], k=self.k, prune=traffic["prune"]),
            train=ds.train, nbr=nbr, dmf_cfg=cfg, device=device)
        del U, P, Q, nbr
        self.online = dict(config["online"])
        self.ocfg = OnlineConfig(**self.online)
        self.draw = Draw(ds, traffic["events_per_round"])
        self.rounds: list[np.ndarray] = []       # each round's check-ins, the warm-up first
        self.round_ms: list[float] = []
        self.checked: list[dict] = []
        self.traced: list[tuple[int, np.ndarray]] = []   # (round, touched users) traced
        self.n_slates = self.failed = 0
        self.elapsed = 0.0
        self.counter = self.trace = self.fanout = None
        self.updates: list[dict] | None = None   # the traced rounds' `online.update` args
        self.factor_max = float("nan")
        self.replayed: tuple[int, int] | None = None   # (released, clipped) by the replay
        self._round(self._draw())                # warm-up: builds or loads the kernels
        self._clear_latencies()

    def run_window(self, seconds: float, trace: bool) -> None:
        from repro_torch.obs.trace import get_tracer
        before = len(get_tracer().events())
        super().run_window(seconds, trace)
        if self.trace is not None:
            self.updates = [e["args"] for e in get_tracer().events()[before:]
                            if e["name"] == "online.update"]
        st = self.engine.state
        self.factor_max = max(float(x.abs().max()) for x in (st.U, st.P, st.Q))

    def judge(self) -> dict:
        """`base.Bench.judge`'s readings against the DP replay, and
        ``factor_max`` (no limit: a non-finite state is what it shows)."""
        cfg, dev = self.config, self.device
        ds = self.ds
        table = ref_dmf.neighbor_table(ds.user_coords, ds.user_city, cfg["graph"], dev)
        self.fanout = (table[1] != 0).sum(1).cpu().numpy()
        initial = served_factors(self.seed, ds.n_users, ds.n_items, cfg["model"]["dim"],
                                 cfg["served_scale"], dev)
        rep = ref_online_dp.replay(*initial, table, dict(cfg["model"]), self.online,
                                   engine_seed(self.seed), cfg["dp"], dp_seed(self.seed))
        del table
        out = {"factor_gap": 0.0, "untouched_moved": 0.0, "stale_slates": 0.0,
               "score_gap": 0.0, "rank_gap": 0.0, "bad_slates": 0.0}
        kept = {c["round"]: c for c in self.checked}
        for r in range(max(kept, default=-1) + 1):
            changed = rep.round(self.rounds[r])
            if r not in kept:
                continue
            c = kept[r]
            gap, moved = factor_readings(c["factors"], rep, initial)
            out["factor_gap"] = max(out["factor_gap"], gap)
            out["untouched_moved"] += moved
            out["stale_slates"] += len(np.setdiff1d(changed, c["touched"]))
            U, P, Q = (x.to(dev) for x in c["factors"])
            seen = np.concatenate([ds.train, *self.rounds[:r + 1]])
            s = compare.judge_slates((c["touched"], c["vals"], c["idx"]), U, P, Q, seen, self.k)
            del U, P, Q
            for name in ("score_gap", "rank_gap"):
                out[name] = max(out[name], s[name])
            out["bad_slates"] += s["bad_slates"]
        self.replayed = (rep.n_released, rep.n_clipped)
        del rep, initial
        out["factor_max"] = self.factor_max
        return out

    def layer_context(self) -> dict:
        """`base.Bench.layer_context` and ``dp_batches`` (each traced
        round's update batches' ``dp`` args; None unless every batch of
        the traced rounds has one)."""
        ctx = super().layer_context()
        if not ctx:
            return ctx
        n = [len(b) for b in ctx["batches"]]
        ups = self.updates or []
        if len(ups) != sum(n) or not all("dp" in a for a in ups):
            ctx["dp_batches"] = None
            return ctx
        flags = [int(a["dp"]) for a in ups]
        ends = np.cumsum(n)
        ctx["dp_batches"] = [flags[e - k:e] for k, e in zip(n, ends)]
        return ctx
