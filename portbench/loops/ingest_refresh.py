"""Traffic kind ``ingest_refresh``: a closed loop of online rounds of the
paper's learners. A round draws ``events_per_round`` new check-ins from
the seed, hands them to `ServingEngine.ingest` (the Eq. 9-11 step on the
card, ``steps`` passes in batches of ``batch_cap`` rows, the gradient
messages scattered to the walk table's receivers, then the seen bits),
then refreshes the slates of the users the round touched with one
`ServingEngine.recommend(report.touched_users)` (``microbatch`` users a
dispatch through the engine's plan, dense, k slates). A round ends when
the last refreshed slate is on the host; its wall time, from the
check-ins handed to ``ingest`` to that slate, is the staleness a check-in
leaves.

The draw of round ``r``: senders with replacement with probability
proportional to their train check-ins + 1, over the users whose home city
holds a POI; each check-in's POI uniform over the sender's home-city POIs
(the candidate index's bucket). Round 0 is the warm-up.

Set-up: the data set (the configuration's, from its own seed), the
program's walk neighbour table built from it, the served U, P, Q drawn on
the device from ``--seed`` (`loops/refresh.py` `served_factors`), the
engine over them with its generator seeded from ``--seed``, and one
warm-up round (the kernel library is built or loaded and the plan
captured there). The window runs rounds back to back until ``seconds``
have passed outside the check's copies (and the checked and traced rounds
have run); the round in flight then completes and counts. The engine's
latency lists are emptied after each round (its counters stay), as a
deployment that reads them once a round would.

The check follows the window's first ``check_rounds`` rounds: after each,
with the clock stopped, the program's U, P, Q are copied to the host
beside the round's refreshed users and slates. The reference
(`reference/online.py`) replays the warm-up and those rounds from the
seeded state, and the readings hold the program to it (`judge`).
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench import compare, devtrace
from portbench.data import synthetic_poi
from portbench.loops.refresh import served_factors
from portbench.reference import dmf as ref_dmf
from portbench.reference import online as ref_online
from portbench.seeds import sub_seed


def engine_seed(seed: int) -> int:
    """The seed of the engine's negative-sampling generator
    (`DMFConfig.seed`), drawn from ``--seed``."""
    return sub_seed(seed, "jobs", 0)


class Draw:
    """The traffic's draw over a data set ``ds``: the senders (users whose
    home city holds a POI) with probabilities proportional to their train
    check-ins + 1, and each city's POIs (``by_city[start[c]:start[c] +
    size[c]]``)."""

    def __init__(self, ds, n: int):
        self.n, self.city_of = n, ds.user_city
        n_cities = int(max(ds.item_city.max(), ds.user_city.max())) + 1
        self.size = np.bincount(ds.item_city, minlength=n_cities)
        self.by_city = np.argsort(ds.item_city, kind="stable")
        self.start = np.concatenate([[0], np.cumsum(self.size)[:-1]])
        self.senders = np.flatnonzero(self.size[ds.user_city] > 0)
        weight = np.bincount(ds.train[:, 0], minlength=ds.n_users) + 1.0
        self.p = weight[self.senders] / weight[self.senders].sum()

    def round(self, seed: int, r: int) -> np.ndarray:
        """Round ``r``'s (n, 2) int64 check-ins (user, POI)."""
        rng = np.random.default_rng(sub_seed(seed, "order", r))
        users = rng.choice(self.senders, size=self.n, p=self.p)
        c = self.city_of[users]
        pos = np.floor(rng.random(self.n) * self.size[c]).astype(np.int64)
        return np.stack([users, self.by_city[self.start[c] + pos]], 1).astype(np.int64)


def factor_readings(prog: tuple, rep: ref_online.OnlineReplay, initial: tuple,
                    block: int = 512) -> tuple[float, int]:
    """(``factor_gap``, ``untouched_moved``) of the program's factors
    ``prog`` = (U, P, Q) (float32, any device) against the replay ``rep``
    and the seeded factors ``initial`` (float32, on the replay's device):

    - ``factor_gap``: over every entry the replay changed since the seeded
      state (U rows of the senders, Q entries of the rows, P entries of
      the receivers), the widest |program - reference| over the larger of
      |reference| and the median |reference| of that leaf's changed
      entries;
    - ``untouched_moved``: the entries the replay left alone whose float32
      bits differ from the seeded ones."""
    dev = rep.device
    gap, moved = 0.0, 0
    masks = (rep.u_changed, rep.p_changed, rep.q_changed)
    for mask, got, want, init in zip(masks, prog, (rep.U, rep.P, rep.Q), initial):
        where = mask.nonzero(as_tuple=True)
        if len(where[0]):
            w = want[where]
            g = got[tuple(i.to(got.device) for i in where)].to(dev, torch.float64)
            scale = torch.maximum(w.abs(), w.abs().median())
            gap = max(gap, float(((g - w).abs() / scale).max()))
        for a in range(0, mask.shape[0], block):
            g = got[a:a + block].to(dev).contiguous().view(torch.int32)
            i = init[a:a + block].contiguous().view(torch.int32)
            m = mask[a:a + block]
            diff = g != i
            moved += int((diff & ~m.reshape(m.shape + (1,) * (diff.dim() - m.dim()))).sum())
    return gap, moved


class Bench:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        from repro_torch.core import dmf, graph
        from repro_torch.serving.candidates import build_candidate_index
        from repro_torch.serving.engine import ServingConfig, ServingEngine
        from repro_torch.serving.online import OnlineConfig

        if config.get("dp"):
            raise ValueError("the ingest_refresh traffic runs DP off")
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        data = dict(config["dataset"])
        self.ds = synthetic_poi.generate({k: v for k, v in data.items() if k != "seed"},
                                         data["seed"])
        ds, m = self.ds, config["model"]
        I, J, K = ds.n_users, ds.n_items, m["dim"]
        self.k = traffic["k"]
        cfg = dmf.DMFConfig(n_users=I, n_items=J, dim=K, alpha=m["alpha"], beta=m["beta"],
                            gamma=m["gamma"], lr=m["lr"], neg_samples=m["neg_samples"],
                            init_scale=m["init_scale"], seed=engine_seed(seed))
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
        self.counter = None
        self.trace = None
        self.fanout = None
        self._round(self._draw())                # warm-up: builds or loads the kernels
        self._clear_latencies()

    def _draw(self) -> np.ndarray:
        ev = self.draw.round(self.seed, len(self.rounds))
        self.rounds.append(ev)
        return ev

    def _round(self, events: np.ndarray, annotate: bool = False):
        """One round: (report, slates' values, slates' ids)."""
        if not annotate:
            report = self.engine.ingest(events, self.ocfg)
            return (report, *self.engine.recommend(report.touched_users))
        with record_function("portbench.round"):
            with record_function("portbench.ingest"):
                report = self.engine.ingest(events, self.ocfg)
                if self.device.type == "cuda":       # the ingest's kernels end inside it
                    torch.cuda.synchronize(self.device)
            with record_function("portbench.refresh"):
                out = self.engine.recommend(report.touched_users)
        return (report, *out)

    def _clear_latencies(self) -> None:
        self.engine.stats.request_seconds.clear()
        self.engine.stats.dispatch_seconds.clear()

    def _counter(self) -> tuple:
        st = self.engine.stats
        return getattr(st, "n_touched", None), st.n_refreshes

    def _keep(self, report, vals, idx) -> None:
        st = self.engine.state
        factors = tuple(x.to("cpu", copy=True) for x in (st.U, st.P, st.Q))
        self.checked.append({"round": len(self.rounds) - 1, "touched": report.touched_users,
                             "vals": vals, "idx": idx, "factors": factors})

    def run_window(self, seconds: float, trace: bool) -> None:
        tr = self.traffic
        trace_from = None if not trace else tr["trace_after_share"] * seconds
        before = self._counter()
        t_start = time.perf_counter()
        deadline = t_start + seconds
        paused = 0.0
        while True:
            if (trace_from is not None and len(self.checked) >= tr["check_rounds"]
                    and time.perf_counter() - t_start >= trace_from):
                trace_from = None
                with devtrace.capture(self.device) as cap:
                    for _ in range(tr["trace_rounds"]):
                        report, vals, _ = self._round(self._draw(), annotate=True)
                        self._count(report, vals)
                        self._clear_latencies()
                        self.traced.append((len(self.rounds) - 1, report.touched_users))
                self.trace = cap["trace"]
                continue
            events = self._draw()
            t0 = time.perf_counter()
            report, vals, idx = self._round(events)
            t1 = time.perf_counter()
            self.round_ms.append((t1 - t0) * 1e3)
            self._count(report, vals)
            self._clear_latencies()
            if len(self.checked) < tr["check_rounds"]:
                t2 = time.perf_counter()
                self._keep(report, vals, idx)
                pause = time.perf_counter() - t2
                paused += pause
                deadline += pause               # the rounds get ``seconds`` of their own
            done = len(self.checked) >= tr["check_rounds"] and trace_from is None
            if t1 >= deadline and done:
                break
        self.elapsed = t1 - t_start - paused
        after = self._counter()
        if before[0] is not None:
            self.counter = (after[0] - before[0], after[1] - before[1])

    def _count(self, report, vals: np.ndarray) -> None:
        self.n_slates += len(vals)
        self.failed += len(report.touched_users) - len(vals)

    @property
    def attempted(self) -> int:
        return self.n_slates + self.failed

    def end_to_end(self) -> dict:
        return {"slates_per_s": self.n_slates / self.elapsed,
                "refresh_p95_ms": float(np.percentile(self.round_ms, 95))}

    def free(self) -> None:
        del self.engine

    def judge(self) -> dict:
        """The checked rounds against the reference's replay of the
        warm-up and those rounds from the seeded state, on a walk table
        the reference builds again. Per checked round: the factors
        (`factor_readings`), ``stale_slates`` (users whose factors the
        replay changed in the round, all of them senders or receivers,
        left out of the program's refreshed set), and the refreshed slates
        against the slates of the program's own post-round factors
        (`compare.judge_slates`, the seen bits and popularity of the train
        pairs and every round's check-ins so far). Gaps are the widest,
        counts summed over the rounds."""
        cfg, dev = self.config, self.device
        ds = self.ds
        table = ref_dmf.neighbor_table(ds.user_coords, ds.user_city, cfg["graph"], dev)
        self.fanout = (table[1] != 0).sum(1).cpu().numpy()
        initial = served_factors(self.seed, ds.n_users, ds.n_items, cfg["model"]["dim"],
                                 cfg["served_scale"], dev)
        rep = ref_online.replay(*initial, table, dict(cfg["model"]), self.online,
                                engine_seed(self.seed))
        del table
        out = {"factor_gap": 0.0, "untouched_moved": 0.0, "stale_slates": 0.0,
               "score_gap": 0.0, "rank_gap": 0.0, "bad_slates": 0.0}
        kept = {c["round"]: c for c in self.checked}
        last = max(kept, default=-1)
        for r in range(last + 1):
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
        del rep, initial
        return out

    def layer_context(self) -> dict:
        """What the per-layer readers read: the traced rounds (spans of the
        round and of its ingest), each round's update batches (real rows a
        batch, over the steps), senders (each check-in's user, once a row
        over the steps) and refreshed users with their seen entries, the
        reference's walk fan-out, and the engine's touched-user counter
        over the window's rounds (None where the program keeps none)."""
        if self.trace is None or not self.trace.device:
            return {}
        rounds = self.trace.spans("portbench.round")
        if len(rounds) != len(self.traced):
            raise RuntimeError(f"{len(rounds)} round spans in the trace for "
                               f"{len(self.traced)} traced rounds")
        ds, on = self.ds, self.online
        m1 = 1 + on["neg_samples"]
        first = self.traced[0][0]
        seen = np.zeros((ds.n_users, ds.n_items), bool)
        for ev in (ds.train, *self.rounds[:first]):
            seen[ev[:, 0], ev[:, 1]] = True
        batches, senders, touched, seen_touched = [], [], [], []
        for r, users in self.traced:
            ev = self.rounds[r]
            seen[ev[:, 0], ev[:, 1]] = True
            rows = len(ev) * m1
            cap = on["batch_cap"]
            batches.append([min(cap, rows - s) for s in range(0, rows, cap)] * on["steps"])
            senders.append(np.tile(np.repeat(ev[:, 0], m1), on["steps"]))
            touched.append(len(users))
            seen_touched.append(int(seen[users].sum()))
        return {"trace": self.trace, "rounds": rounds,
                "ingests": self.trace.spans("portbench.ingest"),
                "window": (rounds[0][0], rounds[-1][1]), "steps": on["steps"],
                "batches": batches, "senders": senders, "touched": touched,
                "seen_touched": seen_touched, "fanout": self.fanout,
                "touched_counter": self.counter, "n_users": ds.n_users,
                "n_items": ds.n_items, "dim": self.config["model"]["dim"], "k": self.k}
