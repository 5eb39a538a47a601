"""Traffic kind ``train``: training jobs back to back, each
`dmf.fit(cfg, train, nbr, epochs=E)` from the job's own seeded initial
state, in rounds of ``batch_size`` concurrent learner updates, DP off.

Set-up: the data set (the configuration's, from its own seed), the
program's walk neighbour table built once from it, and one warm-up job
(the kernel library is built or loaded there). The window runs jobs until
``seconds`` have passed; the job in flight then completes and counts.

The check follows the window's first job: fit's per-epoch callback reads
each leaf's change norm after the first and after the ``check_epochs``-th
epoch (a few device reductions, in that job only), and its losses come
from its result; the reference replays that job's first epochs.
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


class Bench:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        from repro_torch.core import dmf, graph

        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self._dmf = dmf
        data = dict(config["dataset"])
        self.ds = synthetic_poi.generate({k: v for k, v in data.items() if k != "seed"},
                                         data["seed"])
        m = config["model"]
        self.hp = dict(m)
        self.cfg = dmf.DMFConfig(
            n_users=self.ds.n_users, n_items=self.ds.n_items, dim=m["dim"], alpha=m["alpha"],
            beta=m["beta"], gamma=m["gamma"], lr=m["lr"], neg_samples=m["neg_samples"],
            init_scale=m["init_scale"], batch_size=traffic["batch_size"])
        if self.cfg.dp:
            raise ValueError("the train traffic runs DP off")
        gc = graph.GraphConfig(**config["graph"])
        W = graph.build_adjacency(self.ds.user_coords, self.ds.user_city, gc)
        self.nbr = graph.walk_neighbor_table(W, gc, device=device)
        del W
        self.E = traffic["epochs"]
        B = traffic["batch_size"]
        self.rounds_per_epoch = (len(self.ds.train) * (1 + m["neg_samples"])) // B
        self.events_per_job = self.E * self.rounds_per_epoch * B
        self.jobs = self.failed = 0
        self.elapsed = 0.0
        self.epoch_ms: list[float] = []
        self.profiled_seeds: list[int] = []
        self.trace = None
        self.fanout = None
        self._annotate = False
        self._check = None
        self._marks: list[float] = []
        self._job(sub_seed(seed, "warmup"))        # warm-up: builds or loads the kernels
        self._marks.clear()

    def _on_epoch(self, t, state, loss) -> None:
        self._marks.append(time.perf_counter())
        if self._annotate:
            with record_function("portbench.epoch_end"):
                pass
        chk = self._check
        if chk is not None and t in (0, self.traffic["check_epochs"] - 1):
            chk["norms"].append(ref.change_norms({"U": state.U, "P": state.P, "Q": state.Q},
                                                 chk["U0"]))

    def _job(self, job_seed: int):
        return self._dmf.fit(self.cfg, self.ds.train, self.nbr, epochs=self.E, seed=job_seed,
                             callback=self._on_epoch, device=self.device)

    def _timed_job(self, j: int, annotate: bool = False) -> None:
        """Job ``j`` of the window. Job 0 is the checked one (its epoch
        times are left out of the host-clock tail, as are profiled jobs')."""
        js = sub_seed(self.seed, "jobs", j)
        if j == 0:
            U0, _ = ref.initial_users(js, self.cfg.n_users, self.cfg.dim, self.cfg.init_scale)
            self._check = {"U0": U0, "norms": [], "seed": js}
        self._marks.clear()
        t0 = time.perf_counter()
        span = record_function("portbench.job") if annotate else contextlib.nullcontext()
        with span:
            res = self._job(js)
        ok = np.isfinite(res.train_losses).all() and len(res.train_losses) == self.E
        self.jobs += 1
        self.failed += int(not ok)
        if j == 0:
            self.checked = dict(self._check, losses=list(res.train_losses))
            self._check = None
        elif annotate:
            self.profiled_seeds.append(js)
        else:
            self.epoch_ms.extend(np.diff([t0, *self._marks]) * 1e3)

    def run_window(self, seconds: float, trace: bool) -> None:
        tr = self.traffic
        trace_from = None if not trace else tr["trace_after_share"] * seconds
        t_start = time.perf_counter()
        deadline = t_start + seconds
        j = 0
        while True:
            if trace_from is not None and j > 0 and time.perf_counter() - t_start >= trace_from:
                trace_from = None
                self._annotate = True
                with devtrace.capture(self.device) as cap:
                    for _ in range(tr["trace_jobs"]):
                        self._timed_job(j, annotate=True)
                        j += 1
                self._annotate = False
                self.trace = cap["trace"]
                continue
            self._timed_job(j)
            j += 1
            if time.perf_counter() >= deadline:
                break
        self.elapsed = time.perf_counter() - t_start

    @property
    def attempted(self) -> int:
        return self.jobs

    def end_to_end(self) -> dict:
        return {"train_events_per_s": self.jobs * self.events_per_job / self.elapsed}

    def free(self) -> None:
        del self.nbr

    def judge(self) -> dict:
        """The window's first job against the reference's replay of its
        first epochs, on a walk table the reference builds again."""
        chk = self.checked
        table = ref.neighbor_table(self.ds.user_coords, self.ds.user_city, self.config["graph"],
                                   self.device)
        self.fanout = (table[1] != 0).sum(1).cpu().numpy()
        want = ref.train_job(self.ds.train, table, self.hp, self.ds.n_items, chk["seed"],
                             self.traffic["batch_size"], self.traffic["check_epochs"],
                             device=self.device)
        del table
        prog = {"losses": chk["losses"][: len(want["losses"])], "norms": chk["norms"]}
        want["norms"] = [want["norms"][0], want["norms"][-1]]
        self.reference = want
        return compare.judge_training(prog, want)

    def layer_context(self) -> dict:
        """What the per-layer readers read: the profiled slice, its jobs
        and epochs (spans and the senders of each epoch's events), the
        window's host-clock epoch times."""
        ctx = {"epoch_ms": self.epoch_ms, "dim": self.cfg.dim,
               "batch_size": self.traffic["batch_size"], "rounds_per_epoch": self.rounds_per_epoch}
        if self.trace is None or not self.trace.device:
            return ctx
        jobs = self.trace.spans("portbench.job")
        marks = [s for s, _ in self.trace.spans("portbench.epoch_end")]
        epochs, senders = [], []
        for (s, e), js in zip(jobs, self.profiled_seeds):
            ends = [m for m in marks if s <= m <= e]
            starts = [s, *ends[:-1]]
            epochs.extend(zip(starts, ends))
            senders.extend(ref.epoch_senders(js, self.ds.train, self.cfg.n_users,
                                             self.cfg.n_items, self.cfg.dim,
                                             self.cfg.init_scale, self.cfg.neg_samples,
                                             self.traffic["batch_size"], self.E))
        ctx.update({"trace": self.trace, "jobs": jobs, "epochs": epochs, "senders": senders,
                    "fanout": self.fanout, "window": (jobs[0][0], jobs[-1][1])})
        return ctx
