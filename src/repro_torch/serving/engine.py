"""ServingEngine — microbatched, geo-pruned, online-updatable POI serving.
Port of `src/repro/serving/engine.py:55-157, 193-590` for one device:
`ServingConfig`, `EngineStats` (with `publish`), `_dispatch_pruned`,
`_dispatch_dense`, `_dispatch_rows` and `ServingEngine` (`recommend`,
`serve_stream`, `serve_microbatch`, `ingest`, the popularity fallback),
with the reference's trace spans ``engine.dispatch``,
``engine.serve_microbatch`` and ``engine.ingest``. Sharded serving
(`serve_wave`, the SPMD dispatch, its ``engine.serve_wave`` span) is not
ported yet.

Request path:

1. **Microbatcher** — a stream of user ids is grouped into fixed-shape
   batches of ``ServingConfig.microbatch`` (the tail batch is padded with a
   repeated real id, its results dropped).
2. **Dispatch** — the ids' upload and one launch of the serve kernel
   (`ops.serve_topk_rows`), which reads each request's user row, its
   home-city candidate ids, their seen bits and their rows of the
   device-resident V = P + Q view in place: no (R, cap, K) gather.
   ``prune=False`` instead has the dense kernel
   (`ops.recommend_topk_peruser`) read the requests' full rows of V and of
   the seen mask where they lie (``rows=uids``): no (R, J, K) gather.
3. **Online refresh** — `ingest` streams new check-ins through
   `serving/online.py` (the Eq. 9-11 step, `ops.dmf_fused_step`; with DP
   on, also the mechanism kernel `ops.dp_clip_noise`), then
   patches the touched rows of V and the new check-ins' seen bits.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Iterator

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import dmf
from repro_torch.core import graph as graph_lib
from repro_torch.core import metrics as metrics_lib
from repro_torch.kernels import ops
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as trace_lib
from repro_torch.serving import online as online_lib
from repro_torch.serving.candidates import CandidateIndex


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    microbatch: int = 64     # R — fixed dispatch shape (requests padded to it)
    k: int = 10              # recommendations per request
    prune: bool = True       # geo-pruned candidate path vs dense full-J
    fallback: bool = True    # unknown/cold users and empty candidate buckets
                             # get a (flagged) popularity slate


@dataclasses.dataclass
class EngineStats:
    n_requests: int = 0
    n_dispatches: int = 0
    n_refreshes: int = 0
    n_events: int = 0
    n_fallbacks: int = 0
    dispatch_seconds: list[float] = dataclasses.field(default_factory=list)
    # per-request arrival→completion: a request riding the w-th dispatch of
    # a drain pays for every dispatch before it
    request_seconds: list[float] = dataclasses.field(default_factory=list)

    def reset(self) -> None:
        """Zero all counters/latencies (e.g. after warm-up dispatches)."""
        self.__dict__.update(dataclasses.asdict(EngineStats()))

    def latency_percentiles(self, qs=(50, 95, 99)) -> dict[str, float]:
        """Request-level (arrival→completion) latency percentiles."""
        return obs_metrics.latency_percentiles(self.request_seconds, qs)

    def dispatch_latency_percentiles(self, qs=(50, 95, 99)) -> dict[str, float]:
        """Per-dispatch wall-time percentiles (not per request)."""
        return obs_metrics.latency_percentiles(self.dispatch_seconds, qs)

    def publish(self, registry=None, prefix: str = "serving") -> None:
        """Mirror the counters and latency streams into a metrics registry
        (the global one by default). Counters export as gauges and the
        latency streams replace their histograms' series: this object is
        the source of truth and may be `reset()`."""
        reg = registry if registry is not None else obs_metrics.get_registry()
        for f in ("n_requests", "n_dispatches", "n_refreshes", "n_events", "n_fallbacks"):
            reg.gauge(f"{prefix}_{f}").set(getattr(self, f))
        for nm in ("dispatch_seconds", "request_seconds"):
            h = reg.histogram(f"{prefix}_{nm}")
            h.reset()
            h.observe_many(getattr(self, nm))


def _dispatch_pruned(U, V, seen, bucket_items, user_bucket, uids, k: int):
    """One geo-pruned microbatch: the serve kernel reads the requests' user
    rows, candidate ids, seen bits and candidate rows of V in place."""
    return ops.serve_topk_rows(uids, U, V, seen, user_bucket, bucket_items, k)


def _dispatch_dense(U, V, seen, uids, k: int):
    """Dense microbatch: full-J top-k over the requests' item rows and seen
    rows, which the kernel reads in place (rows ``uids`` of V and seen)."""
    return ops.recommend_topk_peruser(U[uids], V, seen, k, rows=uids)


def _dispatch_rows(U, P, Q, seen, bucket_items, user_bucket, uids, k: int, prune: bool):
    """Microbatch over the raw factor state, forming v = p + q of the
    requested rows on the fly: both kernels read the P, Q and seen rows in
    place and add in registers (the pruned one rounds each sum as the
    gather-then-add did, so it equals serving V)."""
    if prune:
        return ops.serve_topk_rows(uids, U, P, seen, user_bucket, bucket_items, k, Q=Q)
    return ops.recommend_topk_peruser(U[uids], P, seen, k, Q=Q, rows=uids)


class ServingEngine:
    """Batched POI recommendation over a trained `DMFState`, on one device.

    ``nbr`` + ``dmf_cfg`` are only required for `ingest` (online refresh).
    The engine copies the caller's state once at construction onto
    ``device`` (default ``"cuda"``, raising without a card): `ingest`
    updates its copy in place and leaves the caller's state alone.
    """

    def __init__(
        self,
        state: dmf.DMFState,
        index: CandidateIndex,
        cfg: ServingConfig = ServingConfig(),
        *,
        train: np.ndarray | None = None,
        seen: np.ndarray | None = None,
        nbr: graph_lib.NeighborTable | None = None,
        dmf_cfg: dmf.DMFConfig | None = None,
        device="cuda",
    ):
        self.device = device_lib.resolve(device)
        self.state = dmf.DMFState(
            *(x.to(self.device, copy=True) for x in (state.U, state.P, state.Q)))
        self.index = index
        self.cfg = cfg
        self.nbr = None if nbr is None else graph_lib.NeighborTable(
            nbr.idx.to(self.device), nbr.wgt.to(self.device))
        self.dmf_cfg = dmf_cfg
        I, J = state.P.shape[0], state.P.shape[1]
        assert index.n_items == J, (index.n_items, J)
        if seen is None:
            assert train is not None, "need `train` pairs or a `seen` mask"
            seen = metrics_lib.masks_from_interactions(I, J, train)
        seen_np = np.asarray(seen).astype(bool)
        self.seen = torch.as_tensor(seen_np.astype(np.int8), device=self.device)
        self._bucket_items = torch.as_tensor(index.bucket_items, device=self.device)
        self._user_bucket = torch.as_tensor(index.user_bucket, dtype=torch.int64,
                                            device=self.device)
        # graceful-degradation state (host-side): unknown ids, cold users
        # (no interactions) and empty home buckets get the popularity slate
        self._n_users = I
        self._cold = ~seen_np.any(axis=1)
        self._item_counts = seen_np.sum(axis=0).astype(np.int64)
        self._user_bucket_np = np.asarray(index.user_bucket)
        self._bucket_empty = (np.asarray(index.bucket_items) < 0).all(axis=1)
        self._refresh_popularity()
        self.V = self.state.P + self.state.Q      # served per-learner view
        # persistent stream: successive ingest() calls draw fresh negatives
        self._rng = np.random.default_rng(dmf_cfg.seed if dmf_cfg is not None else 0)
        self.stats = EngineStats()

    # -------------------------------------------------------------- fallback
    def _refresh_popularity(self) -> None:
        """Top-k items by check-in count, values = count / max count (a
        [0, 1] pseudo-score, deliberately not on the factor-score scale)."""
        top = np.argsort(-self._item_counts, kind="stable")
        self._pop_items = top[: self.cfg.k].astype(np.int32)
        peak = max(int(self._item_counts.max()), 1)
        self._pop_vals = (self._item_counts[self._pop_items] / peak).astype(np.float32)

    def _fallback_mask(self, user_ids: np.ndarray) -> np.ndarray:
        """True where the factor path cannot give a meaningful slate."""
        uids = np.asarray(user_ids)
        unknown = (uids < 0) | (uids >= self._n_users)
        safe = np.clip(uids, 0, self._n_users - 1)
        flags = unknown | self._cold[safe]
        if self.cfg.prune:
            flags = flags | self._bucket_empty[self._user_bucket_np[safe]]
        return flags

    # ------------------------------------------------------------------ serve
    def _microbatches(
        self, user_ids: Iterable[int], t_arrival: float | None = None
    ) -> Iterator[tuple[np.ndarray, int, np.ndarray]]:
        """Fixed-shape request batches: (padded ids (R,), n_real, arrival
        stamps (n_real,)). ``t_arrival`` overrides the pull-time stamps."""
        R = self.cfg.microbatch
        buf = np.zeros(R, np.int64)
        arr = np.zeros(R, np.float64)
        n = 0
        for uid in user_ids:
            buf[n] = uid
            arr[n] = time.perf_counter() if t_arrival is None else t_arrival
            n += 1
            if n == R:
                yield buf.copy(), n, arr[:n].copy()
                n = 0
        if n:
            buf[n:] = buf[0]       # pad with a real user id (results dropped)
            yield buf.copy(), n, arr[:n].copy()

    def serve_stream(
        self, user_ids: Iterable[int], _t_arrival: float | None = None,
    ) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Drain a request stream in arrival order; yields (user_ids, vals,
        idx) per microbatch, one dispatch each, padding sliced off."""
        for buf, n, arr in self._microbatches(user_ids, _t_arrival):
            t0 = time.perf_counter()
            with trace_lib.span("engine.dispatch", n_real=n, prune=self.cfg.prune):
                uids = torch.as_tensor(buf, device=self.device)
                if self.cfg.prune:
                    vals, idx = _dispatch_pruned(
                        self.state.U, self.V, self.seen, self._bucket_items,
                        self._user_bucket, uids, self.cfg.k)
                else:
                    vals, idx = _dispatch_dense(self.state.U, self.V, self.seen, uids,
                                                self.cfg.k)
                vals, idx = vals.cpu().numpy(), idx.cpu().numpy()   # waits for the card
            t1 = time.perf_counter()
            self.stats.dispatch_seconds.append(t1 - t0)
            self.stats.n_dispatches += 1
            self.stats.n_requests += n
            self.stats.request_seconds.extend((t1 - arr).tolist())
            yield buf[:n], vals[:n], idx[:n]

    def serve_microbatch(self, user_ids, return_flags: bool = False):
        """Serve ≤ `microbatch` requests in one dispatch over the raw factor
        state. Returns ``(vals (n, k), idx (n, k), service_seconds)``, with
        the per-request fallback flags before the seconds if
        ``return_flags``."""
        user_ids = np.asarray(user_ids)
        n, R, k = len(user_ids), self.cfg.microbatch, self.cfg.k
        assert n <= R, f"serve_microbatch takes ≤ microbatch ids ({n} > {R})"
        if n == 0:
            out = (np.empty((0, k), np.float32), np.empty((0, k), np.int32))
            return out + ((np.empty(0, bool),) if return_flags else ()) + (0.0,)
        flags = self._fallback_mask(user_ids) if self.cfg.fallback else np.zeros(n, bool)
        buf = np.zeros(R, np.int64)
        buf[:n] = np.where(flags, 0, user_ids)
        buf[n:] = buf[0]           # pad with a real user id (results dropped)
        t0 = time.perf_counter()
        with trace_lib.span("engine.serve_microbatch", n_real=n):
            vals, idx = _dispatch_rows(
                self.state.U, self.state.P, self.state.Q, self.seen, self._bucket_items,
                self._user_bucket, torch.as_tensor(buf, device=self.device), k, self.cfg.prune)
            vals, idx = vals.cpu().numpy()[:n], idx.cpu().numpy()[:n]   # waits for the card
        dt = time.perf_counter() - t0
        self.stats.dispatch_seconds.append(dt)
        self.stats.request_seconds.extend([dt] * n)
        self.stats.n_dispatches += 1
        self.stats.n_requests += n
        if flags.any():
            vals[flags] = self._pop_vals
            idx[flags] = self._pop_items
            self.stats.n_fallbacks += int(flags.sum())
        if return_flags:
            return vals, idx, flags, dt
        return vals, idx, dt

    def recommend(self, user_ids, return_flags: bool = False):
        """Serve a whole batch of user ids, results aligned to the input
        order. With ``cfg.fallback`` (the default), unknown ids, cold users
        and empty buckets get the popularity slate: their ids are clamped
        to row 0 before dispatch and the rows overwritten.
        ``return_flags=True`` appends the per-request fallback mask."""
        user_ids = np.asarray(user_ids)
        k = self.cfg.k
        if len(user_ids) == 0:
            out = (np.empty((0, k), np.float32), np.empty((0, k), np.int32))
            return out + (np.empty(0, bool),) if return_flags else out
        flags = (self._fallback_mask(user_ids) if self.cfg.fallback
                 else np.zeros(len(user_ids), bool))
        safe_ids = np.where(flags, 0, user_ids)
        vals, idx = [], []
        t_call = time.perf_counter()
        for _, v, i in self.serve_stream((int(u) for u in safe_ids), _t_arrival=t_call):
            vals.append(v)
            idx.append(i)
        vals, idx = np.concatenate(vals), np.concatenate(idx)
        if flags.any():
            vals[flags] = self._pop_vals
            idx[flags] = self._pop_items
            self.stats.n_fallbacks += int(flags.sum())
        if return_flags:
            return vals, idx, flags
        return vals, idx

    @property
    def requests_per_sec(self) -> float:
        s = sum(self.stats.dispatch_seconds)
        return self.stats.n_requests / s if s > 0 else float("nan")

    # ----------------------------------------------------------------- ingest
    def ingest(
        self,
        events: np.ndarray,
        ocfg: online_lib.OnlineConfig = online_lib.OnlineConfig(),
        rng: np.random.Generator | None = None,
    ) -> online_lib.RefreshReport:
        """Stream new check-ins through the online refresh (U/P/Q in place),
        then patch V = P + Q on the touched rows and the seen-filter on the
        new check-ins."""
        assert self.nbr is not None and self.dmf_cfg is not None, (
            "engine built without nbr/dmf_cfg — online refresh unavailable")
        events = np.asarray(events)
        with trace_lib.span("engine.ingest", n_events=len(events)):
            self.state, report = online_lib.online_refresh(
                self.state, self.nbr, events, self.dmf_cfg, ocfg,
                rng if rng is not None else self._rng)
        if len(report.touched_users):
            t = torch.as_tensor(report.touched_users, device=self.device)
            self.V[t] = self.state.P[t] + self.state.Q[t]
        if len(events):
            ev = torch.as_tensor(events.astype(np.int64), device=self.device)
            self.seen[ev[:, 0], ev[:, 1]] = 1
            # a user with a first check-in stops being cold; popularity
            # tracks the stream
            np.add.at(self._item_counts, events[:, 1].astype(np.int64), 1)
            self._cold[events[:, 0].astype(np.int64)] = False
            self._refresh_popularity()
        self.stats.n_refreshes += 1
        self.stats.n_events += int(len(events))
        return report
