"""ServingEngine — microbatched, geo-pruned, online-updatable POI serving.
Port of `src/repro/serving/engine.py`: `ServingConfig`, `EngineStats`
(with `publish`), `_dispatch_pruned`, `_dispatch_dense`, `_dispatch_rows`
and `ServingEngine` (`recommend`, `serve_stream`, `serve_microbatch`,
`ingest`, the popularity fallback; learner-sharded serving, `serve_wave`
:322-341, `_sharded_dispatches` :343-374, `_serve_sharded` :376-386,
`serve_stream(ordered=)` :388-433), with the reference's trace spans
``engine.dispatch``, ``engine.serve_microbatch``, ``engine.serve_wave``
and ``engine.ingest``.

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

Learner-sharded serving (``n_shards = D > 1``): the reference runs one
SPMD program over a ``learners`` mesh; here a shard is one rank of a
`torch.distributed` group of D processes (`sharding.dmf.learner_group`,
started by `launch.mesh.spawn_ranks` or torchrun), and the engine raises
outside such a group; a caller may pass its own group (``group=``, whose
clock, if it has one, times every collective between two device
synchronisations). Every rank is built from the same host inputs and
routes with the same host numpy (user u lives on rank ``u // rows``,
``rows = ceil(I / D)``). Each rank keeps the unsharded U, P, Q and seen,
which `ingest` and `serve_microbatch` read, and its own zero-padded rows
of U, V = P + Q, seen and the users' buckets, which it serves: the
sharded V replaces the full one. A wave (`serve_wave`) is one kernel
launch on each rank's own rows, one `all_gather` each of the values and
ids and one `all_reduce` (MAX) of the ranks' wall seconds, since a
lockstep wave ends with its slowest shard; only results and agreed times
cross ranks. `ingest` runs the same refresh on every rank's replicated
state from the same generator, so the states stay equal bit for bit, and
patches the rank's own rows; nothing crosses ranks. `serve_microbatch`,
the scheduler's per-shard dispatch, is a collective at D ranks: the
requests' home rank serves them from its own rows and broadcasts the
slates and its measured seconds in one reused packet, so every rank's
virtual clock moves by the same numbers.
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
from repro_torch.sharding import dmf as sharded_dmf


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    microbatch: int = 64     # R — fixed dispatch shape (requests padded to it)
    k: int = 10              # recommendations per request
    prune: bool = True       # geo-pruned candidate path vs dense full-J
    n_shards: int = 1        # learner-group width: >1 serves row-sharded
                             # U/V/seen, one rank a shard, `microbatch`
                             # requests per shard a wave
    fallback: bool = True    # unknown/cold users and empty candidate buckets
                             # get a (flagged) popularity slate

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError(f"n_shards={self.n_shards} (at least 1)")


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
    """Batched POI recommendation over a trained `DMFState`.

    ``nbr`` + ``dmf_cfg`` are only required for `ingest` (online refresh).
    The engine copies the caller's state once at construction onto
    ``device`` (default ``"cuda"``, raising without a card): `ingest`
    updates its copy in place and leaves the caller's state alone. With
    ``cfg.n_shards > 1``, or given a ``group`` of ``cfg.n_shards`` ranks,
    it is one rank's engine of that learner group (see the module's
    docstring): every rank builds it from the same inputs and calls the
    same methods in the same order.
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
        group: sharded_dmf.LearnerGroup | None = None,
        device="cuda",
    ):
        self.device = device_lib.resolve(device)
        # sharded on the caller's group, or at D > 1 on this rank's group
        # (which raises outside a group of D ranks); unsharded without one
        if group is None and cfg.n_shards > 1:
            group = sharded_dmf.learner_group(cfg.n_shards, self.device)
        if group is not None and (group.size, group.device) != (cfg.n_shards, self.device):
            raise ValueError(f"n_shards={cfg.n_shards} on {self.device}, but the group has "
                             f"{group.size} ranks on {group.device}")
        self.group = group
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
        self._rows = I                 # rows a shard: user u lives on shard u // _rows
        if group is None:
            self.V = self.state.P + self.state.Q      # served per-learner view
        else:
            self._shard()
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

    # ---------------------------------------------------------------- sharding
    def _shard(self) -> None:
        """Serve row-sharded over ``self.group``: take this rank's
        zero-padded rows of U, V = P + Q, seen and the users' buckets (ref
        :242-264); the sharded V replaces the full one."""
        group = self.group
        self._rows = sharded_dmf.rows_per_shard(self._n_users, group.size)
        self._row0 = group.rank * self._rows

        def mine(x):
            return sharded_dmf.group_rows(x, group, self._rows)
        self.V = None
        self._U_loc = mine(self.state.U)
        self._V_loc = mine(self.state.P).add_(mine(self.state.Q))  # the bits of P + Q
        self._seen_loc = mine(self.seen)
        self._ub_loc = mine(self._user_bucket)
        # serve_microbatch's broadcast, built once: its seconds (f64), then
        # the slates' values (R, k) f32 and ids (R, k) i32. Under gloo the
        # packet is a host tensor, so it never goes through the card
        R, k = self.cfg.microbatch, self.cfg.k
        self._packet_np = np.zeros(8 + 8 * R * k, np.uint8)
        self._packet = torch.from_numpy(self._packet_np)
        if group.backend != "gloo":
            self._packet = self._packet.to(self.device)
        self._pk_dt = self._packet_np[:8].view(np.float64)
        self._pk_vals = self._packet_np[8:8 + 4 * R * k].view(np.float32).reshape(R, k)
        self._pk_idx = self._packet_np[8 + 4 * R * k:].view(np.int32).reshape(R, k)
        self.broadcast_seconds: list[float] = []   # serve_microbatch's broadcasts, wall

    @property
    def exchange(self) -> sharded_dmf.ExchangeClock | None:
        """The wall seconds and count of this rank's collectives, where
        the group has a clock (None otherwise, and on one device); each is
        timed between two device synchronisations."""
        return self.group.clock if self.group is not None else None

    def agreed_seconds(self, seconds: float) -> float:
        """The largest of every rank's ``seconds`` (one `all_reduce` MAX):
        one number all ranks agree on; ``seconds`` itself on one device."""
        if self.group is None:
            return seconds
        t = torch.tensor([seconds], dtype=torch.float64, device=self.device)
        return float(self.group.all_reduce(t, op="max").item())

    def _serve_local(self, local_ids: np.ndarray):
        """One dispatch on this rank's own rows: kernel 5 in place
        (pruned) or kernel 2 on the rows where they lie (dense), for
        local row ids (R,)."""
        uids = torch.as_tensor(np.asarray(local_ids, np.int64), device=self.device)
        if self.cfg.prune:
            return _dispatch_pruned(self._U_loc, self._V_loc, self._seen_loc,
                                    self._bucket_items, self._ub_loc, uids, self.cfg.k)
        return _dispatch_dense(self._U_loc, self._V_loc, self._seen_loc, uids, self.cfg.k)

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

    # ------------------------------------------------------------ sharded serve
    def serve_wave(self, uids_local: np.ndarray) -> tuple[np.ndarray, np.ndarray, float]:
        """One lockstep wave over the group: ``uids_local`` is the host
        (D, microbatch) array of shard-local row ids, the same on every
        rank (pad unused slots with 0; callers drop those results). Rank r
        serves row r on its own rows, whether its queue was full or empty;
        returns (vals (D, R, k), idx (D, R, k), seconds) on every rank, the
        seconds being the slowest rank's wall time of the wave."""
        g = self.group
        D, R, k = g.size, self.cfg.microbatch, self.cfg.k
        uids_local = np.asarray(uids_local)
        if uids_local.shape != (D, R):
            raise ValueError(f"serve_wave: uids_local of shape {uids_local.shape}, "
                             f"want {(D, R)}")
        t0 = time.perf_counter()
        with trace_lib.span("engine.serve_wave", shards=D, microbatch=R):
            vals, idx = self._serve_local(uids_local[g.rank])
            vals, idx = g.all_gather(vals), g.all_gather(idx)
            vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
            dt = self.agreed_seconds(time.perf_counter() - t0)
        self.stats.dispatch_seconds.append(dt)
        self.stats.n_dispatches += 1
        return vals.reshape(D, R, k), idx.reshape(D, R, k), dt

    def _sharded_dispatches(
        self, user_ids: np.ndarray
    ) -> Iterator[tuple[list[np.ndarray], np.ndarray, np.ndarray]]:
        """Route requests to their user's home shard and drain the shard
        queues in waves: each wave takes up to `microbatch` requests from
        every queue at once (ids rebased to shard-local rows, padding =
        local row 0, results dropped). Yields (positions a shard, vals
        (D, R, k), idx (D, R, k)). A request served by the w-th wave is
        charged the wall time of waves 1..w: every request of the drain
        arrived when it started."""
        D, R = self.group.size, self.cfg.microbatch
        shard = user_ids // self._rows
        queues = [np.nonzero(shard == d)[0] for d in range(D)]
        offs = [0] * D
        t_arrival = time.perf_counter()
        while any(o < len(q) for o, q in zip(offs, queues)):
            uids_l = np.zeros((D, R), np.int64)
            sel = []
            for d in range(D):
                take = queues[d][offs[d]: offs[d] + R]
                offs[d] += len(take)
                uids_l[d, : len(take)] = user_ids[take] % self._rows
                sel.append(take)
            vals, idx, _ = self.serve_wave(uids_l)
            n_real = int(sum(len(t) for t in sel))
            self.stats.n_requests += n_real
            self.stats.request_seconds.extend([time.perf_counter() - t_arrival] * n_real)
            yield sel, vals, idx

    def _serve_sharded(self, user_ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Serve a whole batch in waves, results in the caller's order."""
        parts = list(self._stream_sharded(user_ids, ordered=True))
        return (np.concatenate([v for _, v, _ in parts]),
                np.concatenate([i for _, _, i in parts]))

    def _stream_sharded(self, user_ids: Iterable[int], ordered: bool):
        """`serve_stream` at D ranks: the stream is drained up front and
        served in waves; see `serve_stream`."""
        ids = np.asarray(list(user_ids), np.int64)
        if not ordered:
            for sel, vals, idx in self._sharded_dispatches(ids):
                live = [d for d, t in enumerate(sel) if len(t)]
                yield (ids[np.concatenate([sel[d] for d in live])],
                       np.concatenate([vals[d, : len(sel[d])] for d in live]),
                       np.concatenate([idx[d, : len(sel[d])] for d in live]))
            return
        n_total, k = len(ids), self.cfg.k
        out_v = np.zeros((n_total, k), np.float32)
        out_i = np.full((n_total, k), -1, np.int32)
        done = np.zeros(n_total, bool)
        emitted = 0
        for sel, vals, idx in self._sharded_dispatches(ids):
            for d, take in enumerate(sel):
                if len(take):
                    out_v[take] = vals[d, : len(take)]
                    out_i[take] = idx[d, : len(take)]
                    done[take] = True
            stop = emitted
            while stop < n_total and done[stop]:
                stop += 1
            if stop > emitted:
                yield ids[emitted:stop], out_v[emitted:stop], out_i[emitted:stop]
                emitted = stop
        assert emitted == n_total, "sharded drain left requests unserved"

    def serve_stream(
        self, user_ids: Iterable[int], ordered: bool = False,
        _t_arrival: float | None = None,
    ) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Drain a request stream; yields (user_ids, vals, idx) per
        microbatch, one dispatch each, padding sliced off.

        Sharded (``n_shards > 1``), the stream is drained up front, requests
        route to their home shard and each yield is one wave of up to
        `microbatch` requests a shard, in the shard queues' order;
        ``ordered=True`` reassembles the results by arrival and yields the
        longest arrival-contiguous prefix after each wave (the same waves,
        results buffered). On one device the order is always arrival's."""
        if self.group is not None:
            yield from self._stream_sharded(user_ids, ordered)
            return
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
        ``return_flags``.

        Sharded, it is a collective that every rank calls with the same
        ids, all users of one shard (``user // _rows`` once clamped to the
        known ids, as the scheduler routes): their home rank serves them
        from its own rows, bit for bit what one device gives, and
        broadcasts the slates and its wall seconds, so every rank returns
        the same. The broadcast's own wall time goes to
        ``broadcast_seconds``, not to the service seconds."""
        user_ids = np.asarray(user_ids)
        n, R, k = len(user_ids), self.cfg.microbatch, self.cfg.k
        assert n <= R, f"serve_microbatch takes ≤ microbatch ids ({n} > {R})"
        if n == 0:
            out = (np.empty((0, k), np.float32), np.empty((0, k), np.int32))
            return out + ((np.empty(0, bool),) if return_flags else ()) + (0.0,)
        flags = self._fallback_mask(user_ids) if self.cfg.fallback else np.zeros(n, bool)
        if self.group is None:
            buf = np.zeros(R, np.int64)
            buf[:n] = np.where(flags, 0, user_ids)
            buf[n:] = buf[0]       # pad with a real user id (results dropped)
            t0 = time.perf_counter()
            with trace_lib.span("engine.serve_microbatch", n_real=n):
                vals, idx = _dispatch_rows(
                    self.state.U, self.state.P, self.state.Q, self.seen, self._bucket_items,
                    self._user_bucket, torch.as_tensor(buf, device=self.device), k,
                    self.cfg.prune)
                vals, idx = vals.cpu().numpy()[:n], idx.cpu().numpy()[:n]  # waits for the card
            dt = time.perf_counter() - t0
        else:
            vals, idx, dt = self._serve_home(user_ids, flags)
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

    def _serve_home(self, user_ids: np.ndarray, flags: np.ndarray):
        """`serve_microbatch`'s dispatch at D ranks: the home rank serves
        the requests from its own rows (flagged ones at local row 0) and
        broadcasts the engine's one packet; returns every rank's copy of
        (vals (n, k), idx (n, k), the home rank's seconds)."""
        g, n, R = self.group, len(user_ids), self.cfg.microbatch
        home = np.unique(np.clip(user_ids, 0, self._n_users - 1) // self._rows)
        if len(home) != 1:
            raise ValueError(f"serve_microbatch at {g.size} shards takes one shard's users, "
                             f"not shards {home.tolist()}")
        shard = int(home[0])
        buf = np.zeros(R, np.int64)
        buf[:n] = np.where(flags, 0, user_ids.astype(np.int64) - shard * self._rows)
        buf[n:] = buf[0]           # pad with a real row (results dropped)
        if ((buf < 0) | (buf >= self._rows)).any():
            raise ValueError(f"serve_microbatch: a user id outside [0, {self._n_users})")
        with trace_lib.span("engine.serve_microbatch", n_real=n, shard=shard):
            if g.rank == shard:
                t0 = time.perf_counter()
                vals, idx = self._serve_local(buf)
                self._pk_vals[:] = vals.cpu().numpy()       # waits for the card
                self._pk_idx[:] = idx.cpu().numpy()
                self._pk_dt[0] = time.perf_counter() - t0
                if self._packet.device.type != "cpu":
                    self._packet.copy_(torch.from_numpy(self._packet_np))
            t1 = time.perf_counter()
            g.broadcast(self._packet, shard)
            if self._packet.device.type != "cpu":
                torch.from_numpy(self._packet_np).copy_(self._packet)
            self.broadcast_seconds.append(time.perf_counter() - t1)
        return self._pk_vals[:n].copy(), self._pk_idx[:n].copy(), float(self._pk_dt[0])

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
        if self.group is not None:     # clamped first: an unknown id routes to no shard
            vals, idx = self._serve_sharded(safe_ids.astype(np.int64))
        else:
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
        new check-ins. Sharded, every rank refreshes its replicated state
        alike (the same events, the same generator) and patches its own
        rows; nothing crosses ranks."""
        assert self.nbr is not None and self.dmf_cfg is not None, (
            "engine built without nbr/dmf_cfg — online refresh unavailable")
        events = np.asarray(events)
        with trace_lib.span("engine.ingest", n_events=len(events)):
            self.state, report = online_lib.online_refresh(
                self.state, self.nbr, events, self.dmf_cfg, ocfg,
                rng if rng is not None else self._rng)
        if self.group is not None:
            self._patch_rows(report, events)
        elif len(report.touched_users):
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

    def _patch_rows(self, report: online_lib.RefreshReport, events: np.ndarray) -> None:
        """Patch this rank's own rows of the served views after a refresh
        of the replicated state (ref :573-583): V on the touched users, U
        on the affected ones, seen on the new check-ins."""
        lo, hi = self._row0, self._row0 + self._rows

        def mine(users):
            users = np.asarray(users, np.int64)
            return users[(users >= lo) & (users < hi)]
        t = torch.as_tensor(mine(report.touched_users), device=self.device)
        if len(t):
            self._V_loc[t - lo] = self.state.P[t] + self.state.Q[t]
        a = torch.as_tensor(mine(report.affected_users), device=self.device)
        if len(a):
            self._U_loc[a - lo] = self.state.U[a]
        if len(events):
            ev = events.astype(np.int64)
            ev = ev[(ev[:, 0] >= lo) & (ev[:, 0] < hi)]
            if len(ev):
                ev = torch.as_tensor(ev, device=self.device)
                self._seen_loc[ev[:, 0] - lo, ev[:, 1]] = 1
