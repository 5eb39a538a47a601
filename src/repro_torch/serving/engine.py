"""ServingEngine — microbatched, geo-pruned, online-updatable POI serving.
Port of `src/repro/serving/engine.py`: `ServingConfig`, `EngineStats`
(with `publish`), `_dispatch_rows` (the reference's two dispatch helpers
in one) and `ServingEngine` (`recommend`, `serve_stream`,
`serve_microbatch`, `ingest`, the popularity fallback; learner-sharded
serving, `serve_wave` :322-341, `_sharded_dispatches` :343-374,
`_serve_sharded` :376-386, `serve_stream(ordered=)` :388-433), with the
reference's trace spans ``engine.dispatch``, ``engine.serve_microbatch``,
``engine.serve_wave`` and ``engine.ingest``, and the phases of a
`serve_microbatch` dispatch inside its span (``engine.prepare``,
``.upload``, ``.launch``, ``.readback``, ``.finish``; sharded
``.serve_home``) and of an ingest inside its own (the online refresh's
``online.*`` spans, then ``engine.patch``).

Request path:

1. **Microbatcher** — a stream of user ids is grouped into fixed-shape
   batches of ``ServingConfig.microbatch`` (the tail batch is padded with a
   repeated real id, its results dropped).
2. **Dispatch** — the ids' upload and one launch of the serve kernel
   (`ops.serve_topk_rows`), which reads each request's user row, its
   home-city candidate ids, their seen bits and their rows of P and Q in
   place, adding p + q in registers: no (R, cap, K) gather.
   ``prune=False`` instead has the dense kernel
   (`ops.recommend_topk_peruser`) read the requests' full rows of P, Q and
   the seen mask where they lie (``rows=uids``): no (R, J, K) gather.
   On one device every microbatch, `serve_microbatch`'s and
   `serve_stream`'s (so `recommend`'s), goes through one dispatch plan
   (`_DispatchPlan`, which the tiled store's engine shares): on a card a
   captured CUDA graph, pinned ids in, one replay, one pinned packet of
   slates back; on the CPU the kernels' plain versions, called directly.
3. **Online refresh** — `ingest` streams new check-ins through
   `serving/online.py` (the Eq. 9-11 step, `ops.dmf_fused_step`; with DP
   on, also the mechanism kernel `ops.dp_clip_noise`), which updates U, P
   and Q in place, then sets the new check-ins' seen bits. With DP off
   the batches go through the engine's update plan (`online.UpdatePlan`):
   on a card one pinned upload a step, one CUDA graph replay a batch and
   the losses read once an ingest; on the CPU the update called directly.

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
of U, V = P + Q, seen and the users' buckets, which it serves. A wave
(`serve_wave`) is one kernel launch on each rank's own rows, one
`all_gather` each of the values and ids and one `all_reduce` (MAX) of the
ranks' wall seconds, since a lockstep wave ends with its slowest shard;
only results and agreed times cross ranks. `ingest` runs the same refresh
on every rank's replicated state from the same generator, so the states
stay equal bit for bit, and patches the rank's own rows; nothing crosses
ranks. `serve_microbatch`, the scheduler's per-shard dispatch, is a
collective at D ranks: the requests' home rank serves them from its own
rows and broadcasts the slates and its measured seconds in one reused
packet, so every rank's virtual clock moves by the same numbers.
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
    n_touched: int = 0       # Σ touched users (affected ∪ receivers) over ingests
    n_released: int = 0      # Σ real messages released under the DP mechanism over ingests
    n_fallbacks: int = 0
    n_captures: int = 0      # the dispatch plan captured (one device, a card)
    n_update_captures: int = 0   # the ingest's update plan captured (a card, DP off)
    dispatch_seconds: list[float] = dataclasses.field(default_factory=list)
    # per-request arrival→completion of `serve_stream` / `recommend`: a
    # request riding the w-th dispatch of a drain pays for every dispatch
    # before it (`serve_microbatch` has its dispatch's seconds alone)
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


def _popularity(item_counts: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """The popularity slate: the top-k items by check-in count (stable:
    ties to the lower id) and their values, count / max count (a [0, 1]
    pseudo-score, deliberately not on the factor-score scale)."""
    items = np.argsort(-item_counts, kind="stable")[:k].astype(np.int32)
    peak = max(int(item_counts.max()), 1)
    return items, (item_counts[items] / peak).astype(np.float32)


def _overwrite(vals: np.ndarray, idx: np.ndarray, fallen, items, values) -> None:
    """Rows ``fallen`` (a mask or row numbers) of the slates (vals, idx)
    become the popularity slate (``items``, ``values``)."""
    vals[fallen] = values
    idx[fallen] = items


def _dispatch_rows(U, P, Q, seen, bucket_items, user_bucket, uids, k: int, prune: bool):
    """One microbatch over the requests' rows where they lie: kernel 5
    (pruned) reads each request's user row, candidate ids, seen bits and
    candidate item rows in place, kernel 2 (dense) their full item and
    seen rows. The item rows are P's where ``Q`` is None (P then holds V =
    P + Q), else p + q formed in registers with one fp32 add, the bits of
    serving V (the pruned kernel rounds each sum as the gather-then-add
    did)."""
    if prune:
        return ops.serve_topk_rows(uids, U, P, seen, user_bucket, bucket_items, k, Q=Q)
    return ops.recommend_topk_peruser(U[uids], P, seen, k, Q=Q, rows=uids)


class _DispatchPlan:
    """One device's dispatch of R ids, the path of every one-device
    microbatch (`ServingEngine.serve_microbatch`'s and `serve_stream`'s,
    `TiledServingEngine.recommend`'s in `serving/store.py`): the caller
    writes the ids into `ids_np`, then calls `upload`, `launch` and `wait`.

    On a card (``replay``) the dispatch is captured once as a CUDA graph
    and replayed. The ids go in through a pinned host buffer and a
    persistent device tensor; the graph holds what the caller's enqueue
    function puts on the stream for them (``U[uids]`` and kernel 2 through
    P and Q, or kernel 5, for the serving engine; kernel 6 in place, or
    the gathers and kernel 1, for the tiled one) and the slates' copies
    into one pinned packet (vals (R, k) f32, then idx (R, k) i32); one
    event marks the packet filled. A graph reads its operands by address,
    so each launch compares the data pointers and shapes of the operands
    the caller hands it with those it captured, and captures again on any
    difference: an in-place patch (`ServingEngine.ingest`) keeps the
    graph, a reassigned tensor does not. The caller also hands the kernel
    wrapper whose ``launches`` counter the plan keeps: one launch a
    replay, none for the warm-up and the capture.

    On the CPU the same members do the plain thing: `ids_np` is the
    memory of `ids_dev`, `upload` does nothing, `launch` calls the enqueue
    function (the kernels' plain versions, which count no launch) and
    `wait` returns its slates. R and k come from the engine's frozen
    `ServingConfig`, once."""

    def __init__(self, device: torch.device, R: int, k: int):
        self.device = device
        self.replay = device.type == "cuda"
        self.ids = torch.empty(R, dtype=torch.int64, pin_memory=self.replay)
        self.ids_np = self.ids.numpy()
        self.ids_dev = self.ids
        self.graph = self.key = None
        if self.replay:
            self.ids_dev = torch.empty(R, dtype=torch.int64, device=device)
            packet = torch.empty(8 * R * k, dtype=torch.uint8, pin_memory=True)
            self.vals = packet[:4 * R * k].view(torch.float32).view(R, k)
            self.idx = packet[4 * R * k:].view(torch.int32).view(R, k)
            self.vals_np, self.idx_np = self.vals.numpy(), self.idx.numpy()
            self.done = torch.cuda.Event()

    def upload(self) -> None:
        """The ids of `ids_np` onto the card, on the current stream."""
        if self.replay:
            self.ids_dev.copy_(self.ids, non_blocking=True)

    def launch(self, operands: tuple[torch.Tensor, ...], enqueue, kernel) -> bool:
        """Run ``enqueue`` (`ids_dev` → (vals, idx) on the device). On a
        card: replay it, capturing it first where ``operands``, every
        tensor it reads, moved; count one launch in ``kernel.launches``.
        Returns whether it captured."""
        if not self.replay:
            self.slates = enqueue(self.ids_dev)
            return False
        key = tuple((t.data_ptr(), t.shape) for t in operands)
        captured = key != self.key
        if captured:
            self.graph = self.key = None        # the old graph's memory pool goes first
            self.graph = self._capture(enqueue, kernel)
            self.key = key
        self.graph.replay()
        self.done.record(torch.cuda.current_stream(self.device))
        kernel.launches += 1
        return captured

    def wait(self) -> tuple[np.ndarray, np.ndarray]:
        """Wait for the launch; its slates (R, k) on the host, on a card
        the packet's, valid until the next launch."""
        if not self.replay:
            return tuple(x.numpy() for x in self.slates)
        self.done.synchronize()
        return self.vals_np, self.idx_np

    def _capture(self, enqueue, kernel) -> torch.cuda.CUDAGraph:
        launches = kernel.launches

        def run():
            vals, idx = enqueue(self.ids_dev)
            self.vals.copy_(vals, non_blocking=True)
            self.idx.copy_(idx, non_blocking=True)
        try:
            with torch.cuda.device(self.device):
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):   # warm-up: loads the library, sets attributes
                    run()
                torch.cuda.current_stream().wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    run()
        finally:
            kernel.launches = launches
        return graph


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
        self._pop_items, self._pop_vals = _popularity(self._item_counts, cfg.k)
        # the row each known user is served on by `serve_microbatch` on one
        # device: row 0 for a user whose slate the popularity slate replaces
        # (as `recommend` clamps them: their reads hit one row again and
        # again), the user's own row otherwise; `ingest` keeps it
        users = np.arange(I)
        self._serve_row = np.where(self._flags(users), 0, users)
        self._rows = I                 # rows a shard: user u lives on shard u // _rows
        self._plan = _DispatchPlan(self.device, cfg.microbatch, cfg.k)   # one device's dispatch
        self._kernel = ops.serve_topk_rows if cfg.prune else ops.recommend_topk_peruser
        self._update_plan = online_lib.UpdatePlan(self.device)   # the ingest's batch updates
        if group is not None:
            self._shard()
        # persistent stream: successive ingest() calls draw fresh negatives
        self._rng = np.random.default_rng(dmf_cfg.seed if dmf_cfg is not None else 0)
        self.stats = EngineStats()

    # -------------------------------------------------------------- fallback
    def _fallback_mask(self, user_ids: np.ndarray) -> np.ndarray:
        """True where the factor path cannot give a meaningful slate."""
        uids = np.asarray(user_ids)
        unknown = (uids < 0) | (uids >= self._n_users)
        safe = np.clip(uids, 0, self._n_users - 1)
        flags = unknown | self._cold[safe]
        if self.cfg.prune:
            flags = flags | self._bucket_empty[self._user_bucket_np[safe]]
        return flags

    def _flags(self, user_ids: np.ndarray) -> np.ndarray:
        """The requests that get the popularity slate: `_fallback_mask`
        with ``cfg.fallback`` on, none with it off."""
        if self.cfg.fallback:
            return self._fallback_mask(user_ids)
        return np.zeros(len(user_ids), bool)

    # ---------------------------------------------------------------- sharding
    def _shard(self) -> None:
        """Serve row-sharded over ``self.group``: take this rank's
        zero-padded rows of U, V = P + Q, seen and the users' buckets (ref
        :242-264)."""
        group = self.group
        self._rows = sharded_dmf.rows_per_shard(self._n_users, group.size)
        self._row0 = group.rank * self._rows

        def mine(x):
            return sharded_dmf.group_rows(x, group, self._rows)
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
        return _dispatch_rows(self._U_loc, self._V_loc, None, self._seen_loc, self._bucket_items,
                              self._ub_loc, uids, self.cfg.k, self.cfg.prune)

    # ------------------------------------------------------------------ serve
    def _operands(self) -> tuple[torch.Tensor, ...]:
        """Every tensor an unsharded dispatch reads."""
        st = self.state
        return st.U, st.P, st.Q, self.seen, self._bucket_items, self._user_bucket

    def _launch(self, uids: torch.Tensor):
        """An unsharded dispatch over the raw factor state
        (`_dispatch_rows`) for serving rows (R,) on the device."""
        return _dispatch_rows(*self._operands(), uids, self.cfg.k, self.cfg.prune)

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
        results buffered).

        On one device the order is always arrival's, and each microbatch
        goes through the engine's dispatch plan, as in `serve_microbatch`
        (one capture serves both); the ids are served as given, unclipped:
        `recommend` clamps flagged users to row 0 first."""
        if self.group is not None:
            yield from self._stream_sharded(user_ids, ordered)
            return
        plan = self._plan
        for buf, n, arr in self._microbatches(user_ids, _t_arrival):
            t0 = time.perf_counter()
            with trace_lib.span("engine.dispatch", n_real=n, prune=self.cfg.prune):
                plan.ids_np[:] = buf
                plan.upload()
                self.stats.n_captures += plan.launch(self._operands(), self._launch,
                                                     self._kernel)
                vals, idx = (x[:n].copy() for x in plan.wait())
            t1 = time.perf_counter()
            self.stats.dispatch_seconds.append(t1 - t0)
            self.stats.n_dispatches += 1
            self.stats.n_requests += n
            self.stats.request_seconds.extend((t1 - arr).tolist())
            yield buf[:n], vals, idx

    def serve_microbatch(self, user_ids, return_flags: bool = False):
        """Serve ≤ `microbatch` requests in one dispatch over the raw factor
        state. Returns ``(vals (n, k), idx (n, k), service_seconds)``, with
        the per-request fallback flags before the seconds if
        ``return_flags``; the arrays are the caller's own. The service
        seconds (the ids' upload to the slates on the host) go to
        ``stats.dispatch_seconds``. An id outside [0, I) with
        ``cfg.fallback`` off raises IndexError.

        Unsharded, the dispatch goes through the engine's plan
        (`_DispatchPlan`): on a card one CUDA graph replay a call,
        captured on the first call and again whenever the engine's
        operands moved (``stats.n_captures``); on the CPU the same phases
        call the kernels' plain versions.

        Sharded, it is a collective that every rank calls with the same
        ids, all users of one shard (``user // _rows`` once clamped to the
        known ids, as the scheduler routes): their home rank serves them
        from its own rows, bit for bit what one device gives, and
        broadcasts the slates and its wall seconds, so every rank returns
        the same. The broadcast's own wall time goes to
        ``broadcast_seconds``, not to the service seconds.

        Traced, a dispatch is one ``engine.serve_microbatch`` span from
        entry to return, its args the engine's ``dispatch`` number,
        ``rows`` launched (padding included), ``replay`` (1 where the plan
        replayed it on a card, else 0), ``n_real`` and ``n_fallback``.
        Inside it, in order, on one device: ``engine.prepare`` (the ids
        clipped to [0, I), mapped to their serving rows and padded with
        the first, into the plan's buffer), ``engine.upload`` (one
        non-blocking copy to the card; none on the CPU), ``engine.launch``
        (the replay and its event, or the kernel's wrapper on the CPU),
        ``engine.readback`` (the fallback mask while the kernel runs, the
        wait, the slates copied out of the plan) and ``engine.finish``
        (the stats, the fallback overwrite);
        sharded, ``engine.prepare`` (the fallback mask),
        ``engine.serve_home`` and ``engine.finish``. Unknown ids are
        clipped to [0, I); a known user whose slate the popularity slate
        replaces is served on row 0 (``_serve_row``), so the mask
        itself can wait until the kernel runs. A call with no ids
        dispatches nothing and records no span."""
        R, k = self.cfg.microbatch, self.cfg.k
        if len(user_ids) == 0:
            out = (np.empty((0, k), np.float32), np.empty((0, k), np.int32))
            return out + ((np.empty(0, bool),) if return_flags else ()) + (0.0,)
        d = self.stats.n_dispatches
        plan = self._plan
        with trace_lib.span("engine.serve_microbatch", dispatch=d, rows=R,
                            replay=int(plan.replay and self.group is None)) as sp:
            with trace_lib.span("engine.prepare", dispatch=d):
                user_ids = np.asarray(user_ids)
                n = len(user_ids)
                assert n <= R, f"serve_microbatch takes ≤ microbatch ids ({n} > {R})"
                if self.group is None:
                    buf = plan.ids_np
                    # clipped to [0, I), then each user's serving row
                    np.take(self._serve_row, user_ids, mode="clip", out=buf[:n])
                    buf[n:] = buf[0]       # pad with a real row (results dropped)
                    if not self.cfg.fallback and (buf[:n] != user_ids).any():
                        raise IndexError(f"serve_microbatch: a user id outside "
                                         f"[0, {self._n_users})")
                else:
                    flags = self._flags(user_ids)
                    fallen = np.flatnonzero(flags)
            if self.group is None:
                with trace_lib.span("engine.upload", dispatch=d):
                    t0 = time.perf_counter()
                    plan.upload()
                with trace_lib.span("engine.launch", dispatch=d):
                    self.stats.n_captures += plan.launch(self._operands(), self._launch,
                                                         self._kernel)
                with trace_lib.span("engine.readback", dispatch=d):
                    flags = self._flags(user_ids)            # while the kernel runs
                    fallen = np.flatnonzero(flags)
                    vals, idx = (x[:n].copy() for x in plan.wait())
                    dt = time.perf_counter() - t0
            else:
                vals, idx, dt = self._serve_home(user_ids, flags)
            with trace_lib.span("engine.finish", dispatch=d):
                n_fallback = len(fallen)
                if sp is not None:
                    sp.args.update(n_real=n, n_fallback=n_fallback)
                self.stats.dispatch_seconds.append(dt)
                self.stats.n_dispatches += 1
                self.stats.n_requests += n
                if n_fallback:      # by row numbers, found while the kernel ran
                    _overwrite(vals, idx, fallen, self._pop_items, self._pop_vals)
                    self.stats.n_fallbacks += n_fallback
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
        with trace_lib.span("engine.serve_home", n_real=n, shard=shard):
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
        flags = self._flags(user_ids)
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
            _overwrite(vals, idx, flags, self._pop_items, self._pop_vals)
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
        """Stream new check-ins through the online refresh (U/P/Q in place,
        which the dispatches read), then set the new check-ins' seen bits.
        Sharded, every rank refreshes its replicated state alike (the same
        events, the same generator) and patches its own rows of the served
        views; nothing crosses ranks.

        With DP off the refresh runs through the engine's update plan
        (`online.UpdatePlan`), kept across ingests: on a card a step's
        batches go up in one pinned copy, each batch replays one captured
        CUDA graph of the update (captured on the first batch, and again
        whenever U, P, Q or the walk table moved; ``stats.n_update_captures``),
        and the losses are read once, after the last batch; on the CPU
        the plan calls the update directly. With DP on each batch uploads
        its arrays and reads its loss back. The bits are the same.

        Traced, an ingest is one ``engine.ingest`` span from entry to
        return, its args the ingest's number ``round`` (``n_refreshes``
        before it), ``n_events``, ``n_rows`` (events and negatives a
        step), ``n_batches`` (update calls over all steps), ``n_affected``,
        ``n_touched``, ``dp`` (1 where the refresh ran the DP mechanism)
        and ``n_released`` (the real messages released under the
        mechanism, ``n_rows`` a step; 0 with DP off); inside it the
        refresh's own spans (`online.online_refresh`), then
        ``engine.patch`` (the served views' rows when sharded, the seen
        bits, the cold and serving-row maps, the popularity slate).
        ``stats.n_touched`` adds up the touched users, ``stats.n_released``
        the released messages: the count a DP deployment composes its
        privacy loss over."""
        assert self.nbr is not None and self.dmf_cfg is not None, (
            "engine built without nbr/dmf_cfg — online refresh unavailable")
        events = np.asarray(events)
        rnd = self.stats.n_refreshes
        dp = self.dmf_cfg.dp
        n_rows = len(events) * (1 + ocfg.neg_samples)
        n_released = ocfg.steps * n_rows if dp else 0
        with trace_lib.span("engine.ingest", round=rnd, n_events=len(events)) as sp:
            plan = self._update_plan
            captures = plan.captures
            self.state, report = online_lib.online_refresh(
                self.state, self.nbr, events, self.dmf_cfg, ocfg,
                rng if rng is not None else self._rng, plan)
            self.stats.n_update_captures += plan.captures - captures
            with trace_lib.span("engine.patch", round=rnd):
                if self.group is not None:
                    self._patch_rows(report, events)
                if len(events):
                    ev = torch.as_tensor(events.astype(np.int64), device=self.device)
                    self.seen[ev[:, 0], ev[:, 1]] = 1
                    # a user with a first check-in stops being cold;
                    # popularity tracks the stream
                    np.add.at(self._item_counts, events[:, 1].astype(np.int64), 1)
                    u = events[:, 0].astype(np.int64)
                    self._cold[u] = False
                    self._serve_row[u] = np.where(self._flags(u), 0, u)
                    self._pop_items, self._pop_vals = _popularity(self._item_counts,
                                                                  self.cfg.k)
            if sp is not None:
                sp.args.update(n_rows=n_rows, n_batches=report.n_batches,
                               n_affected=len(report.affected_users),
                               n_touched=len(report.touched_users), dp=int(dp),
                               n_released=n_released)
        self.stats.n_refreshes += 1
        self.stats.n_events += int(len(events))
        self.stats.n_touched += len(report.touched_users)
        self.stats.n_released += n_released
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
