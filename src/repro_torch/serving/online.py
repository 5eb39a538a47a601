"""Online factor refresh: streamed check-ins update the served factors in
place — port of `src/repro/serving/online.py:45-170` (`OnlineConfig`,
`RefreshReport`, `_event_batches`, `touched_from_events`,
`online_refresh`, with the DP branch :95 and :133-149).

When user i checks in at POI j, the learner runs the paper's Eqs. 9-11
step for (i, j) plus a few sampled negatives (the training objective) and
ships only ∂L/∂p^i_j to its walk-neighbor receivers. One refresh writes
U and Q rows of the affected users only, and P rows of the affected users'
receivers only.

Events are padded to a fixed batch shape (``OnlineConfig.batch_cap``);
padded rows carry conf=0 and valid=0 and contribute nothing. U/P/Q are
updated **in place** (the reference donates them to a jitted step).

DP (``cfg.dp``): the refresh runs the same clip+noise mechanism over each
outgoing message as training — the online channel is no side door around
it. Each `online_refresh` call draws one fresh mechanism seed from its rng
(before sampling the negatives; DP off: no draw) and keys each row's noise
by its position in the refresh stream, ``step·stream_len + s + arange``.

Given an `UpdatePlan` (`ServingEngine.ingest` holds one) and DP off, the
refresh runs its batches through the plan: a step's batches go to the
device in one copy, on a card each batch replays one captured CUDA graph
of the update's whole chain, and the batches' losses stay on the device
until the last batch, then are read once. Without a plan (direct callers)
or with DP on, each batch uploads its own arrays and reads its loss back,
as the reference does; both give the same bits. With DP on the mechanism
draws a fresh seed each call, which a graph would freeze.

Traced (`obs/trace.py`), a refresh records ``online.touched`` (the walk
table's receivers read back), then a step at a time ``online.sample``
(the step's negatives drawn, its batches padded and uploaded, in one copy
through the plan; args ``step``, ``rows``, ``batches``) followed by one
``online.update`` a batch (the Eq. 9-11 step, its loss kept on the device
through the plan and read back without one; args ``step``, ``batch``,
``replay``: 1 where the batch replayed the plan's graph, 0 where it ran
eagerly or was the batch that captured it; ``dp``: 1 where the batch ran
the mechanism over its messages, on a card one eager kernel 8 launch). No
span sits inside the mechanism: kernel 8 is named in a device trace. The draws, the
batches and every update are those of the untraced refresh.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import dmf
from repro_torch.core import graph as graph_lib
from repro_torch.kernels import ops
from repro_torch.obs import trace as trace_lib
from repro_torch.privacy import mechanism


@dataclasses.dataclass(frozen=True)
class OnlineConfig:
    batch_cap: int = 256    # fixed event-batch shape (events + negatives)
    steps: int = 4          # local SGD passes over the event batch
    neg_samples: int = 3    # m fresh unobserved negatives per check-in


@dataclasses.dataclass
class RefreshReport:
    affected_users: np.ndarray   # unique users with new check-ins
    touched_users: np.ndarray    # affected ∪ their neighbor-table receivers
    losses: list[float]          # per-batch loss on the event batches
    n_events: int
    n_batches: int


# a batch's fields in the order of its record: name, numpy and torch dtype
_FIELDS = (("ui", np.int64, torch.int64), ("vj", np.int64, torch.int64),
           ("r", np.float32, torch.float32), ("conf", np.float32, torch.float32),
           ("valid", np.float32, torch.float32), ("rid", np.int32, torch.int32))


def _step_rows(events: np.ndarray, cfg: dmf.DMFConfig, ocfg: OnlineConfig,
               rng: np.random.Generator, rid_offset: int = 0) -> tuple[np.ndarray, ...]:
    """One step's check-ins + per-event negatives (`dmf.sample_with_negatives`,
    the training-time sampler) padded to whole batches: (ui, vj, r, conf,
    valid, rid), each (n_batches, ``ocfg.batch_cap``) in its `_FIELDS`
    dtype. ``rid`` (int32) are the rows' DP noise keys, shifted by
    ``rid_offset`` so that successive local passes over the same events
    never reuse a draw; padded rows get keys too, and conf=0, valid=0."""
    ui, vj, r, conf = dmf.sample_with_negatives(events, cfg.n_items, ocfg.neg_samples, rng)
    cap, total = ocfg.batch_cap, len(ui)
    n = -(-total // cap) * cap
    rows = (*(np.pad(x, (0, n - total)) for x in (ui, vj, r, conf)),
            np.arange(n) < total, rid_offset + np.arange(n))
    return tuple(x.astype(dt).reshape(-1, cap) for x, (_, dt, _) in zip(rows, _FIELDS))


def _event_batches(events: np.ndarray, cfg: dmf.DMFConfig, ocfg: OnlineConfig,
                   rng: np.random.Generator, device: torch.device, rid_offset: int = 0):
    """A step's batches (`_step_rows`) as fixed-shape (cap,) tensors on
    ``device``, one upload an array: (ui, vj, r, conf, valid, rid)."""
    rows = _step_rows(events, cfg, ocfg, rng, rid_offset)
    for b in range(len(rows[0])):
        yield tuple(torch.as_tensor(x[b], device=device) for x in rows)


def _record(cap: int) -> np.dtype:
    """One batch's record in a step block: each field's (cap,) array in
    `_FIELDS` order, 32·cap bytes (every field aligned to its size)."""
    return np.dtype([(name, dt, (cap,)) for name, dt, _ in _FIELDS])


def _fields(chunk: torch.Tensor, cap: int) -> list[torch.Tensor]:
    """The six (cap,) tensors of one batch record ``chunk`` (uint8), as
    views of its memory."""
    out, off = [], 0
    for _, dt, tdt in _FIELDS:
        n = cap * np.dtype(dt).itemsize
        out.append(chunk[off:off + n].view(tdt))
        off += n
    return out


def _update(state: dmf.DMFState, nbr: graph_lib.NeighborTable, cfg: dmf.DMFConfig,
            chunk: torch.Tensor, cap: int) -> torch.Tensor:
    """The Eq. 9-11 update of one DP-off batch record ``chunk``, in place;
    its 0-d loss on the device."""
    ui, vj, r, conf, valid, rid = _fields(chunk, cap)
    return dmf._sparse_batch_update(state.U, state.P, state.Q, nbr.idx, nbr.wgt, ui, vj, r,
                                    conf, cfg, valid=valid, rid=rid)


class UpdatePlan:
    """The batch updates of DP-off refreshes on one device, kept across
    `online_refresh` calls (`ServingEngine.ingest` holds one): the caller
    hands each step's rows to `load`, then each batch to `update` with a
    0-d slot of a device vector for its loss.

    `load` packs the step's batches, a record each (`_record`), into a
    host block, and on a card sends the block to a device block in one
    non-blocking copy from pinned memory. Two host blocks take turns; a
    block is written again only after the event of the copy that last read
    it, so the next step's draws overlap the card's work.

    On a card (``replay``) `update` copies the batch's record into the
    plan's static input (one device-to-device copy) and replays one CUDA
    graph of the update's whole chain: the gathers, kernel 3, the masks,
    the walk-table gathers and the three scatters (bounds checks, sorts and
    all), then copies the graph's loss into the slot. The graph reads its
    operands by address, so each batch compares the data pointers and
    shapes of U, P, Q and the walk table, the batch size and the
    configuration with those it captured, and captures again on any
    difference: an in-place write keeps the graph, a reassigned tensor
    does not. The batch that captures runs eagerly on its real inputs
    first, on the capture's stream, and that run is its update; the
    capture records and does not execute, so U, P and Q are written once a
    batch. The plan counts its captures in ``captures`` and keeps the
    kernels' ``launches`` counters: the eager batch counts its launches,
    the capture none, each replay those of one update.

    On the CPU the same members do the plain thing: one block, which is
    the device block, and `update` calls the update on the record's
    views."""

    def __init__(self, device: torch.device):
        self.device = device
        self.replay = device.type == "cuda"
        self.captures = 0
        self.graph = self.key = self._loss = self._inp = self._dev = self._side = None
        self._launches = []
        self._host = [None, None]
        self._copied = [torch.cuda.Event(), torch.cuda.Event()] if self.replay else None
        self._turn = 0

    def load(self, rows: tuple[np.ndarray, ...]) -> None:
        """Pack a step's rows (`_step_rows`) into the next host block and, on
        a card, send it to the device block in one non-blocking copy."""
        self._cap = cap = rows[0].shape[1]
        rec = _record(cap)
        self._size = rec.itemsize
        need = len(rows[0]) * rec.itemsize
        if self.replay:
            self._turn ^= 1
        t = self._turn
        blk = self._host[t]
        if blk is None or blk.numel() < need:
            blk = self._host[t] = torch.empty(need, dtype=torch.uint8, pin_memory=self.replay)
        elif self.replay:
            self._copied[t].synchronize()      # the copy that last read this block is done
        recs = blk[:need].numpy().view(rec)
        for (name, _, _), x in zip(_FIELDS, rows):
            recs[name] = x
        if not self.replay:
            self._block = blk
            return
        if self._dev is None or self._dev.numel() < need:
            self._dev = torch.empty(need, dtype=torch.uint8, device=self.device)
        self._dev[:need].copy_(blk[:need], non_blocking=True)
        self._copied[t].record(torch.cuda.current_stream(self.device))
        self._block = self._dev

    def update(self, b: int, state: dmf.DMFState, nbr: graph_lib.NeighborTable,
               cfg: dmf.DMFConfig, out: torch.Tensor) -> bool:
        """Batch ``b`` of the loaded step: the update of ``state`` in place,
        its loss into the 0-d ``out``. Returns whether a graph replayed it."""
        cap, size = self._cap, self._size
        chunk = self._block[b * size:(b + 1) * size]
        if not self.replay:
            out.copy_(_update(state, nbr, cfg, chunk, cap))
            return False
        key = (tuple((t.data_ptr(), t.shape) for t in (state.U, state.P, state.Q, nbr.idx,
                                                      nbr.wgt)), cap, cfg)
        replayed = key == self.key
        if not replayed:
            self.graph = self.key = self._loss = None   # the old graph's memory pool goes first
            if self._inp is None or self._inp.numel() != size:
                self._inp = torch.empty(size, dtype=torch.uint8, device=self.device)
        self._inp.copy_(chunk)
        if replayed:
            self.graph.replay()
            for kern, n in self._launches:
                kern.launches += n
            out.copy_(self._loss)
        else:
            self._capture(state, nbr, cfg, out)
            self.key = key
            self.captures += 1
        return replayed

    def _capture(self, state, nbr, cfg, out) -> None:
        with torch.cuda.device(self.device):
            if self._side is None:
                self._side = torch.cuda.Stream()
            side = self._side
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                # the batch itself, eagerly: its one update, and the warm-up
                out.copy_(_update(state, nbr, cfg, self._inp, self._cap))
                before = [kern.launches for kern in ops.KERNELS]
                graph = torch.cuda.CUDAGraph()
                try:
                    # thread_local: other threads' CUDA calls (a process
                    # group's watchdog, a profiler) may go on meanwhile
                    with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                        self._loss = _update(state, nbr, cfg, self._inp, self._cap)
                finally:
                    self._launches = [(kern, kern.launches - n)
                                      for kern, n in zip(ops.KERNELS, before) if kern.launches != n]
                    for kern, n in zip(ops.KERNELS, before):
                        kern.launches = n
            torch.cuda.current_stream().wait_stream(side)
        self.graph = graph


def touched_from_events(events: np.ndarray,
                        nbr: graph_lib.NeighborTable) -> tuple[np.ndarray, np.ndarray]:
    """(affected, touched): the users whose factors a refresh may write.
    Touched = affected ∪ their positive-weight neighbor-table receivers."""
    affected = np.unique(np.asarray(events)[:, 0]).astype(np.int64)
    rows = torch.as_tensor(affected, device=nbr.idx.device)
    idx = nbr.idx[rows].cpu().numpy()
    wgt = nbr.wgt[rows].cpu().numpy()
    receivers = np.unique(idx[wgt > 0])
    touched = np.union1d(affected, receivers)
    return affected, touched


def online_refresh(
    state: dmf.DMFState,
    nbr: graph_lib.NeighborTable,
    events: np.ndarray,            # (n, 2) int (user, item) new check-ins
    cfg: dmf.DMFConfig,
    ocfg: OnlineConfig = OnlineConfig(),
    rng: np.random.Generator | None = None,
    plan: UpdatePlan | None = None,
) -> tuple[dmf.DMFState, RefreshReport]:
    """Run ``ocfg.steps`` local passes of the Eq. 9-11 step over the events
    (fresh negatives each pass) and scatter the global-factor gradients to
    the receivers. Updates ``state`` in place on its own device and returns
    it with a locality report.

    With DP on, ``rng`` must be given and persist across calls: a default
    one seeded from ``cfg.seed`` each call would re-derive the same noise
    seed every refresh, and repeated noise cancels in update differences.
    `ServingEngine.ingest` holds a persistent one.

    With a ``plan`` on the state's device and DP off, the batches run
    through it (the module's docstring) and the losses are read once,
    after the last batch; the report is the same."""
    events = np.asarray(events)
    if len(events) == 0:
        return state, RefreshReport(np.empty(0, np.int64), np.empty(0, np.int64), [], 0, 0)
    if cfg.dp and rng is None:
        raise ValueError(
            "online_refresh with DP on needs an explicit persistent rng — "
            "the default would reuse the same noise stream every call")
    rng = rng or np.random.default_rng(cfg.seed)
    with trace_lib.span("online.touched"):
        affected, touched = touched_from_events(events, nbr)
    dp_seed = mechanism.epoch_noise_seed(rng, cfg) if cfg.dp else 0
    stream_len = len(events) * (1 + ocfg.neg_samples)
    n_batches = -(-stream_len // ocfg.batch_cap)
    dev = state.U.device
    planned = plan is not None and not cfg.dp
    if planned and plan.device != dev:
        raise ValueError(f"online_refresh: the plan is for {plan.device}, the state on {dev}")
    losses = (torch.empty(ocfg.steps * n_batches, dtype=torch.float32, device=dev)
              if planned else [])
    for step in range(ocfg.steps):
        with trace_lib.span("online.sample", step=step, rows=stream_len, batches=n_batches):
            if planned:
                plan.load(_step_rows(events, cfg, ocfg, rng, rid_offset=step * stream_len))
            else:
                batches = list(_event_batches(events, cfg, ocfg, rng, dev,
                                              rid_offset=step * stream_len))
        for b in range(n_batches):
            with trace_lib.span("online.update", step=step, batch=b) as sp:
                if planned:
                    replayed = plan.update(b, state, nbr, cfg, losses[step * n_batches + b])
                else:
                    ui, vj, r, conf, valid, rid = batches[b]
                    loss = dmf._sparse_batch_update(
                        state.U, state.P, state.Q, nbr.idx, nbr.wgt, ui, vj, r, conf, cfg,
                        valid=valid, rid=rid, dp_seed=dp_seed)
                    losses.append(float(loss))
                    replayed = False
                if sp is not None:
                    sp.args.update(replay=int(replayed), dp=int(cfg.dp))
    if planned:
        losses = losses.tolist()        # one read, after the last batch
    report = RefreshReport(
        affected_users=affected,
        touched_users=touched,
        losses=losses,
        n_events=int(len(events)),
        n_batches=len(losses),
    )
    return state, report
