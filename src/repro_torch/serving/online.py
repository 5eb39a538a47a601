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

Traced (`obs/trace.py`), a refresh records ``online.touched`` (the walk
table's receivers read back), then a step at a time ``online.sample``
(the step's negatives drawn, its batches padded and uploaded; args
``step``, ``rows``, ``batches``) followed by one ``online.update`` a batch
(the Eq. 9-11 step and its loss read back to the host; args ``step``,
``batch``). The draws, the batches and every update are those of the
untraced refresh.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import dmf
from repro_torch.core import graph as graph_lib
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


def _event_batches(events: np.ndarray, cfg: dmf.DMFConfig, ocfg: OnlineConfig,
                   rng: np.random.Generator, device: torch.device, rid_offset: int = 0):
    """Check-ins + per-event negatives (`dmf.sample_with_negatives`, the
    training-time sampler) packed into fixed-shape (cap,) batches on
    ``device``: (ui, vj, r, conf, valid, rid). ``rid`` (int32) are the
    rows' DP noise keys, shifted by ``rid_offset`` so that successive local
    passes over the same events never reuse a draw; padded rows get keys
    too."""
    ui, vj, r, conf = dmf.sample_with_negatives(events, cfg.n_items, ocfg.neg_samples, rng)
    cap = ocfg.batch_cap
    total = len(ui)
    for s in range(0, total, cap):
        b = min(s + cap, total) - s
        pad = cap - b
        host = (
            np.pad(ui[s : s + b], (0, pad)).astype(np.int64),
            np.pad(vj[s : s + b], (0, pad)).astype(np.int64),
            np.pad(r[s : s + b], (0, pad)).astype(np.float32),
            np.pad(conf[s : s + b], (0, pad)).astype(np.float32),
            (np.arange(cap) < b).astype(np.float32),
            (rid_offset + s + np.arange(cap)).astype(np.int32),
        )
        yield tuple(torch.as_tensor(x, device=device) for x in host)


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
) -> tuple[dmf.DMFState, RefreshReport]:
    """Run ``ocfg.steps`` local passes of the Eq. 9-11 step over the events
    (fresh negatives each pass) and scatter the global-factor gradients to
    the receivers. Updates ``state`` in place on its own device and returns
    it with a locality report.

    With DP on, ``rng`` must be given and persist across calls: a default
    one seeded from ``cfg.seed`` each call would re-derive the same noise
    seed every refresh, and repeated noise cancels in update differences.
    `ServingEngine.ingest` holds a persistent one."""
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
    losses = []
    for step in range(ocfg.steps):
        with trace_lib.span("online.sample", step=step, rows=stream_len, batches=n_batches):
            batches = list(_event_batches(events, cfg, ocfg, rng, state.U.device,
                                          rid_offset=step * stream_len))
        for b, (ui, vj, r, conf, valid, rid) in enumerate(batches):
            with trace_lib.span("online.update", step=step, batch=b):
                loss = dmf._sparse_batch_update(
                    state.U, state.P, state.Q, nbr.idx, nbr.wgt, ui, vj, r, conf, cfg,
                    valid=valid, rid=rid, dp_seed=dp_seed)
                losses.append(float(loss))
    report = RefreshReport(
        affected_users=affected,
        touched_users=touched,
        losses=losses,
        n_events=int(len(events)),
        n_batches=len(losses),
    )
    return state, report
