"""Byzantine-robust gradient exchange: attack injection and receiver-side
defenses — port of `src/repro/robustness/byzantine.py:71-392` (the host
half `AttackConfig`, `AttackPlan`, `no_attack`, `DefenseConfig`,
`MessageGroups`, `_round_up`, `_cumcount`, `_assign_buckets`,
`group_messages`, :394-439 `group_messages_sharded` as numpy copies; the
device half `corrupt_messages`, `screen_ok`, `_sort_cols`,
`robust_combine` on tensors).

In DMF a learner's P rows are updated by scatter-adding whatever gradient
messages arrive, so one compromised phone can poison every neighbour.

* **Attack injection** — `AttackConfig.compile(...) -> AttackPlan`: a
  seeded plan of which learners are malicious from which epoch, realized
  per epoch as per-row corruption arrays applied to OUTGOING messages at
  the sender boundary, after the DP mechanism. Families: ``nan``/``inf``
  bombs, ``norm_inflate`` (λ·g), ``sign_flip`` (−g), ``shill`` (every
  message re-addressed to ``target_item`` with content −scale·d̂;
  ``collude`` shares one direction).
* **Screening** — `screen_ok`: every coordinate finite AND ‖m‖₂ ≤ τ,
  evaluated on every incoming message before the P scatter (and on every
  stale ring message at delivery). A rejected message is zeroed in content
  AND weight (0·NaN is NaN).
* **Robust aggregation** — messages for one (receiver, item) in one step
  go into a fixed-shape bucket buffer (membership compiled on the host per
  epoch, `group_messages`), sorted coordinate-wise, and combined as the
  count-scaled trimmed mean or median instead of summed.

No attack and defenses off never enter this code: `dmf.fit` routes here
only with an attack plan or an *active* `DefenseConfig`.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.scatter import scatter_add_rows_

FAMILIES = ("none", "nan", "inf", "norm_inflate", "sign_flip", "shill")
AGGREGATIONS = ("sum", "trim", "median")


@dataclasses.dataclass(frozen=True)
class AttackConfig:
    """Adversary schedule parameters. `compile(n_users, epochs, dim)`
    realizes them into an `AttackPlan`; the draw order (malicious set →
    shill directions) is fixed, so a seed fully determines the plan."""

    family: str = "none"        # one of FAMILIES
    frac: float = 0.0           # fraction of learners malicious
    scale: float = 10.0         # λ for norm_inflate; push magnitude for shill
    target_item: int = 0        # shill: the promoted POI
    collude: bool = True        # shill: one shared direction vs per-attacker
    start_epoch: int = 0        # attackers behave honestly before this epoch
    seed: int = 0

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"family={self.family!r} (one of {FAMILIES})")
        if not 0.0 <= self.frac <= 1.0:
            raise ValueError(f"frac={self.frac} must be in [0, 1]")
        if not self.scale > 0.0:
            raise ValueError(f"scale={self.scale} must be > 0")
        if self.target_item < 0 or self.start_epoch < 0:
            raise ValueError("target_item and start_epoch must be >= 0")

    def compile(self, n_users: int, epochs: int, dim: int) -> "AttackPlan":
        rng = np.random.default_rng(self.seed)
        n_mal = int(round(self.frac * n_users))
        malicious = np.zeros(n_users, bool)
        if n_mal > 0 and self.family != "none":
            malicious[rng.choice(n_users, size=n_mal, replace=False)] = True
        active = np.zeros((epochs, n_users), bool)
        if self.start_epoch < epochs:
            active[self.start_epoch:] = malicious[None, :]
        dirs = np.zeros((n_users, dim), np.float32)
        if self.family == "shill" and malicious.any():
            k = 1 if self.collude else int(malicious.sum())
            d = rng.normal(size=(k, dim))
            d /= np.linalg.norm(d, axis=1, keepdims=True)
            # premultiplied message content: the scatter applies -θ·w·msg,
            # so msg = -scale·d̂ pushes P[:, target] toward +d̂
            dirs[malicious] = (-self.scale * d).astype(np.float32)
        return AttackPlan(active=active, malicious=malicious, dirs=dirs, config=self)


@dataclasses.dataclass(frozen=True)
class AttackPlan:
    """A compiled adversary schedule: pure data, safe to hash/ship/replay."""

    active: np.ndarray      # (epochs, I) bool — attacker live this epoch
    malicious: np.ndarray   # (I,) bool — the compromised set
    dirs: np.ndarray        # (I, K) float32 — premultiplied shill content
    config: AttackConfig

    @property
    def n_epochs(self) -> int:
        return int(self.active.shape[0])

    @property
    def n_users(self) -> int:
        return int(self.active.shape[1])

    @property
    def n_malicious(self) -> int:
        return int(self.malicious.sum())

    def is_trivial(self) -> bool:
        return not bool(self.active.any())

    def epoch_row_attack(self, t: int, ui: np.ndarray, vj: np.ndarray,
                         sender_on: np.ndarray | None = None):
        """Per-row corruption arrays for epoch ``t`` of a sampled sender
        stream ``ui`` (any shape; ``vj`` matches): ``amul`` the
        multiplicative corruption (1 = honest; λ / −1 / NaN / Inf per
        family; offline senders forced back to 1), ``ashill`` 1 where the
        message is REPLACED by the sender's shill content, ``vj_msg`` the
        message's item addressing (``target_item`` for shill rows)."""
        if not 0 <= t < self.n_epochs:
            raise ValueError(f"epoch {t} outside the plan's {self.n_epochs} epochs")
        ui = np.asarray(ui)
        safe = np.minimum(ui, self.n_users - 1)    # padded routed slots
        mal = self.active[t][safe] & (ui < self.n_users)
        if sender_on is not None:
            mal = mal & np.asarray(sender_on).astype(bool)
        fam = self.config.family
        amul = np.ones(ui.shape, np.float32)
        if fam == "norm_inflate":
            amul[mal] = np.float32(self.config.scale)
        elif fam == "sign_flip":
            amul[mal] = -1.0
        elif fam == "nan":
            amul[mal] = np.nan
        elif fam == "inf":
            amul[mal] = np.inf
        shill = mal & (fam == "shill")
        vjm = np.where(shill, self.config.target_item, vj).astype(np.int32)
        return amul, shill.astype(np.float32), vjm


def no_attack(n_users: int, epochs: int, dim: int) -> AttackPlan:
    """The trivial plan: nobody malicious — `fit` normalizes it to None."""
    return AttackConfig().compile(n_users, epochs, dim)


@dataclasses.dataclass(frozen=True)
class DefenseConfig:
    """Receiver-side defense switches. ``active == False`` (the default)
    means the epoch never enters the Byzantine code path at all."""

    screen: bool = False            # finite-check + norm-cap gate
    norm_cap: float = float("inf")  # τ; inf ⇒ finite-check only
    aggregation: str = "sum"        # sum | trim | median
    trim_frac: float = 0.2          # per-side trim fraction (trim mode)

    def __post_init__(self):
        if self.aggregation not in AGGREGATIONS:
            raise ValueError(f"aggregation={self.aggregation!r} (one of {AGGREGATIONS})")
        if not 0.0 <= self.trim_frac < 0.5:
            raise ValueError(f"trim_frac={self.trim_frac} must be in [0, 0.5)")
        if not self.norm_cap > 0.0:
            raise ValueError(f"norm_cap={self.norm_cap} must be > 0")

    @property
    def active(self) -> bool:
        return self.screen or self.aggregation != "sum"


# ---------------------------------------------------------------------------
# Device half (tensors; called by core/dmf per minibatch)
# ---------------------------------------------------------------------------
def corrupt_messages(gp: torch.Tensor, amul: torch.Tensor, ashill: torch.Tensor,
                     shill_msg: torch.Tensor) -> torch.Tensor:
    """Apply the compiled per-row corruption at the sender boundary:
    ``gp (B, K)`` honest released messages, ``amul``/``ashill (B,)``,
    ``shill_msg (B, K)`` the rows' premultiplied shill content."""
    out = gp * amul[:, None]
    return torch.where(ashill[:, None] > 0, shill_msg, out)


def screen_ok(gp: torch.Tensor, norm_cap: float) -> torch.Tensor:
    """Per-message accept mask (float 0/1): every coordinate finite AND
    ‖m‖₂ ≤ τ, compared in fp32 against fp32(τ)². NaN compares false, so
    bombs fail both gates. ``gp`` is (..., K); the mask drops the last
    axis."""
    ok = torch.isfinite(gp).all(dim=-1)
    if math.isfinite(norm_cap):
        cap = np.float32(norm_cap)
        nrm2 = (gp * gp).sum(dim=-1)
        ok = ok & (nrm2 <= float(cap * cap))
    return ok.to(gp.dtype)


def _sort_cols(vs: torch.Tensor) -> torch.Tensor:
    """Ascending sort along axis 1 by the reference's odd-even
    transposition network: ``cap`` rounds, each a `torch.minimum` and a
    `torch.maximum` over the round's disjoint column pairs taken as two
    strided slices. The network, not `torch.sort`: min/max spread a NaN
    through every pair it meets, as the reference's does, where
    `torch.sort` would move it to the end."""
    vs = vs.clone()
    cap = vs.shape[1]
    for r in range(cap):
        s = r % 2
        n = (cap - s) // 2
        if n == 0:
            continue
        a = vs[:, s:s + 2 * n:2]
        b = vs[:, s + 1:s + 2 * n:2]
        lo, hi = torch.minimum(a, b), torch.maximum(a, b)
        a.copy_(lo)
        b.copy_(hi)
    return vs


def robust_combine(vals: torch.Tensor, validity: torch.Tensor, bucket_id: torch.Tensor,
                   pos: torch.Tensor, n_buckets: int, cap: int,
                   defense: DefenseConfig) -> torch.Tensor:
    """Coordinate-wise robust combine over fixed-shape message buckets.

    ``vals (M, K)`` weighted screened messages, ``validity (M,)`` 0/1,
    ``bucket_id (M,)`` in [0, n_buckets] (n_buckets = the overflow row for
    host-invalid slots, which carry value 0), ``pos (M,) < cap`` unique
    within a bucket (`group_messages`). Returns the (n_buckets, K) per-
    bucket updates ``c · trimmed_mean`` or ``c · median``, c the valid
    count; invalid slots sort to +inf and fall outside the count-derived
    keep window; empty buckets combine to exactly 0. The buffer is filled
    by `scatter_add_rows_` (the overflow row takes many slots)."""
    K = vals.shape[-1]
    aug = torch.cat([vals, validity[:, None]], dim=-1)
    buf_aug = torch.zeros((n_buckets + 1, cap, K + 1), dtype=vals.dtype, device=vals.device)
    scatter_add_rows_(buf_aug, (bucket_id, pos), aug)
    buf, m = buf_aug[..., :K], buf_aug[..., K]
    c = m.sum(dim=1)                                          # (NB+1,)
    ci = c.to(torch.int32)[:, None]
    vs = torch.where(m[..., None] > 0, buf, torch.inf)
    vs = _sort_cols(vs)                                       # (NB+1, cap, K)
    if defense.aggregation == "trim":
        k = torch.floor(defense.trim_frac * c).to(torch.int32)[:, None]
        p = torch.arange(cap, device=vals.device)[None, :]
        keep = (p >= k) & (p < ci - k)
        s = torch.where(keep[..., None], vs, 0.0).sum(dim=1)
        denom = torch.clamp(ci - 2 * k, min=1).to(vals.dtype)
        comb = c[:, None] * s / denom
    else:  # median
        lo = torch.clamp((ci[:, 0] - 1) // 2, 0, cap - 1)[:, None, None]
        hi = torch.clamp(ci[:, 0] // 2, 0, cap - 1)[:, None, None]
        vlo = torch.gather(vs, 1, lo.expand(vs.shape[0], 1, K).to(torch.int64))[:, 0]
        vhi = torch.gather(vs, 1, hi.expand(vs.shape[0], 1, K).to(torch.int64))[:, 0]
        comb = c[:, None] * 0.5 * (vlo + vhi)
    comb = torch.where(c[:, None] > 0, comb, 0.0)
    return comb[:n_buckets]


# ---------------------------------------------------------------------------
# Host half: bucket assignment (the sampled stream and the neighbour table
# are host-known, so group membership compiles ahead of the epoch — the
# device only scatters into the precomputed fixed-shape buffer)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MessageGroups:
    """Per-epoch bucket assignment: ``bucket_id``/``pos`` address each
    candidate message slot into a (groups, NBK(+1 overflow), cap) buffer;
    ``recv``/``item`` are each bucket's scatter target."""

    bucket_id: np.ndarray   # (..., slots) int32 in [0, NBK]
    pos: np.ndarray         # (..., slots) int32 < cap
    recv: np.ndarray        # (..., NBK) int32 receiver rows
    item: np.ndarray        # (..., NBK) int32 item ids
    cap: int                # max messages per bucket (padded)

    @property
    def n_buckets(self) -> int:
        return int(self.recv.shape[-1])


def _round_up(x: int, m: int) -> int:
    return -(-max(x, 1) // m) * m


def _cumcount(inv: np.ndarray, n_groups: int):
    """Stable position of each element within its group + group sizes."""
    order = np.argsort(inv, kind="stable")
    counts = np.bincount(inv, minlength=n_groups)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.empty(inv.size, np.int64)
    pos[order] = np.arange(inv.size) - starts[inv[order]]
    return pos, counts


def _assign_buckets(grp, recv, item, valid, n_groups, n_rows, n_items,
                    cap_multiple=4, bucket_multiple=64):
    """Shared bucket assignment: flat slot arrays keyed by (group,
    receiver, item). Returns (bid, pos, brecv, bitem, cap) with NBK/cap
    rounded up to stable multiples."""
    grp = np.asarray(grp).reshape(-1)
    recv = np.asarray(recv).reshape(-1)
    item = np.asarray(item).reshape(-1)
    valid = np.asarray(valid).reshape(-1).astype(bool)
    key = (grp.astype(np.int64) * n_rows + recv) * n_items + item
    flat = np.where(valid, key, -1)
    uniq, inv = np.unique(flat, return_inverse=True)
    pos, counts = _cumcount(inv, len(uniq))
    vmask = uniq >= 0
    ubatch = np.where(vmask, uniq // (np.int64(n_rows) * n_items), -1)
    # uniq is sorted and keys are group-major, so groups are contiguous
    start = np.searchsorted(ubatch, np.arange(n_groups))
    bucket_of_uniq = np.arange(len(uniq)) - start[np.maximum(ubatch, 0)]
    if vmask.any():
        nbk = int(np.bincount(ubatch[vmask], minlength=n_groups).max())
        cap = int(counts[vmask].max())
    else:
        nbk, cap = 1, 1
    NBK = _round_up(nbk, bucket_multiple)
    cap = _round_up(cap, cap_multiple)
    bid = np.where(valid, bucket_of_uniq[inv], NBK).astype(np.int32)
    p = np.where(valid, pos, 0).astype(np.int32)
    brecv = np.zeros((n_groups, NBK), np.int32)
    bitem = np.zeros((n_groups, NBK), np.int32)
    brecv[ubatch[vmask], bucket_of_uniq[vmask]] = (
        (uniq[vmask] // n_items) % n_rows).astype(np.int32)
    bitem[ubatch[vmask], bucket_of_uniq[vmask]] = (uniq[vmask] % n_items).astype(np.int32)
    return bid, p, brecv, bitem, cap


def group_messages(ui, vj_msg, nbr_idx, nbr_wgt, n_items,
                   sender_gate=None, recv_on=None) -> MessageGroups:
    """Bucket assignment for one epoch's (nb, B) stream, on the host
    (``nbr_idx``/``nbr_wgt`` numpy). A candidate slot is each (row,
    neighbour-table slot) pair; slots that cannot carry a message THIS
    epoch (weight-0 padding, the sender's own line-11 self slot, gated
    senders — offline or straggling — and offline receivers) go to the
    overflow bucket with value 0. Screening later zeroes a slot's validity
    on the device without moving it."""
    nbr_idx = np.asarray(nbr_idx)
    nbr_wgt = np.asarray(nbr_wgt)
    ui = np.asarray(ui)
    nb, B = ui.shape
    I, S = nbr_idx.shape
    recv = nbr_idx[ui]                           # (nb, B, S)
    w = nbr_wgt[ui]
    valid = (w > 0) & (recv != ui[..., None])
    if sender_gate is not None:
        valid &= np.asarray(sender_gate).astype(bool)[..., None]
    if recv_on is not None:
        valid &= np.asarray(recv_on).astype(bool)[recv]
    grp = np.broadcast_to(np.arange(nb)[:, None, None], recv.shape)
    item = np.broadcast_to(np.asarray(vj_msg)[..., None], recv.shape)
    bid, pos, brecv, bitem, cap = _assign_buckets(grp, recv, item, valid, nb, I, int(n_items))
    return MessageGroups(bucket_id=bid.reshape(nb, B, S), pos=pos.reshape(nb, B, S),
                         recv=brecv, item=bitem, cap=cap)


def group_messages_sharded(ui_local, vj_msg, valid_rows, part_idx, part_wgt, rows: int,
                           n_shards: int, n_items: int, prop_now=None,
                           online=None) -> MessageGroups:
    """Bucket assignment per (batch, destination shard) for the sharded
    epoch, on the host: enumerates every shard's incoming slots after the
    exchange in their received order — (source shard, routed row, table
    slot) — so the indexes line up with the flattened (D, Bs, S) tensors a
    rank receives.

    ``ui_local (nb, D, Bs)`` routed local sender rows, ``vj_msg`` routed
    message items, ``valid_rows`` routed row validity (padding and offline
    senders), ``part_idx``/``part_wgt (I_pad, D, S)`` the partitioned
    table, ``online (I_pad,)`` the receivers' global mask. Receiver ids in
    the result are shard-local rows; rank d takes ``[:, d]`` of each
    array."""
    pidx = np.asarray(part_idx)
    pwgt = np.asarray(part_wgt)
    ui_local = np.asarray(ui_local)
    nb, D, Bs = ui_local.shape
    S = pidx.shape[2]
    g = np.arange(D)[None, :, None] * rows + ui_local       # global senders
    w = pwgt[g]                                             # (nb, Dsrc, Bs, Ddst, S)
    ri = pidx[g]
    dest = np.arange(D)[None, None, None, :, None]
    grecv = dest * rows + ri
    valid = (w > 0) & (grecv != g[..., None, None])
    valid &= np.asarray(valid_rows).astype(bool)[..., None, None]
    if prop_now is not None:
        valid &= np.asarray(prop_now).astype(bool)[..., None, None]
    if online is not None:
        valid &= np.asarray(online).astype(bool)[grecv]
    item = np.broadcast_to(np.asarray(vj_msg)[..., None, None], ri.shape)
    # (nb, Dsrc, Bs, Ddst, S) -> (nb, Ddst, Dsrc, Bs, S): the received order
    ri_t = np.moveaxis(ri, 3, 1)
    val_t = np.moveaxis(valid, 3, 1)
    item_t = np.moveaxis(item, 3, 1)
    grp = np.arange(nb)[:, None] * D + np.arange(D)[None, :]
    grp = np.broadcast_to(grp[:, :, None, None, None], ri_t.shape)
    bid, pos, brecv, bitem, cap = _assign_buckets(grp, ri_t, item_t, val_t, nb * D, rows,
                                                  int(n_items))
    M = D * Bs * S
    return MessageGroups(bucket_id=bid.reshape(nb, D, M), pos=pos.reshape(nb, D, M),
                         recv=brecv.reshape(nb, D, -1), item=bitem.reshape(nb, D, -1), cap=cap)
