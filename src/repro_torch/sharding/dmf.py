"""Learner-sharded DMF over `torch.distributed`, one rank per process —
port of `src/repro/sharding/dmf.py`: the row layout (`rows_per_shard`,
`shard_row_slices` :61-74), the learner group (`make_learner_mesh` :78),
`unpad_state`/`ShardPlan`/`make_shard_plan` (:110-144; `pad_rows` and
`pad_state` are `local_rows` and `shard_state` here, which take a rank's
rows and pad them in one copy), `shard_batches` (:151-200), `build_outbox` (:206-227),
`_sharded_batch_update` (:230-388), the epochs `_epoch_sharded` /
`_epoch_sharded_churn` / `train_epoch_churn_sharded` / `_as_plan` /
`shard_state` / `train_epoch_sharded` (:391-786) and `evaluate_sharded`
(:792-877).

The reference splits the learner axis of U (I, K), P and Q (I, J, K) and
the neighbour table over the devices of a ``learners`` mesh and runs one
SPMD program. Here a rank is one device of that mesh: a process of a
`torch.distributed` group holding its own ``rows_per_shard`` rows on its
device. Inside the reference's `shard_map` body ``axis_index`` is the
rank; ``lax.all_to_all(x, AXIS, 0, 0)`` on a destination-major (D, …)
tensor is `LearnerGroup.all_to_all` (`all_to_all_single` with equal
splits: on rank ``me``, chunk ``src`` of the output is rank ``src``'s chunk
``me``); ``lax.psum`` is `LearnerGroup.all_reduce`.

Every rank calls `dmf.fit` with the same host inputs (config, ratings,
neighbour table): each samples the same epoch stream from the same
generator, routes it with `shard_batches` (host numpy, identical on every
rank) and keeps only its own column ``[:, rank]``. Only the P-gradient
messages cross ranks, in one `all_to_all` per tensor a minibatch; the
receiving rank scatter-adds ``-θ · w · gp`` into its P rows. Weight-0
slots (receiver on another rank, padded rows, padded table slots) scatter
exactly zero, so a sharded step applies the single-device update mass,
summed in another order (within 1e-5 of the single-device run).

Privacy (the paper's "only gradients ever leave a learner"): the outbox
is a pure function of (gp, the static tables, item ids), built by
`build_outbox`, which never sees ratings, u or q; U and Q rows never leave
their rank.

DP: every rank draws the epoch's whole noise block from the counter
stream (`ops.gauss_counter`, kernel 8a) and gathers its rows by their
global stream id, so a row's noise does not depend on the rank it landed
on. The noise is added before the outbox: no rank holds a peer's raw
gradient.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import device as device_lib
from repro_torch.core import graph as graph_lib
from repro_torch.core import metrics as metrics_lib
from repro_torch.core.scatter import scatter_add_rows_
from repro_torch.kernels import ops


def rows_per_shard(n_users: int, n_shards: int) -> int:
    return -(-n_users // n_shards)


def shard_row_slices(n_rows: int, n_shards: int) -> list[tuple[int, int]]:
    """Contiguous [start, end) unpadded row ranges per shard under the
    ceil-div layout of `rows_per_shard` (the trailing shards may be short
    or empty). The tiled store's row sharding (`serving/store.py`
    `shard_rows`) slices along these, so a request routes to shard
    ``user // rows_per_shard``."""
    rows = rows_per_shard(n_rows, n_shards)
    return [(min(d * rows, n_rows), min((d + 1) * rows, n_rows))
            for d in range(n_shards)]


# ---------------------------------------------------------------------------
# The learner group: rank, size, device, and collectives over (D, ...) tensors
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ExchangeClock:
    """Wall seconds spent inside a group's collectives and their count.
    A group given one brackets each collective with device
    synchronisations, so the epoch it measures runs slower than an
    untimed one."""

    seconds: float = 0.0
    calls: int = 0


# torch >= 2.13 names the flat all-gather `all_gather_single` (and warns on
# the older name, which it keeps; 2.11 has only the older name)
_all_gather_flat = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)


@dataclasses.dataclass(frozen=True)
class LearnerGroup:
    """One rank's view of the learner group — the counterpart of the
    reference's ``learners`` mesh axis. Its collectives run on the default
    process group with tensors on ``device``."""

    rank: int
    size: int
    device: torch.device
    backend: str
    clock: ExchangeClock | None = None

    def _timed(self, op):
        clock = self.clock
        if clock is None:
            return op()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        out = op()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        clock.seconds += time.perf_counter() - t0
        clock.calls += 1
        return out

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """(D, ...) destination-major → (D, ...) source-major."""
        x = x.contiguous()
        out = torch.empty_like(x)
        self._timed(lambda: dist.all_to_all_single(out, x))
        return out

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over ranks, in place; returns ``x``."""
        self._timed(lambda: dist.all_reduce(x, op=dist.ReduceOp.SUM))
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` of every rank stacked along a new leading (D,) axis."""
        flat = x.contiguous().reshape(-1)
        out = torch.empty(self.size * flat.numel(), dtype=x.dtype, device=x.device)
        self._timed(lambda: _all_gather_flat(out, flat))
        return out.view(self.size, *x.shape)

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


def learner_group(n_shards: int, device="cuda", clock: ExchangeClock | None = None
                  ) -> LearnerGroup:
    """This rank's `LearnerGroup`; raises unless an initialised process
    group of exactly ``n_shards`` ranks exists (no rank trains alone).
    ``clock`` times its collectives."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"n_shards={n_shards} needs an initialised torch.distributed process group of "
            f"{n_shards} ranks (repro_torch.launch.mesh.spawn_ranks, or torchrun); none is")
    size = dist.get_world_size()
    if size != n_shards:
        raise RuntimeError(f"n_shards={n_shards} but the process group has {size} ranks")
    dev = device_lib.resolve(device)
    backend = str(dist.get_backend())
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("an nccl process group needs device='cuda'")
    return LearnerGroup(rank=dist.get_rank(), size=size, device=dev, backend=backend,
                        clock=clock)


# ---------------------------------------------------------------------------
# Row layout and the per-run plan
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ShardPlan:
    """Per-run sharding artifacts, built once by `make_shard_plan`: the
    group, the partitioned table on the host, this rank's senders' rows
    of it on the device, and (for the delay ring, built on first use) the
    column of every sender's receivers on this rank."""

    group: LearnerGroup
    part: graph_lib.PartitionedNeighborTable
    idx: torch.Tensor                 # (rows, D, S) int64
    wgt: torch.Tensor                 # (rows, D, S) float32
    _dest: tuple | None = None

    @property
    def n_shards(self) -> int:
        return self.group.size

    @property
    def rank(self) -> int:
        return self.group.rank

    @property
    def device(self) -> torch.device:
        return self.group.device

    @property
    def rows(self) -> int:
        return self.part.rows_per_shard

    @property
    def n_rows_padded(self) -> int:
        return self.rows * self.n_shards

    @property
    def row0(self) -> int:
        """This rank's first global row."""
        return self.rank * self.rows

    def dest_table(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(I_pad, S) receivers on this rank (local rows) and their weights,
        for every sender: the table sharded by destination, which the
        delay ring's delivery reads with no communication."""
        if self._dest is None:
            me = self.rank
            self._dest = tuple(torch.as_tensor(np.ascontiguousarray(x[:, me]), device=self.device)
                               for x in (self.part.idx, self.part.wgt))
        return self._dest


def make_shard_plan(nbr: graph_lib.NeighborTable, cfg, device="cuda",
                    clock: ExchangeClock | None = None) -> ShardPlan:
    """The plan of this rank (pass it to `dmf.fit` as the table to reuse
    it, e.g. with a ``clock`` on its group's collectives)."""
    group = learner_group(cfg.n_shards, device, clock)
    part = graph_lib.partition_neighbor_table(nbr, cfg.n_shards, cfg.n_users)
    lo = group.rank * part.rows_per_shard
    sl = slice(lo, lo + part.rows_per_shard)
    return ShardPlan(group=group, part=part,
                     idx=torch.as_tensor(part.idx[sl], device=group.device),
                     wgt=torch.as_tensor(part.wgt[sl], device=group.device))


def _as_plan(prop, cfg, device) -> ShardPlan:
    if isinstance(prop, ShardPlan):
        if prop.n_shards != cfg.n_shards:
            raise ValueError(f"plan of {prop.n_shards} shards, cfg.n_shards={cfg.n_shards}")
        return prop
    if not isinstance(prop, graph_lib.NeighborTable):
        prop = graph_lib.neighbor_table_from_dense(np.asarray(prop), device="cpu")
    return make_shard_plan(prop, cfg, device)


def local_rows(x, plan: ShardPlan) -> torch.Tensor:
    """This rank's rows of a full (unpadded, I leading) host array or
    tensor, zero-padded to ``plan.rows``, as a new tensor on the plan's
    device."""
    lo = min(plan.row0, x.shape[0])
    hi = min(plan.row0 + plan.rows, x.shape[0])
    part = x[lo:hi]
    if not torch.is_tensor(part):
        part = torch.as_tensor(np.ascontiguousarray(part))
    out = torch.zeros((plan.rows, *part.shape[1:]), dtype=part.dtype, device=plan.device)
    out[:hi - lo].copy_(part)
    return out


def shard_state(state, plan: ShardPlan):
    """This rank's padded rows of a full state (tensors on any device, or
    numpy arrays) — the counterpart of the reference's placement with the
    row sharding."""
    from repro_torch.core import dmf as dmf_lib
    return dmf_lib.DMFState(*(local_rows(x, plan) for x in (state.U, state.P, state.Q)))


def init_local_state(cfg, rng: np.random.Generator, plan: ShardPlan):
    """`dmf.init_state` on this rank: the same host draw of U (so the rng
    stream is the unsharded one), then only this rank's rows; P and Q
    zero."""
    from repro_torch.core import dmf as dmf_lib
    U = local_rows(dmf_lib.init_user_factors(cfg, rng), plan)
    J, K = cfg.n_items, cfg.dim
    zeros = [torch.zeros((plan.rows, J, K), dtype=torch.float32, device=plan.device)
             for _ in range(2)]
    return dmf_lib.DMFState(U, *zeros)


def unpad_state(state, plan: ShardPlan, n_users: int):
    """The full unpadded state on every rank: each factor all-gathered
    along the learner axis and sliced to ``n_users`` rows."""
    from repro_torch.core import dmf as dmf_lib
    g = plan.group
    return dmf_lib.DMFState(*(g.all_gather(x).reshape(-1, *x.shape[1:])[:n_users]
                              for x in (state.U, state.P, state.Q)))


# ---------------------------------------------------------------------------
# Host batch routing
# ---------------------------------------------------------------------------
def shard_batches(ui: np.ndarray, vj: np.ndarray, r: np.ndarray, conf: np.ndarray,
                  n_shards: int, rows: int, cap_multiple: int = 32, extras=()):
    """Route (nb, B) minibatch rows to their user's home shard.

    Returns (ui_local, vj, r, conf, valid, rid), each (nb, n_shards, Bs)
    with Bs the largest per-(batch, shard) row count rounded up to
    ``cap_multiple``. Padded slots carry ui=0, conf=0, valid=0: no-ops in
    the step. Row order inside a shard keeps batch order, so one shard
    reproduces the unsharded stream. ``rid`` is each row's global stream
    position (batch·B + slot), the DP noise key. ``extras``: more (nb, B)
    float arrays (the churn gates) routed the same way with fill 0,
    appended in order."""
    nb, B = ui.shape
    shard = ui // rows
    order = np.argsort(shard, axis=1, kind="stable")
    s_sorted = np.take_along_axis(shard, order, axis=1)
    counts = np.zeros((nb, n_shards), np.int64)
    np.add.at(counts, (np.repeat(np.arange(nb), B), shard.reshape(-1)), 1)
    Bs = int(-(-max(int(counts.max()), 1) // cap_multiple) * cap_multiple)
    start = np.concatenate([np.zeros((nb, 1), np.int64), np.cumsum(counts, axis=1)[:, :-1]],
                           axis=1)
    slot = np.arange(B)[None, :] - np.take_along_axis(start, s_sorted, axis=1)
    batch_ix = np.repeat(np.arange(nb), B)

    def route(x, fill=0):
        out = np.full((nb, n_shards, Bs), fill, x.dtype)
        xs = np.take_along_axis(x, order, axis=1)
        out[batch_ix, s_sorted.reshape(-1), slot.reshape(-1)] = xs.reshape(-1)
        return out

    ui_l = route((ui % rows).astype(np.int32))
    vj_s = route(vj.astype(np.int32))
    r_s = route(r.astype(np.float32))
    conf_s = route(conf.astype(np.float32))
    valid = (np.arange(Bs)[None, None, :] < counts[:, :, None]).astype(np.float32)
    rid = route(np.arange(nb * B, dtype=np.int32).reshape(nb, B))
    return (ui_l, vj_s, r_s, conf_s, valid, rid) + tuple(
        route(np.asarray(x, np.float32)) for x in extras)


# ---------------------------------------------------------------------------
# One minibatch on one rank: local Eqs. 9-11 and the P-gradient exchange
# ---------------------------------------------------------------------------
def build_outbox(gp: torch.Tensor, tbl_idx: torch.Tensor, tbl_wgt: torch.Tensor,
                 vj: torch.Tensor):
    """Fixed-shape per-destination outbox of one minibatch on one rank.

    A pure function of the messages ``gp (B, K)``, the static partitioned
    tables of the batch's senders ``tbl_idx``/``tbl_wgt (B, D, S)`` and the
    item ids ``vj (B,)``: no ratings, confidences, u or q, so "only
    global-factor gradients leave a learner" holds by construction.
    Returns (weights (D, B, S), local receiver rows (D, B, S), gradients
    (D, B, K), items (D, B)), destination-major."""
    D = tbl_idx.shape[1]
    return (tbl_wgt.permute(1, 0, 2), tbl_idx.permute(1, 0, 2),
            gp[None].expand(D, *gp.shape), vj[None].expand(D, *vj.shape))


def _sharded_batch_update(U, P, Q, plan: ShardPlan, ui, vj, r, conf, valid, cfg,
                          rid=None, dp_seed: int = 0, noise=None, prop_now=None,
                          online_local=None, byz=None, amul=None, ashill=None, dirs=None,
                          vjm=None, bkt=None, byz_cap: int = 0, tele: bool = False):
    """One minibatch of Alg. 1 on this rank, in place on its U/P/Q rows:
    the step of `dmf._step_deltas` / `_step_deltas_dp` (kernels 3 / 7, or
    3 + 8 with no noise block), the local U and Q scatters, and the
    cross-rank P exchange (four `all_to_all`, one per outbox tensor).
    Returns the batch loss (0-d) and the messages as released (the churn
    epoch buffers them); with ``tele`` also the (TELE_W,) reduction
    vector, whose message counts are received deliveries (a rank's own
    self slots excluded, so the ranks sum to the single-device count).

    Fault gates (None on the fault-free path): ``prop_now`` (B,) keeps only
    a straggler row's own self slot before the outbox; ``online_local``
    (rows,) zeroes received weights into this rank's offline rows.

    Byzantine path (``byz`` a `DefenseConfig`): the sender's self update
    stays honest and local; outgoing messages are corrupted before the
    outbox, screened on the receiving rank after the exchange, and combined
    per (receiver, item) bucket when ``byz.aggregation != "sum"`` (``bkt``
    this rank's `group_messages_sharded` arrays of the batch)."""
    from repro_torch.core import dmf as dmf_lib
    theta = cfg.lr
    g = plan.group
    me, D = plan.rank, plan.n_shards
    if cfg.dp:
        du, gp, dq, loss = dmf_lib._step_deltas_dp(U, P, Q, ui, vj, r, conf, cfg, valid,
                                                   noise, rid, dp_seed)
    else:
        du, gp, dq, loss = dmf_lib._step_deltas(U, P, Q, ui, vj, r, conf, cfg, valid)
    scatter_add_rows_(U, (ui,), du)
    if cfg.mode != "gdmf":
        scatter_add_rows_(Q, (ui, vj), dq)
    if tele:
        u_sq = (du * du).sum()
        z = torch.zeros_like(u_sq)
        q_sq = (dq * dq).sum() if cfg.mode != "gdmf" else z
    if cfg.mode == "ldmf":
        if tele:   # purely local: nothing released, nothing scattered
            return loss, gp, torch.stack([u_sq, q_sq, z, z, z, z, z])
        return loss, gp
    pi, pw = plan.idx[ui], plan.wgt[ui]                    # (B, D, S)
    shard_ix = torch.arange(D, device=pi.device)

    def self_slots():
        """(B, D, S) 1 where the slot is the sender's own row on this rank."""
        return ((shard_ix[None, :, None] == me) & (pi == ui[:, None, None])).to(pw.dtype)

    if byz is None:
        if prop_now is not None:
            pw = pw * torch.maximum(prop_now[:, None, None], self_slots())
        out_w, out_i, out_g, out_v = build_outbox(gp, pi, pw, vj)
        rw, ri, rg, rv = (g.all_to_all(x) for x in (out_w, out_i, out_g, out_v))
        if online_local is not None:
            rw = rw * online_local[ri]                     # offline receivers get 0
        upd = rw[..., None] * rg[:, :, None, :]            # (D, B, S, K)
        scatter_add_rows_(P, (ri, rv[:, :, None].expand_as(ri)), -theta * upd)
        if tele:
            # received self slots (source rank == me, receiver == sender)
            # are not routed messages
            selfr = ((shard_ix[:, None, None] == me) & (ri == ui[None, :, None])).to(rw.dtype)
            n_msgs = (rw * (1.0 - selfr) > 0).to(rw.dtype).sum()
            gp2r = (rg * rg).sum(-1)                       # (D, B)
            scatter_sq = theta * theta * (gp2r * (rw * rw).sum(-1)).sum()
            return loss, gp, torch.stack([u_sq, q_sq, (gp * gp).sum(), scatter_sq,
                                          n_msgs, z, z])
        return loss, gp
    from repro_torch.robustness import byzantine as byz_lib
    K = gp.shape[-1]
    selfm = self_slots()
    w_self = (pw * selfm).sum(dim=(1, 2))
    if online_local is not None:
        w_self = w_self * online_local[ui]
    scatter_add_rows_(P, (ui, vj), -theta * w_self[:, None] * gp)
    pw_msg = pw * (1.0 - selfm)
    if prop_now is not None:
        pw_msg = pw_msg * prop_now[:, None, None]
    gp_sent = gp
    if amul is not None:
        gp_sent = byz_lib.corrupt_messages(gp, amul, ashill, dirs[ui])
    vj_out = vjm if vjm is not None else vj
    out_w, out_i, out_g, out_v = build_outbox(gp_sent, pi, pw_msg, vj_out)
    rw, ri, rg, rv = (g.all_to_all(x) for x in (out_w, out_i, out_g, out_v))
    if online_local is not None:
        rw = rw * online_local[ri]
    rw_pre = rw   # pre-screen delivery weights (the telemetry's baseline)
    if byz.screen:
        ok = byz_lib.screen_ok(rg, byz.norm_cap)           # (D, B)
        rg = torch.where(ok[..., None] > 0, rg, 0.0)
        rw = rw * ok[:, :, None]
        # the screened content is finite: the plain multiply is safe
        upd = rw[..., None] * rg[:, :, None, :]
    else:
        # 0·NaN = NaN: a zero-weight slot whose sender bombed must deliver
        # exactly 0, so the weight gates through `where`
        upd = torch.where((rw > 0)[..., None], rw[..., None] * rg[:, :, None, :], 0.0)
    if byz.aggregation == "sum":
        scatter_add_rows_(P, (ri, rv[:, :, None].expand_as(ri)), -theta * upd)
        scat = upd
    else:
        b_id, b_pos, b_recv, b_item = bkt
        comb = byz_lib.robust_combine(
            upd.reshape(-1, K), (rw > 0).to(gp.dtype).reshape(-1), b_id.reshape(-1),
            b_pos.reshape(-1), b_recv.shape[-1], byz_cap, byz)
        scatter_add_rows_(P, (b_recv, b_item), -theta * comb)
        scat = comb
    if tele:
        n_pre = (rw_pre > 0).to(pw.dtype).sum()            # attempted deliveries
        n_post = (rw > 0).to(pw.dtype).sum()               # survived the screen
        self_sq = ((w_self[:, None] * gp) ** 2).sum()
        scatter_sq = theta * theta * (self_sq + (scat * scat).sum())
        return loss, gp_sent, torch.stack([u_sq, q_sq, (gp_sent * gp_sent).sum(), scatter_sq,
                                           n_pre, n_post, n_pre - n_post])
    return loss, gp_sent


# ---------------------------------------------------------------------------
# Epochs
# ---------------------------------------------------------------------------
def _epoch_noise(cfg, nb: int, dp_seed: int, rid: torch.Tensor, K: int):
    """This rank's rows of the epoch's (nb·B, K) σC noise block: every rank
    draws the whole block (one `ops.gauss_counter` launch) and gathers its
    routed rows by global stream id ``rid (nb, Bs)``; None when σ = 0."""
    from repro_torch.core import dmf as dmf_lib
    all_rid = torch.arange(nb * cfg.batch_size, dtype=torch.int32,
                           device=rid.device).reshape(-1, 1)
    Z = dmf_lib._dp_noise_rows(all_rid, dp_seed, cfg, K)
    return None if Z is None else Z[rid.long()]


def _epoch_sharded(U, P, Q, plan: ShardPlan, ui, vj, r, conf, valid, rid, dp_seed: int, cfg,
                   tele: bool = False, prop_now=None, online_local=None, byz=None, amul=None,
                   ashill=None, dirs=None, vjm=None, bkt=None, byz_cap: int = 0,
                   keep_sent: bool = False):
    """This rank's epoch over its routed (nb, Bs) minibatches, in place on
    its U/P/Q rows. Returns the (nb,) per-batch losses on the device, the
    (nb, Bs, K) released messages when ``keep_sent`` (else None), and with
    ``tele`` the (TELE_W,) sum of the batches' reduction vectors. The
    fault, attack and bucket arguments (churn epochs) go to every step."""
    from repro_torch.core import dmf as dmf_lib
    nb, Bs = ui.shape
    K = U.shape[-1]
    noise = _epoch_noise(cfg, nb, dp_seed, rid, K) if cfg.dp else None
    sent = torch.empty((nb, Bs, K), dtype=torch.float32, device=U.device) if keep_sent else None

    def at(x, b):
        return None if x is None else x[b]

    losses, tvecs = [], []
    for b in range(nb):
        out = _sharded_batch_update(
            U, P, Q, plan, ui[b], vj[b], r[b], conf[b], valid[b], cfg, rid=rid[b],
            dp_seed=dp_seed, noise=at(noise, b), prop_now=at(prop_now, b),
            online_local=online_local, byz=byz, amul=at(amul, b), ashill=at(ashill, b),
            dirs=dirs, vjm=at(vjm, b), bkt=None if bkt is None else tuple(x[b] for x in bkt),
            byz_cap=byz_cap, tele=tele)
        losses.append(out[0])
        if keep_sent:
            sent[b].copy_(out[1])
        if tele:
            tvecs.append(out[2])
    stacked = (torch.stack(losses) if losses
               else torch.zeros(0, dtype=torch.float32, device=U.device))
    return stacked, sent, (dmf_lib._tele_sum(tvecs, U.device) if tele else None)


def _gather_epoch(plan: ShardPlan, losses: torch.Tensor, tsum: torch.Tensor | None):
    """All ranks' losses and reduction sums in one all-gather and one host
    read: float64(Σ per-(batch, shard) fp32 losses), summed over the
    (nb, D) block in the reference's order, and the (D, TELE_W) block (or
    None)."""
    nb = losses.shape[0]
    mine = losses if tsum is None else torch.cat([losses, tsum])
    host = plan.group.all_gather(mine).cpu().numpy()          # (D, nb [+ TELE_W])
    total = float(np.ascontiguousarray(host[:, :nb].T).astype(np.float64).sum())
    return total, (None if tsum is None else host[:, nb:])


def _upload(plan: ShardPlan, dtype=None):
    """(nb, D, ...) routed host array → this rank's (nb, ...) column on its
    device."""
    me = plan.rank

    def up(x):
        return torch.as_tensor(np.ascontiguousarray(np.asarray(x)[:, me]), dtype=dtype,
                               device=plan.device)
    return up


def _require_local(state, plan: ShardPlan, name: str) -> None:
    if state.U.device != plan.device or state.U.shape[0] != plan.rows:
        raise ValueError(f"{name}: the state must be this rank's {plan.rows} padded rows on "
                         f"{plan.device}, not {tuple(state.U.shape)} on {state.U.device}")


def train_epoch_sharded(state, prop, train: np.ndarray, cfg, rng: np.random.Generator,
                        accountant=None, device="cuda", tele: bool = False):
    """Sharded counterpart of `dmf.train_epoch`, on this rank: the same
    sampled stream (the same rng draws, the epoch's DP seed included),
    routed to home ranks; this rank's minibatches update its rows in place.
    ``state`` holds this rank's padded rows (`shard_state`); ``prop`` a
    `ShardPlan`, or a table or dense M planned here. Returns the state and
    the global loss, the same on every rank; with ``tele`` also the
    (D, TELE_W) block of every rank's reduction sums."""
    from repro_torch.core import dmf as dmf_lib
    plan = _as_plan(prop, cfg, device)
    _require_local(state, plan, "train_epoch_sharded")
    ui, vj, r, conf = dmf_lib.sample_epoch(train, cfg, rng)
    B = cfg.batch_size
    nb = len(ui) // B
    n = nb * B
    shape = (nb, B)
    _, dp_seed = dmf_lib.epoch_dp_inputs(cfg, rng, n)
    if accountant is not None:
        accountant.observe_epoch(ui[:n].reshape(shape))
    ui_l, vj_s, r_s, conf_s, valid, rid = shard_batches(
        ui[:n].reshape(shape), vj[:n].reshape(shape), r[:n].reshape(shape),
        conf[:n].reshape(shape), cfg.n_shards, plan.rows)
    i64, f32, i32 = _upload(plan, torch.int64), _upload(plan), _upload(plan, torch.int32)
    losses, _, tsum = _epoch_sharded(
        state.U, state.P, state.Q, plan, i64(ui_l), i64(vj_s), f32(r_s), f32(conf_s),
        f32(valid), i32(rid), dp_seed, cfg, tele=tele)
    total, tstats = _gather_epoch(plan, losses, tsum)
    if tele:
        return state, total / max(n, 1), tstats
    return state, total / max(n, 1)


def train_epoch_churn_sharded(state, prop, train: np.ndarray, cfg, rng: np.random.Generator,
                              t: int, schedule, ring, accountant=None, attack=None, byz=None,
                              device="cuda", tele: bool = False):
    """Sharded counterpart of `dmf.train_epoch_churn`, on this rank: the
    same sampled stream and fault gates (host, rank-independent), rows and
    gates routed to home ranks. The delay ring is replicated on every rank:
    its written block is the all-reduced global released-message stream
    (each row non-zero on one rank only, so the sum is exact in any
    order), so the ring does not depend on the shard count and a resume
    can change it.

    ``attack``/``byz`` as in the single-device path: the attack is realized
    on the routed stream by global user id, bucket membership compiled per
    destination rank in received-slot order, screening on the receiving
    rank; a ring message is screened at its delivery."""
    from repro_torch.core import dmf as dmf_lib
    if attack is not None and byz is None:
        raise ValueError("an attack needs a DefenseConfig (DefenseConfig() for an "
                         "undefended channel)")
    plan = _as_plan(prop, cfg, device)
    _require_local(state, plan, "train_epoch_churn_sharded")
    dev, D, rows = plan.device, cfg.n_shards, plan.rows
    ui, vj, r, conf = dmf_lib.sample_epoch(train, cfg, rng)
    B = cfg.batch_size
    nb = len(ui) // B
    n = nb * B
    shape = (nb, B)
    ui2 = ui[:n].reshape(shape)
    vj2 = vj[:n].reshape(shape)
    _, dp_seed = dmf_lib.epoch_dp_inputs(cfg, rng, n)
    on, sender_on, prop_now, due = schedule.epoch_row_masks(t, ui2)
    conf2 = conf[:n].reshape(shape) * sender_on
    if accountant is not None:
        accountant.observe_epoch(ui2, valid=sender_on)
    ui_l, vj_s, r_s, conf_s, valid, rid, son_s, pnow_s = shard_batches(
        ui2, vj2, r[:n].reshape(shape), conf2, D, rows, extras=(sender_on, prop_now))
    valid = valid * son_s       # offline senders' routed rows are inert
    online_pad = np.zeros(plan.n_rows_padded, np.float32)
    online_pad[: schedule.n_users] = on
    online_local = torch.as_tensor(online_pad[plan.row0:plan.row0 + rows], device=dev)
    i64, f32, i32 = _upload(plan, torch.int64), _upload(plan), _upload(plan, torch.int32)
    amul = ashill = dirs = vjm = None
    vjm_g = vj2
    if attack is not None:
        # realize the attack on the routed stream by global user id: the same
        # per-(user, epoch) corruption at every shard count; padded slots are
        # forced honest through the routed validity
        gl_ui = (np.arange(D)[None, :, None] * rows + ui_l).astype(np.int64)
        amul_s, ashill_s, vjm_s = attack.epoch_row_attack(t, gl_ui, vj_s, sender_on=(valid > 0))
        # the ring buffers the unsharded stream: the same realization there
        vjm_g = attack.epoch_row_attack(t, ui2, vj2, sender_on=sender_on)[2]
        amul, ashill = f32(amul_s), f32(ashill_s)
        dirs = local_rows(attack.dirs, plan)
    if byz is not None:
        vjm = i64(vjm_s if attack is not None else vj_s)
    bkt, byz_cap = None, 0
    if byz is not None and byz.aggregation != "sum":
        from repro_torch.robustness import byzantine as byz_lib
        groups = byz_lib.group_messages_sharded(
            ui_l, vjm_s if attack is not None else vj_s, valid, plan.part.idx, plan.part.wgt,
            rows, D, cfg.n_items, prop_now=pnow_s, online=online_pad)
        bkt = tuple(i64(x) for x in (groups.bucket_id, groups.pos, groups.recv, groups.item))
        byz_cap = groups.cap
    if ring is not None:
        didx, dwgt = plan.dest_table()
        ring_dev = (ring.gp, torch.as_tensor(ring.ui.reshape(-1), dtype=torch.int64, device=dev),
                    torch.as_tensor(ring.vj.reshape(-1), dtype=torch.int64, device=dev),
                    torch.as_tensor((ring.due.reshape(-1) == t).astype(np.float32), device=dev))
        dmf_lib._deliver_ring(state.P, didx, dwgt, online_local, ring_dev, cfg, byz,
                              row0=plan.row0)
    rid_d = i32(rid)
    losses, sent, tsum = _epoch_sharded(
        state.U, state.P, state.Q, plan, i64(ui_l), i64(vj_s), f32(r_s), f32(conf_s),
        f32(valid), rid_d, dp_seed, cfg, tele=tele, prop_now=f32(pnow_s),
        online_local=online_local, byz=byz, amul=amul, ashill=ashill, dirs=dirs, vjm=vjm,
        bkt=bkt, byz_cap=byz_cap, keep_sent=ring is not None)
    if ring is not None:
        # the global released stream: each rank scatters its rows by global
        # stream id (padded rows add zeros), then one all-reduce
        blk = torch.zeros((n, cfg.dim), dtype=torch.float32, device=dev)
        scatter_add_rows_(blk, (rid_d.reshape(-1).long(),), sent.reshape(-1, cfg.dim))
        ring.write(t, plan.group.all_reduce(blk), ui2, vjm_g if byz is not None else vj2, due)
    total, tstats = _gather_epoch(plan, losses, tsum)
    l = total / max(int(sender_on.sum()), 1)
    if tele:
        return state, l, tstats
    return state, l


# ---------------------------------------------------------------------------
# Sharded reads of a run: test loss, health check, evaluation
# ---------------------------------------------------------------------------
def test_loss_sharded(state, plan: ShardPlan, test: np.ndarray) -> float:
    """`dmf.test_loss` on this rank's rows: each held-out pair's prediction
    on its owner rank, the (n_test,) vector all-reduced (each entry is
    non-zero on one rank only, so exact), the mean as the unsharded one."""
    ui = np.asarray(test[:, 0])
    mine = (ui >= plan.row0) & (ui < plan.row0 + plan.rows)
    dev = plan.device
    pred = torch.zeros(len(test), dtype=torch.float32, device=dev)
    sel = torch.as_tensor(np.nonzero(mine)[0], device=dev)
    u = torch.as_tensor(ui[mine] - plan.row0, device=dev)
    j = torch.as_tensor(np.asarray(test[:, 1])[mine], device=dev)
    pred[sel] = (state.U[u] * (state.P[u, j] + state.Q[u, j])).sum(-1)
    pred = plan.group.all_reduce(pred)
    return float(0.5 * ((1.0 - pred) ** 2).mean())


def all_finite(state, plan: ShardPlan) -> bool:
    """True iff every rank's U, P and Q rows are finite."""
    ok = torch.isfinite(state.U).all() & torch.isfinite(state.P).all() \
        & torch.isfinite(state.Q).all()
    bad = plan.group.all_reduce((~ok).to(torch.float32).reshape(1))
    return bool(bad.item() == 0)


def evaluate_sharded(state, train: np.ndarray, test: np.ndarray, n_users: int, n_items: int,
                     n_shards: int, ks=(5, 10), chunk_users: int | None = None,
                     device="cuda") -> dict[str, float]:
    """`dmf.evaluate` over the learner group: each rank runs kernel 2
    (`ops.recommend_topk_peruser`, reading its rows of P and Q in place) on
    its own users' rows of the full ``state``, with no communication; the
    (rows, k) slates are all-gathered along the learner axis and scored on
    the host as the unsharded ones (per-user hits are integers, so the
    metrics are the same floats). ``chunk_users`` bounds the rows a launch
    reads on each rank."""
    group = learner_group(n_shards, device)
    dev = group.device
    if state.U.device != dev:
        raise ValueError(f"evaluate: the state lies on {state.U.device}, not on {dev}")
    kmax = max(ks)
    rows = rows_per_shard(n_users, n_shards)
    lo = min(group.rank * rows, n_users)
    hi = min(lo + rows, n_users)
    idx = torch.zeros((rows, kmax), dtype=torch.int32, device=dev)
    step = hi - lo if chunk_users is None else max(int(chunk_users), 1)
    for s in range(lo, hi, max(step, 1)):
        e = min(s + step, hi)
        tm = metrics_lib.masks_from_interactions_rows(s, e - s, n_items, train)
        _, got = ops.recommend_topk_peruser(state.U[s:e], state.P[s:e],
                                            torch.as_tensor(tm, device=dev), kmax,
                                            Q=state.Q[s:e])
        idx[s - lo:e - lo] = got
    rec = group.all_gather(idx).reshape(-1, kmax)[:n_users].cpu().numpy()
    test_mask = metrics_lib.masks_from_interactions(n_users, n_items, test)
    return metrics_lib.evaluate_ranking_from_topk(rec, test_mask, ks)
