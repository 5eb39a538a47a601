"""Decentralized Matrix Factorization, the paper's Algorithm 1 — port of
`src/repro/core/dmf.py` for one device: `DMFConfig` (:55-98), `DMFState`
(:101-105), `init_state` (:114-129), `_grads_and_loss` (:143-153), the
dense oracle `_batch_step` (:156-183), `_step_deltas` (:186-217), the DP
step `_dp_noise_rows` / `_dp_message` / `_step_deltas_dp` (:220-271),
`_sparse_batch_update_messages` (:274-422, telemetry :334-422 included)
and its thin wrapper `_sparse_batch_update` (:425-435), `_epoch_scan`
(:438-496), the fault-injected epoch `_epoch_scan_churn` /
`train_epoch_churn` (:499-748), `sample_with_negatives` / `sample_epoch`
(:751-777), `train_epoch_dense` (:780-805), `_as_neighbor_table` /
`epoch_dp_inputs` / `train_epoch` (:808-875), `scores` / `test_loss`
(:878-890), `FitResult`, `DivergenceError`, `_epoch_finite`, `fit`
(:893-1142; churn, attacks, defenses, checkpoints, telemetry and the
``fit.epoch`` span included) and `evaluate` / `evaluate_dense`
(:1145-1212). With ``cfg.n_shards > 1`` (:71-79) the epochs, `fit` and
`evaluate(n_shards=)` run learner-sharded, one rank of a
`torch.distributed` group per process (`sharding/dmf.py`).

Model (paper Eqs. 5-11): user i holds u_i (K,), a private copy p^i = P[i]
of the common item factors (J, K) and personal factors q^i = Q[i] (J, K);
v^i_j = p^i_j + q^i_j. A rating of item j by user i updates (u_i, p^i_j,
q^i_j) and sends ∂L/∂p^i_j to the user's walk neighbors, who apply it with
their walk weight. With DP on, that message is clipped to C and noised
with N(0, (σC)²) at the sender (`privacy/mechanism.py`).

Unlike the reference, which donates the U/P/Q buffers to jitted steps and
scans, the port updates U/P/Q **in place** with
`scatter.scatter_add_rows_` (duplicates summed in a fixed order on each
device, so two runs from one seed give the same bits): no (I, J, K) copy
per batch or epoch. The
epoch is a Python loop over minibatches on the device that reads the
per-batch losses to the host once per epoch (with telemetry on, the
epoch's summed reduction vector in the same read). The step always runs the
fused kernel (the reference's ``use_pallas=True`` path).
"""
from __future__ import annotations

import dataclasses
import logging
import math
import time
import warnings
from typing import Callable

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import graph as graph_lib
from repro_torch.core import metrics as metrics_lib
from repro_torch.core.scatter import scatter_add_rows_
from repro_torch.kernels import ops
from repro_torch.obs import trace as trace_lib
from repro_torch.obs.telemetry import TELE_W
from repro_torch.privacy import mechanism
from repro_torch.privacy.accountant import GaussianAccountant


@dataclasses.dataclass(frozen=True)
class DMFConfig:
    n_users: int
    n_items: int
    dim: int = 10                    # K
    alpha: float = 0.1               # user regularizer (paper: 0.1)
    beta: float = 0.01               # global item regularizer
    gamma: float = 0.01              # personal item regularizer
    lr: float = 0.1                  # θ (paper: 0.1)
    neg_samples: int = 3             # m (paper: 3)
    batch_size: int = 256
    mode: str = "dmf"                # dmf | gdmf | ldmf
    init_scale: float = 0.1
    seed: int = 0
    n_shards: int = 1                # learner-group width; >1 = ranks of a process
                                     # group, each holding its rows (sharding/dmf.py)
    dp_clip: float = float("inf")    # C — L2 bound per outgoing gradient message
    dp_sigma: float = 0.0            # σ — noise multiplier relative to C
    dp_seed: int = 0                 # DP mechanism base seed (privacy/mechanism.py)

    def __post_init__(self):
        if self.mode not in ("dmf", "gdmf", "ldmf"):
            raise ValueError(f"mode {self.mode!r} (dmf, gdmf or ldmf)")
        if self.n_shards < 1:
            raise ValueError(f"n_shards={self.n_shards} must be >= 1")
        if not (self.dp_sigma >= 0.0 and self.dp_clip > 0.0):
            raise ValueError(f"dp_sigma={self.dp_sigma} must be >= 0 and "
                             f"dp_clip={self.dp_clip} > 0")
        if self.dp_sigma > 0.0 and not math.isfinite(self.dp_clip):
            raise ValueError("dp_sigma > 0 needs a finite dp_clip: the noise std is σ·C")

    @property
    def dp(self) -> bool:
        """True iff outgoing gradient messages are clipped/noised. False
        for the default σ=0, C=∞ (the un-noised step) and for ``ldmf``,
        which exchanges nothing: no mechanism, no seed draw, no ε claim."""
        if self.mode == "ldmf":
            return False
        return mechanism.dp_enabled(self)


@dataclasses.dataclass
class DMFState:
    U: torch.Tensor   # (I, K)
    P: torch.Tensor   # (I, J, K) per-learner copies of the common factor
    Q: torch.Tensor   # (I, J, K) personal factors


def init_state(cfg: DMFConfig, rng: np.random.Generator | None = None,
               device="cuda") -> DMFState:
    """U random (drawn with numpy, so it equals the reference's); P and Q
    zero, so an item outside a user's neighborhood scores exactly 0."""
    dev = device_lib.resolve(device)
    U = torch.as_tensor(init_user_factors(cfg, rng), device=dev)
    I, J, K = cfg.n_users, cfg.n_items, cfg.dim
    P = torch.zeros((I, J, K), dtype=torch.float32, device=dev)
    Q = torch.zeros((I, J, K), dtype=torch.float32, device=dev)
    return DMFState(U=U, P=P, Q=Q)


def init_user_factors(cfg: DMFConfig, rng: np.random.Generator | None = None) -> np.ndarray:
    """The (I, K) float32 initial U on the host: `init_state`'s one rng
    draw, which a sharded run makes on every rank before keeping its rows."""
    rng = rng or np.random.default_rng(cfg.seed)
    return rng.normal(0, cfg.init_scale, (cfg.n_users, cfg.dim)).astype(np.float32)


def state_from_numpy(U, P, Q, device="cuda") -> DMFState:
    """A state from host arrays, e.g. a reference `DMFState` carried across
    with ``np.asarray`` on each field."""
    dev = device_lib.resolve(device)
    return DMFState(*(torch.as_tensor(np.array(x, np.float32), device=dev)
                      for x in (U, P, Q)))


def _require_state_on(state: DMFState, device, name: str) -> torch.device:
    """The resolved ``device``; raises if the state lies elsewhere (the
    port moves no state quietly)."""
    dev = device_lib.resolve(device)
    if state.U.device != dev:
        raise ValueError(f"{name}: the state lies on {state.U.device}, not on {dev}")
    return dev


def _grads_and_loss(u, p, q, r, conf, cfg: DMFConfig):
    """The unfused Eqs. 9-11 gradients and batch loss for gathered (B, K)
    factors, as the reference's jnp path computes them: the dense oracle's
    step, and the independent check of the fused kernel."""
    v = p + q
    raw = r - (u * v).sum(-1)
    err = (conf * raw)[:, None]
    gu = -err * v + cfg.alpha * u
    gp = -err * u + cfg.beta * p
    gq = -err * u + cfg.gamma * q
    loss = 0.5 * (conf * raw * raw).sum()
    return gu, gp, gq, loss


def _batch_step(U, P, Q, M, ui, vj, r, conf, cfg: DMFConfig) -> torch.Tensor:
    """Dense oracle step, in place: every gradient propagates through the
    full (I, I) walk matrix M (incl. M[i, i] = 1 for the sender's own
    line-11 update), O(I·B·K) per batch. Plain PyTorch, no kernel: it is
    the equivalence oracle of the sparse path. Returns the batch loss."""
    theta = cfg.lr
    gu, gp, gq, loss = _grads_and_loss(U[ui], P[ui, vj], Q[ui, vj], r, conf, cfg)
    scatter_add_rows_(U, (ui,), -theta * gu)
    if cfg.mode != "gdmf":
        scatter_add_rows_(Q, (ui, vj), -theta * gq)
    if cfg.mode != "ldmf":
        I, B = M.shape[0], ui.shape[0]
        upd = M[ui].T[:, :, None] * gp[None, :, :]            # (I, B, K)
        rows = torch.arange(I, device=U.device)[:, None].expand(I, B)
        scatter_add_rows_(P, (rows, vj[None, :].expand(I, B)), -theta * upd)
    return loss


def _step_deltas(U, P, Q, ui, vj, r, conf, cfg: DMFConfig, valid=None):
    """Gather + fused Eqs. 9-11 for one minibatch: the lr-scaled U/Q
    deltas, the raw message gp and the batch loss. ``valid`` (B,) marks
    real rows of a padded batch; the others contribute exactly nothing
    (conf=0 zeroes their error, and the masks here zero the regularizer
    pulls)."""
    du, gp, dq, loss = ops.dmf_fused_step(
        U[ui], P[ui, vj], Q[ui, vj], r, conf,
        theta=cfg.lr, alpha=cfg.alpha, beta=cfg.beta, gamma=cfg.gamma)
    if valid is not None:
        keep = valid.to(du.dtype)[:, None]
        du, gp, dq = du * keep, gp * keep, dq * keep
    return du, gp, dq, loss


def _dp_noise_rows(rid, dp_seed: int, cfg: DMFConfig, k: int):
    """The (len(rid), k) pre-scaled σC Gaussian block of the counter
    stream at the rows' global stream ids (one `ops.gauss_counter`
    launch); None when σ=0 (clip only). The epoch draws its whole block
    with it once, before its minibatch loop."""
    std = mechanism.noise_std(cfg)
    if std == 0.0:
        return None
    return std * ops.gauss_counter(dp_seed, rid, k)


def _dp_message(gp, rid, dp_seed: int, cfg: DMFConfig, valid=None):
    """The DP mechanism over an outgoing message block through the
    standalone mechanism kernel (`ops.dp_clip_noise`, kernel 8): clip each
    row to C and add σC times the stream's draws at the rows' ``rid``,
    generated in the kernel. The reference passes a pre-made noise block
    here; the draws are the same stream. Padded rows are re-masked, because
    noise lands on their zero gradients too."""
    gp = ops.dp_clip_noise(gp, rid, dp_seed, clip=cfg.dp_clip,
                           noise_std=mechanism.noise_std(cfg))
    if valid is not None:
        gp = gp * valid.to(gp.dtype)[:, None]
    return gp


def _step_deltas_dp(U, P, Q, ui, vj, r, conf, cfg: DMFConfig, valid=None,
                    noise=None, rid=None, dp_seed: int = 0):
    """`_step_deltas` with the DP mechanism on the outgoing gp message.

    With a pre-made ``noise`` block (the epoch's rows) the clip and the add
    fold into the fused step (`ops.dmf_fused_step_dp`, kernel 7): one
    kernel per minibatch, as without DP. Without one (the online refresh,
    and σ=0 epochs), the plain fused step runs and the mechanism kernel
    (`_dp_message`, kernel 8) draws the rows' noise from ``rid`` itself."""
    if noise is None:
        if rid is None:
            raise ValueError("a DP step needs the rows' noise block or their stream ids")
        du, gp, dq, loss = _step_deltas(U, P, Q, ui, vj, r, conf, cfg, valid)
        return du, _dp_message(gp, rid, dp_seed, cfg, valid), dq, loss
    du, gp, dq, loss = ops.dmf_fused_step_dp(
        U[ui], P[ui, vj], Q[ui, vj], r, conf, noise,
        theta=cfg.lr, alpha=cfg.alpha, beta=cfg.beta, gamma=cfg.gamma, clip=cfg.dp_clip)
    if valid is not None:
        keep = valid.to(du.dtype)[:, None]
        du, gp, dq = du * keep, gp * keep, dq * keep
    return du, gp, dq, loss


def _sparse_batch_update_messages(U, P, Q, nbr_idx, nbr_wgt, ui, vj, r, conf,
                                  cfg: DMFConfig, valid=None, rid=None, dp_seed: int = 0,
                                  noise=None, recv_gate=None, prop_now=None, byz=None,
                                  amul=None, ashill=None, dirs=None, vjm=None, bkt=None,
                                  byz_cap: int = 0, tele: bool = False):
    """One minibatch of Alg. 1 against the sparse neighbor table, in place
    on U/P/Q; returns the batch loss (0-d tensor) and the (B, K) messages
    as sent (the outbox stream the audit attacks and the delay ring
    buffers).

    Line 11 and lines 13-15: sender b's message gp[b] lands on its S
    receivers at item vj[b], weighted by the walk weight (padded slots
    carry weight 0). With DP on, every receiver — the sender's own line-11
    update included — applies only the clipped, noised message. Duplicate
    (receiver, item) pairs are summed by `scatter.scatter_add_rows_`: in
    the same order on every run, in another order than XLA's scatter.

    Fault gates (robustness/faults.py; both None on the fault-free path):
    ``recv_gate`` (I,) zeroes the weights into offline receivers (their
    messages are lost, their P rows frozen); ``prop_now`` (B,) keeps only
    a straggler row's own line-11 self slot (its neighbour deliveries come
    from the delay ring later). They multiply the weights only where they
    are given, so all-ones gates leave the same bits as no gates.

    Byzantine path (robustness/byzantine.py; ``byz`` a `DefenseConfig`):
    the sender's own line-11 update stays honest; the outgoing copy is
    corrupted per the attack arrays (``amul``/``ashill``/``dirs``/``vjm``),
    screened at the receiver (finite + norm cap, content zeroed) when
    ``byz.screen``, and combined per (receiver, item) bucket by trimmed
    mean or median when ``byz.aggregation != "sum"`` (``bkt`` the
    host-compiled `MessageGroups` arrays of this batch).

    Telemetry (``tele``; obs/telemetry.py): a third return value, the
    (TELE_W,) float32 vector of read-only reductions over this step's
    tensors (squared update norms, released-message mass, scattered
    propagation mass, delivery and screening counts). It writes nothing
    and feeds nothing the scatters read, so U/P/Q get the same bits as
    with ``tele=False``."""
    theta = cfg.lr
    if cfg.dp:
        du, gp, dq, loss = _step_deltas_dp(U, P, Q, ui, vj, r, conf, cfg, valid,
                                           noise, rid, dp_seed)
    else:
        du, gp, dq, loss = _step_deltas(U, P, Q, ui, vj, r, conf, cfg, valid)
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
    nb = nbr_idx[ui]                                       # (B, S) receivers
    wb = nbr_wgt[ui]                                       # (B, S) walk weights
    if byz is None:
        if prop_now is not None:
            # straggler rows (prop_now=0): keep only the self slot now
            selfm = (nb == ui[:, None]).to(wb.dtype)
            wb = wb * torch.maximum(prop_now[:, None], selfm)
        if recv_gate is not None:
            wb = wb * recv_gate[nb]                        # offline receivers get 0
        upd = wb[:, :, None] * gp[:, None, :]              # (B, S, K)
        scatter_add_rows_(P, (nb, vj[:, None].expand_as(nb)), -theta * upd)
        if tele:
            gp2 = (gp * gp).sum(-1)                        # (B,)
            selfm = (nb == ui[:, None]).to(wb.dtype)
            scatter_sq = theta * theta * (gp2 * (wb * wb).sum(1)).sum()
            n_msgs = (wb * (1.0 - selfm) > 0).to(wb.dtype).sum()
            return loss, gp, torch.stack([u_sq, q_sq, gp2.sum(), scatter_sq, n_msgs, z, z])
        return loss, gp
    from repro_torch.robustness import byzantine as byz_lib
    selfm = (nb == ui[:, None]).to(wb.dtype)
    # honest line-11 self update (a padded table may hold the self slot
    # more than once at weight 0 — summing the masked weights is exact)
    w_self = (wb * selfm).sum(dim=1)
    if recv_gate is not None:
        w_self = w_self * recv_gate[ui]
    scatter_add_rows_(P, (ui, vj), -theta * w_self[:, None] * gp)
    gp_sent = gp
    if amul is not None:
        gp_sent = byz_lib.corrupt_messages(gp, amul, ashill, dirs[ui])
    vj_out = vjm if vjm is not None else vj
    wmsg = wb * (1.0 - selfm)
    if prop_now is not None:
        wmsg = wmsg * prop_now[:, None]
    if recv_gate is not None:
        wmsg = wmsg * recv_gate[nb]
    wmsg_pre = wmsg   # pre-screen delivery weights (the telemetry's baseline)
    if byz.screen:
        ok = byz_lib.screen_ok(gp_sent, byz.norm_cap)     # (B,)
        gp_eff = torch.where(ok[:, None] > 0, gp_sent, 0.0)
        wmsg = wmsg * ok[:, None]
        # the screened content is finite: the plain multiply is safe
        upd = wmsg[:, :, None] * gp_eff[:, None, :]
    else:
        # 0·NaN = NaN: a zero-weight slot whose sender bombed must deliver
        # exactly 0, so the weight gates through `where`
        upd = torch.where((wmsg > 0)[:, :, None], wmsg[:, :, None] * gp_sent[:, None, :], 0.0)
    if byz.aggregation == "sum":
        scatter_add_rows_(P, (nb, vj_out[:, None].expand_as(nb)), -theta * upd)
        scat = upd
    else:
        b_id, b_pos, b_recv, b_item = bkt
        K = gp.shape[-1]
        comb = byz_lib.robust_combine(
            upd.reshape(-1, K), (wmsg > 0).to(gp.dtype).reshape(-1), b_id.reshape(-1),
            b_pos.reshape(-1), b_recv.shape[-1], byz_cap, byz)
        scatter_add_rows_(P, (b_recv, b_item), -theta * comb)
        scat = comb
    if tele:
        n_pre = (wmsg_pre > 0).to(wb.dtype).sum()          # attempted deliveries
        n_post = (wmsg > 0).to(wb.dtype).sum()             # survived the screen
        self_sq = ((w_self[:, None] * gp) ** 2).sum()
        scatter_sq = theta * theta * (self_sq + (scat * scat).sum())
        return loss, gp_sent, torch.stack([u_sq, q_sq, (gp_sent * gp_sent).sum(), scatter_sq,
                                           n_pre, n_post, n_pre - n_post])
    return loss, gp_sent


def _sparse_batch_update(U, P, Q, nbr_idx, nbr_wgt, ui, vj, r, conf,
                         cfg: DMFConfig, valid=None, rid=None, dp_seed: int = 0,
                         noise=None, tele: bool = False):
    """`_sparse_batch_update_messages` for the callers that drop the sent
    messages (the training epoch, the online refresh): the batch loss, and
    with ``tele`` its (TELE_W,) reduction vector."""
    out = _sparse_batch_update_messages(U, P, Q, nbr_idx, nbr_wgt, ui, vj, r, conf, cfg,
                                        valid, rid, dp_seed, noise, tele=tele)
    return (out[0], out[2]) if tele else out[0]


def _tele_sum(tvecs: list, device) -> torch.Tensor:
    """The epoch's per-batch reduction vectors summed on the device, in
    batch order (zeros for an empty epoch)."""
    if not tvecs:
        return torch.zeros(TELE_W, dtype=torch.float32, device=device)
    return torch.stack(tvecs).sum(0)


def _epoch_scan(U, P, Q, nbr_idx, nbr_wgt, ui, vj, r, conf, dp_seed: int,
                cfg: DMFConfig, tele: bool = False):
    """A full epoch over (nb, B) device-resident minibatches, in place on
    U/P/Q; returns the (nb,) per-batch losses, still on the device — the
    loop never waits for the card. With ``tele``, also the (TELE_W,) sum
    of the batches' reduction vectors, on the device too.

    DP (``cfg.dp``): the epoch's whole (nb·B, K) noise block is drawn
    before the loop in one `ops.gauss_counter` launch — row b·B+k of the
    stream gets `gauss_counter(dp_seed, b·B+k, :)` — and each batch's slice
    goes into the fused DP step."""
    nb, B = ui.shape
    rid = noise = None
    if cfg.dp:
        K = U.shape[-1]
        rid = torch.arange(nb * B, dtype=torch.int32, device=U.device).reshape(nb, B)
        noise = _dp_noise_rows(rid, dp_seed, cfg, K)
        if noise is not None:
            noise = noise.reshape(nb, B, K)
    losses, tvecs = [], []
    for b in range(nb):
        out = _sparse_batch_update(
            U, P, Q, nbr_idx, nbr_wgt, ui[b], vj[b], r[b], conf[b], cfg,
            rid=None if rid is None else rid[b], dp_seed=dp_seed,
            noise=None if noise is None else noise[b], tele=tele)
        if tele:
            out, tvec = out
            tvecs.append(tvec)
        losses.append(out)
    stacked = (torch.stack(losses) if losses
               else torch.zeros(0, dtype=torch.float32, device=U.device))
    if tele:
        return stacked, _tele_sum(tvecs, U.device)
    return stacked


def sample_with_negatives(
    pos: np.ndarray, n_items: int, m: int, rng: np.random.Generator
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Positives + m sampled unobserved negatives per positive with
    confidence 1/m (paper §Unobserved rating sample), shuffled together.
    numpy, with the reference's draws in the reference's order, so both
    packages see the same event batches."""
    n = len(pos)
    neg_u = np.repeat(pos[:, 0], m)
    neg_j = rng.integers(0, n_items, size=n * m)
    ui = np.concatenate([pos[:, 0], neg_u])
    vj = np.concatenate([pos[:, 1], neg_j])
    r = np.concatenate([np.ones(n, np.float32), np.zeros(n * m, np.float32)])
    conf = np.concatenate(
        [np.ones(n, np.float32), np.full(n * m, 1.0 / m, np.float32)]
    )
    order = rng.permutation(len(ui))
    return ui[order], vj[order], r[order], conf[order]


def sample_epoch(
    train: np.ndarray, cfg: DMFConfig, rng: np.random.Generator
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Shuffled positives + m sampled unobserved negatives with confidence 1/m."""
    pos = train[rng.permutation(len(train))]
    return sample_with_negatives(pos, cfg.n_items, cfg.neg_samples, rng)


def _dense_matrix(M, device) -> torch.Tensor:
    """A dense (I, I) M (numpy or tensor) as fp32 on ``device``; no copy
    when it is there already."""
    if not torch.is_tensor(M):
        M = torch.as_tensor(np.asarray(M, np.float32))
    return M.to(device)


def train_epoch_dense(state: DMFState, M, train: np.ndarray, cfg: DMFConfig,
                      rng: np.random.Generator, device="cuda") -> tuple[DMFState, float]:
    """Oracle epoch: a per-batch loop over the dense (I, I) M with a host
    read per batch, O(I·B·K) per batch — the equivalence oracle of the
    sparse path. Updates ``state`` in place and returns it."""
    dev = _require_state_on(state, device, "train_epoch_dense")
    M = _dense_matrix(M, dev)
    ui, vj, r, conf = sample_epoch(train, cfg, rng)
    B = cfg.batch_size
    n = (len(ui) // B) * B
    total = 0.0
    for s in range(0, n, B):
        batch = (torch.as_tensor(x[s:s + B], device=dev) for x in (ui, vj, r, conf))
        total += float(_batch_step(state.U, state.P, state.Q, M, *batch, cfg))
    return state, total / max(n, 1)


def _as_neighbor_table(prop, device) -> graph_lib.NeighborTable:
    """``prop`` as a neighbor table on ``device``: a `NeighborTable` is
    moved there, a dense (I, I) M is converted."""
    if isinstance(prop, graph_lib.NeighborTable):
        return graph_lib.NeighborTable(prop.idx.to(device), prop.wgt.to(device))
    return graph_lib.neighbor_table_from_dense(np.asarray(prop), device)


def epoch_dp_inputs(cfg: DMFConfig, rng: np.random.Generator, n: int):
    """Per-epoch DP inputs for an n-row stream: the rows' global stream ids
    and the fresh per-epoch seed. DP off: seed 0 and NO rng draw, so the
    un-noised paths' rng stream is unchanged."""
    rid = np.arange(n, dtype=np.int32)
    if not cfg.dp:
        return rid, 0
    return rid, mechanism.epoch_noise_seed(rng, cfg)


def _read_epoch(losses: torch.Tensor, tsum: torch.Tensor | None):
    """The epoch's one host read: float64(Σ per-batch fp32 losses), and
    with telemetry the (TELE_W,) reduction sum copied in the same read."""
    if tsum is None:
        return float(losses.cpu().numpy().astype(np.float64).sum()), None
    host = torch.cat([losses, tsum]).cpu().numpy()
    nb = losses.shape[0]
    return float(host[:nb].astype(np.float64).sum()), host[nb:]


def train_epoch(state: DMFState, prop, train: np.ndarray, cfg: DMFConfig,
                rng: np.random.Generator, accountant=None, device="cuda",
                tele: bool = False):
    """One epoch over the sparse neighbor table (``prop``: a
    `graph.NeighborTable`, or a dense (I, I) M, converted per call), in
    place on ``state``, which must lie on ``device``. The rng draws follow
    the reference: the epoch's sample first, then (DP only) its seed.

    ``accountant`` (a `privacy.GaussianAccountant`) observes the epoch's
    realized minibatch stream. Returns the state and float64(Σ per-batch
    fp32 losses) / rows, read from the card once; with ``tele``, also the
    epoch's (TELE_W,) float32 reduction sum, read in the same copy.

    With ``cfg.n_shards > 1`` this is a rank of a learner group
    (`sharding.dmf.train_epoch_sharded`): ``state`` holds the rank's padded
    rows, the loss is the global one, and ``tele`` gives the (D, TELE_W)
    block of every rank's sums."""
    if cfg.n_shards > 1:
        from repro_torch.sharding import dmf as sharded_dmf
        return sharded_dmf.train_epoch_sharded(state, prop, train, cfg, rng,
                                               accountant=accountant, device=device, tele=tele)
    dev = _require_state_on(state, device, "train_epoch")
    nbr = _as_neighbor_table(prop, dev)
    with trace_lib.span("dmf.sample"):
        ui, vj, r, conf = sample_epoch(train, cfg, rng)
        B = cfg.batch_size
        nb = len(ui) // B
        n = nb * B
        _, dp_seed = epoch_dp_inputs(cfg, rng, n)
        if accountant is not None:
            accountant.observe_epoch(ui[:n].reshape(nb, B))
    with trace_lib.span("dmf.upload"):
        ui_d, vj_d = (torch.as_tensor(x[:n].reshape(nb, B), dtype=torch.int64, device=dev)
                      for x in (ui, vj))
        r_d, conf_d = (torch.as_tensor(x[:n].reshape(nb, B), device=dev) for x in (r, conf))
    with trace_lib.span("dmf.rounds"):
        out = _epoch_scan(state.U, state.P, state.Q, nbr.idx, nbr.wgt,
                          ui_d, vj_d, r_d, conf_d, dp_seed, cfg, tele=tele)
    losses, tsum = out if tele else (out, None)
    with trace_lib.span("dmf.read"):
        total, tstats = _read_epoch(losses, tsum)
    if tele:
        return state, total / max(n, 1), tstats
    return state, total / max(n, 1)


def _deliver_ring(P, nbr_idx, nbr_wgt, recv_gate, ring, cfg: DMFConfig, byz=None,
                  row0: int = 0) -> None:
    """Start-of-epoch delivery of the delay ring's messages due now, in
    place on P: neighbour slots only (the straggler applied its own line-11
    update at release), gated by the receivers' online mask NOW. Under a
    defense a message is screened AT DELIVERY, so a malicious message
    buffered k epochs ago does not dodge the gate by arriving late.
    ``ring`` is ``(gp (L, n, K), ui (L·n,), vj (L·n,), deliver (L·n,))``
    on the device. A rank of a sharded run passes its column of the
    partitioned table (receivers as local rows), its ``recv_gate`` rows and
    its first global row ``row0``."""
    ring_gp, ring_ui, ring_vj, deliver = ring
    gflat = ring_gp.reshape(-1, ring_gp.shape[-1])         # (L·n, K)
    nbd = nbr_idx[ring_ui]                                 # (L·n, S)
    wbd = nbr_wgt[ring_ui]
    selfm = ((nbd + row0) == ring_ui[:, None]).to(wbd.dtype)
    wbd = wbd * (1.0 - selfm) * recv_gate[nbd] * deliver[:, None]
    if byz is not None and byz.screen:
        from repro_torch.robustness import byzantine as byz_lib
        okd = byz_lib.screen_ok(gflat, byz.norm_cap)
        gflat = torch.where(okd[:, None] > 0, gflat, 0.0)
        wbd = wbd * okd[:, None]
        upd = wbd[:, :, None] * gflat[:, None, :]          # screened: finite
    elif byz is not None:
        upd = torch.where((wbd > 0)[:, :, None], wbd[:, :, None] * gflat[:, None, :], 0.0)
    else:
        upd = wbd[:, :, None] * gflat[:, None, :]
    scatter_add_rows_(P, (nbd, ring_vj[:, None].expand_as(nbd)), -cfg.lr * upd)


def _epoch_scan_churn(U, P, Q, nbr_idx, nbr_wgt, ui, vj, r, conf, valid, prop_now,
                      recv_gate, dp_seed: int, cfg: DMFConfig, ring=None, keep_sent=False,
                      byz=None, amul=None, ashill=None, dirs=None, vjm=None, bkt=None,
                      byz_cap: int = 0, tele: bool = False):
    """`_epoch_scan` under a fault schedule, in place on U/P/Q: (1) the
    delay ring's delivery at the epoch's start (`_deliver_ring`, when
    ``ring`` is given); (2) the per-row gates ``valid``/``prop_now``
    (nb, B) and ``recv_gate`` (I,) in every minibatch step; (3) with
    ``keep_sent``, each batch's sent messages written into one
    preallocated (nb, B, K) device tensor, with no host read per batch.
    Returns the (nb,) per-batch losses and that tensor (or None), both on
    the device. Under the trivial schedule every gate multiplies by 1.0,
    so the epoch gives `_epoch_scan`'s bits.

    The Byzantine arguments (``byz`` a `DefenseConfig`; ``amul``/
    ``ashill``/``vjm`` (nb, B), ``dirs`` (I, K), ``bkt`` the four bucket
    arrays with a leading nb axis) go to every step unchanged. With
    ``tele``, a third return value: the (TELE_W,) device sum of the
    batches' reduction vectors (the ring's delivery is not counted, as in
    the reference)."""
    if ring is not None:
        _deliver_ring(P, nbr_idx, nbr_wgt, recv_gate, ring, cfg, byz)
    nb, B = ui.shape
    K = U.shape[-1]
    rid = noise = None
    if cfg.dp:
        rid = torch.arange(nb * B, dtype=torch.int32, device=U.device).reshape(nb, B)
        noise = _dp_noise_rows(rid, dp_seed, cfg, K)
        if noise is not None:
            noise = noise.reshape(nb, B, K)
    sent = torch.empty((nb, B, K), dtype=torch.float32, device=U.device) if keep_sent else None
    losses, tvecs = [], []
    for b in range(nb):
        out = _sparse_batch_update_messages(
            U, P, Q, nbr_idx, nbr_wgt, ui[b], vj[b], r[b], conf[b], cfg, valid=valid[b],
            rid=None if rid is None else rid[b], dp_seed=dp_seed,
            noise=None if noise is None else noise[b], recv_gate=recv_gate,
            prop_now=prop_now[b], byz=byz,
            amul=None if amul is None else amul[b], ashill=None if ashill is None else ashill[b],
            dirs=dirs, vjm=None if vjm is None else vjm[b],
            bkt=None if bkt is None else tuple(x[b] for x in bkt), byz_cap=byz_cap, tele=tele)
        losses.append(out[0])
        if tele:
            tvecs.append(out[2])
        if keep_sent:
            sent[b].copy_(out[1])
    stacked = (torch.stack(losses) if losses
               else torch.zeros(0, dtype=torch.float32, device=U.device))
    if tele:
        return stacked, sent, _tele_sum(tvecs, U.device)
    return stacked, sent


def train_epoch_churn(state: DMFState, prop, train: np.ndarray, cfg: DMFConfig,
                      rng: np.random.Generator, t: int, plan, ring, accountant=None,
                      attack=None, byz=None, device="cuda", tele: bool = False):
    """`train_epoch` under a compiled `ChurnPlan` for epoch ``t``, in place
    on ``state``: the SAME sampled stream (same rng draws, the per-epoch DP
    seed included), offline senders' rows zeroed on the host (conf=0 and
    valid=0: their U/Q rows frozen, nothing released), receivers gated by
    this epoch's online mask, stragglers' neighbour scatters deferred
    through ``ring`` (a `DelayRing` or None), and the accountant observing
    only the REALIZED stream. The loss is normalized by realized rows.

    ``attack`` (a compiled `AttackPlan`) corrupts the outgoing messages at
    the sender boundary and needs ``byz`` (a `DefenseConfig`;
    ``DefenseConfig()`` for an undefended channel), which turns on
    screening / robust aggregation. The ring buffers the SENT messages,
    re-addressed as shill rows are (``vjm``). ``tele`` appends the epoch's
    (TELE_W,) reduction sum, read with the losses, as `train_epoch`
    does. ``cfg.n_shards > 1`` runs `sharding.dmf.train_epoch_churn_sharded`
    on this rank."""
    if cfg.n_shards > 1:
        from repro_torch.sharding import dmf as sharded_dmf
        return sharded_dmf.train_epoch_churn_sharded(
            state, prop, train, cfg, rng, t, plan, ring, accountant=accountant, attack=attack,
            byz=byz, device=device, tele=tele)
    dev = _require_state_on(state, device, "train_epoch_churn")
    if attack is not None and byz is None:
        raise ValueError("an attack needs a DefenseConfig (DefenseConfig() for an "
                         "undefended channel)")
    nbr = _as_neighbor_table(prop, dev)
    ui, vj, r, conf = sample_epoch(train, cfg, rng)
    B = cfg.batch_size
    nb = len(ui) // B
    n = nb * B
    shape = (nb, B)
    ui2 = ui[:n].reshape(shape)
    vj2 = vj[:n].reshape(shape)
    _, dp_seed = epoch_dp_inputs(cfg, rng, n)
    on, sender_on, prop_now, due = plan.epoch_row_masks(t, ui2)
    conf2 = conf[:n].reshape(shape) * sender_on
    if accountant is not None:
        accountant.observe_epoch(ui2, valid=sender_on)

    def up(x, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=dev)

    ring_dev = None
    if ring is not None:
        ring_dev = (ring.gp, up(ring.ui.reshape(-1), torch.int64),
                    up(ring.vj.reshape(-1), torch.int64),
                    up((ring.due.reshape(-1) == t).astype(np.float32)))
    amul = ashill = dirs = None
    vjm = vj2
    if attack is not None:
        amul, ashill, vjm = attack.epoch_row_attack(t, ui2, vj2, sender_on=sender_on)
        dirs = up(attack.dirs)
        amul, ashill = up(amul), up(ashill)
    bkt, byz_cap = None, 0
    if byz is not None and byz.aggregation != "sum":
        from repro_torch.robustness import byzantine as byz_lib
        groups = byz_lib.group_messages(
            ui2, vjm, nbr.idx.cpu().numpy(), nbr.wgt.cpu().numpy(), cfg.n_items,
            sender_gate=sender_on.astype(bool) & prop_now.astype(bool),
            recv_on=on.astype(bool))
        bkt = (up(groups.bucket_id, torch.int64), up(groups.pos, torch.int64),
               up(groups.recv, torch.int64), up(groups.item, torch.int64))
        byz_cap = groups.cap
    out = _epoch_scan_churn(
        state.U, state.P, state.Q, nbr.idx, nbr.wgt, up(ui2, torch.int64),
        up(vj2, torch.int64), up(r[:n].reshape(shape)), up(conf2),
        up(sender_on.astype(np.float32)), up(prop_now.astype(np.float32)),
        up(on.astype(np.float32)), dp_seed, cfg, ring=ring_dev, keep_sent=ring is not None,
        byz=byz, amul=amul, ashill=ashill, dirs=dirs,
        vjm=None if byz is None else up(vjm, torch.int64), bkt=bkt, byz_cap=byz_cap, tele=tele)
    losses, sent = out[:2]
    if ring is not None:
        ring.write(t, sent.reshape(n, -1), ui2, vjm if byz is not None else vj2, due)
    total, tstats = _read_epoch(losses, out[2] if tele else None)
    l = total / max(int(sender_on.sum()), 1)
    if tele:
        return state, l, tstats
    return state, l


def scores(U: torch.Tensor, P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """(I, J) predicted preference û_i·(p^i_j + q^i_j), materialized densely
    for the evaluation oracle."""
    return torch.einsum("ik,ijk->ij", U, P + Q)


def test_loss(state: DMFState, test: np.ndarray) -> float:
    """½·mean (1 − û_i·v^i_j)² over held-out check-ins."""
    ui = torch.as_tensor(test[:, 0], device=state.U.device)
    vj = torch.as_tensor(test[:, 1], device=state.U.device)
    pred = (state.U[ui] * (state.P[ui, vj] + state.Q[ui, vj])).sum(-1)
    return float(0.5 * ((1.0 - pred) ** 2).mean())


@dataclasses.dataclass
class FitResult:
    state: DMFState
    train_losses: list
    test_losses: list
    privacy: dict | None = None     # accountant summary when DP noise is on
    diverged_at: int | None = None  # epoch whose update went non-finite
                                    # (only set under on_nonfinite="halt")
    telemetry: list | None = None   # per-epoch event dicts under
                                    # fit(telemetry=True) (obs/telemetry.py)


class DivergenceError(RuntimeError):
    """Training produced a non-finite loss or factor update
    (``fit(on_nonfinite="raise")``)."""


def _epoch_finite(state: DMFState, loss: float, shards=None) -> bool:
    """Epoch health check: loss AND factors finite (only paid under
    on_nonfinite="raise" or "halt"); a sharded rank asks every rank
    (``shards`` its `ShardPlan`)."""
    if not np.isfinite(loss):
        return False
    if shards is not None:
        from repro_torch.sharding import dmf as sharded_dmf
        return sharded_dmf.all_finite(state, shards)
    return bool(torch.isfinite(state.U).all() & torch.isfinite(state.P).all()
                & torch.isfinite(state.Q).all())


def _fault_plans(cfg: DMFConfig, train: np.ndarray, epochs: int, churn, attack, defense,
                 dense_reference: bool, dev):
    """``fit``'s routing onto the churn epoch: (plan, ring, attack plan,
    defense). ``churn`` a `ChurnConfig` (compiled here) or a `ChurnPlan`;
    ``attack`` an `AttackConfig` or an `AttackPlan` (a trivial one becomes
    None); ``defense`` a `DefenseConfig` (an inactive one becomes None).
    An attack or an active defense without churn runs on the trivial
    all-online plan (bit-exact gates, no ring); an attack without a
    defense runs on ``DefenseConfig()``, the undefended channel."""
    plan = ring = attack_plan = byz = None
    if churn is not None:
        from repro_torch.robustness import faults
        if dense_reference:
            raise ValueError("churn runs the sparse path, not dense_reference")
        plan = (churn.compile(cfg.n_users, epochs)
                if isinstance(churn, faults.ChurnConfig) else churn)
        if plan.n_users != cfg.n_users or plan.n_epochs < epochs:
            raise ValueError(f"the churn plan covers {plan.n_users} users x {plan.n_epochs} "
                             f"epochs, not {cfg.n_users} x {epochs}")
        # the epoch stream's length does not depend on the schedule, so
        # the ring's shape is known up front
        nb = (len(train) * (1 + cfg.neg_samples)) // cfg.batch_size
        ring = faults.DelayRing.create(plan.k_max, nb * cfg.batch_size, cfg.dim, device=dev)
    if attack is not None:
        from repro_torch.robustness import byzantine
        attack_plan = (attack.compile(cfg.n_users, epochs, cfg.dim)
                       if isinstance(attack, byzantine.AttackConfig) else attack)
        if attack_plan.n_users != cfg.n_users or attack_plan.n_epochs < epochs:
            raise ValueError(f"the attack plan covers {attack_plan.n_users} users x "
                             f"{attack_plan.n_epochs} epochs, not {cfg.n_users} x {epochs}")
        if attack_plan.config.target_item >= cfg.n_items:
            raise ValueError(f"target_item {attack_plan.config.target_item} >= "
                             f"n_items {cfg.n_items}")
        if attack_plan.is_trivial():
            attack_plan = None
    if defense is not None and defense.active:
        byz = defense
    if attack_plan is not None and byz is None:
        from repro_torch.robustness.byzantine import DefenseConfig
        byz = DefenseConfig()
    if (attack_plan is not None or byz is not None) and plan is None:
        from repro_torch.robustness import faults
        if dense_reference:
            raise ValueError("attacks and defenses run the sparse path, not dense_reference")
        plan = faults.no_churn(cfg.n_users, epochs)
    return plan, ring, attack_plan, byz


def fit(
    cfg: DMFConfig,
    train: np.ndarray,
    M,
    epochs: int = 30,
    test: np.ndarray | None = None,
    callback: Callable | None = None,
    seed: int | None = None,
    dense_reference: bool = False,
    dp_delta: float = 1e-5,
    churn=None,
    checkpoint_dir=None,
    checkpoint_every: int = 0,
    resume_from=None,
    attack=None,
    defense=None,
    on_nonfinite: str = "warn",
    telemetry: bool = False,
    telemetry_out=None,
    log_every: int = 0,
    device="cuda",
) -> FitResult:
    """Train `epochs` epochs of Alg. 1 on ``device``. `M` may be a dense
    (I, I) propagation matrix or a `graph.NeighborTable`; the sparse path
    is the default, ``dense_reference=True`` runs the dense oracle loop.

    With DP noise on (``cfg.dp`` and σ > 0) a `privacy.GaussianAccountant`
    observes every epoch's realized stream; its ε(``dp_delta``) summary
    lands in `FitResult.privacy`. ``log_every=N`` logs a progress line every
    N epochs to ``logging.getLogger("repro_torch.dmf")``.

    Fault tolerance (robustness/): ``churn`` is a `ChurnConfig` (compiled
    here) or a compiled `ChurnPlan` — epochs then run the fault-injected
    path (offline learners bit-frozen, stragglers' messages delivered
    late). ``checkpoint_dir`` + ``checkpoint_every`` snapshot the FULL loop
    state (factors, rng stream, delay ring, accountant) every N completed
    epochs; ``resume_from`` (a step dir or a checkpoint root) restores one
    onto ``device`` and continues — bit-identical to the uninterrupted
    run, DP included (the counter-keyed noise replays from the restored
    rng stream).

    Byzantine robustness (robustness/byzantine.py): ``attack`` is an
    `AttackConfig` (compiled here) or a compiled `AttackPlan` injecting
    malicious outgoing messages; ``defense`` is a `DefenseConfig` turning
    on receiver-side screening and/or robust aggregation. Either one
    routes epochs through the churn path (the trivial all-online plan when
    ``churn`` is None); both None leave the fault-free epoch untouched.

    Observability (obs/): ``telemetry=True`` (or a ``telemetry_out``
    JSONL path) collects one event dict per epoch — loss, update norms,
    released and scattered message mass, message counts, DP ε so far,
    churn online count, delay-ring occupancy, screening accepts and
    rejects — into `FitResult.telemetry`. The device half is read-only
    reductions summed on the card and read once an epoch with the losses:
    factor trajectories are bit for bit those of a run without it. Each
    epoch runs inside a ``fit.epoch`` span of the global tracer
    (`obs.trace.configure_tracing`, or any torch profiler recording);
    `train_epoch`'s phases are spans inside it: ``dmf.sample`` (the
    sample, the DP seed, the accountant), ``dmf.upload``, ``dmf.rounds``
    (`_epoch_scan`) and ``dmf.read`` (`_read_epoch`).

    Learner sharding (``cfg.n_shards > 1``, `sharding/dmf.py`): this
    process is one rank of an initialised `torch.distributed` group of
    ``n_shards`` ranks (`launch.mesh.spawn_ranks`, or torchrun), and every
    rank calls `fit` with the same inputs; it raises without such a group.
    ``M`` may then also be this rank's `sharding.dmf.ShardPlan`.
    Each rank trains its rows of U, P and Q; the state is all-gathered at
    the end, so every rank returns the same `FitResult` with the full
    unpadded state (``callback`` sees the rank's padded rows). Checkpoints
    hold the unpadded state, written by rank 0, and resume at any shard
    count.

    ``on_nonfinite``: "warn" (default) warns once on a non-finite epoch loss
    and goes on; "raise" raises `DivergenceError`; "halt" stops, returns the
    last finite state (a clone taken before each epoch, since the epoch
    updates in place) and sets `FitResult.diverged_at`."""
    if on_nonfinite not in ("warn", "raise", "halt"):
        raise ValueError(f"on_nonfinite={on_nonfinite!r} (warn, raise or halt)")
    tele_on = bool(telemetry) or telemetry_out is not None
    if tele_on and dense_reference:
        raise ValueError("telemetry rides the sparse epoch, not dense_reference")
    dev = device_lib.resolve(device)
    rng = np.random.default_rng(cfg.seed if seed is None else seed)
    sharded = cfg.n_shards > 1
    if sharded:
        from repro_torch.sharding import dmf as sharded_dmf
        if dense_reference:
            raise ValueError("dense_reference is the single-device oracle (n_shards=1)")
        shards = sharded_dmf._as_plan(M, cfg, dev)      # raises without a process group
        state = sharded_dmf.init_local_state(cfg, rng, shards)
    else:
        state = init_state(cfg, rng, device=dev)
    accountant = None
    if cfg.dp and cfg.dp_sigma > 0.0:   # ldmf: no releases, no ε claim
        accountant = GaussianAccountant(n_users=cfg.n_users, sigma=cfg.dp_sigma,
                                        delta=dp_delta)
    churn_plan, ring, attack_plan, byz = _fault_plans(cfg, train, epochs, churn, attack,
                                                      defense, dense_reference, dev)
    if sharded:
        prop = shards
    elif dense_reference:
        if isinstance(M, graph_lib.NeighborTable):
            raise ValueError("dense_reference needs the dense M")
        if cfg.dp:
            raise ValueError("dense_reference is the un-noised oracle path")
        prop = _dense_matrix(M, dev)
    else:
        prop = _as_neighbor_table(M, dev)
    collector = None
    if tele_on:
        from repro_torch.obs import telemetry as tele_lib
        # every rank records the same events; rank 0 alone writes the stream
        collector = tele_lib.EpochCollector(
            jsonl_path=telemetry_out if not sharded or shards.rank == 0 else None)
    logger = logging.getLogger("repro_torch.dmf") if log_every else None
    tr_losses, te_losses = [], []
    start = 0
    if resume_from is not None:
        from repro_torch.robustness import recovery
        # a sharded rank reads the unpadded snapshot on the host and keeps
        # its rows, so a run may resume at another shard count
        like = DMFState(*(np.empty(0, np.float32),) * 3) if sharded else state
        state, rng, ring, start, tr_losses, te_losses = recovery.load_training(
            resume_from, like_state=like, ring=ring, accountant=accountant, device=dev)
        if sharded:
            state = sharded_dmf.shard_state(state, shards)
    diverged_at = None
    warned = False
    try:
        for t in range(start, epochs):
            if on_nonfinite == "halt":
                prev = DMFState(state.U.clone(), state.P.clone(), state.Q.clone())
            t0 = time.perf_counter() if tele_on else 0.0
            with trace_lib.span("fit.epoch", epoch=t):
                if churn_plan is not None:
                    out = train_epoch_churn(state, prop, train, cfg, rng, t, churn_plan, ring,
                                            accountant=accountant, attack=attack_plan, byz=byz,
                                            device=dev, tele=tele_on)
                elif dense_reference:
                    out = train_epoch_dense(state, prop, train, cfg, rng, device=dev)
                else:
                    out = train_epoch(state, prop, train, cfg, rng, accountant=accountant,
                                      device=dev, tele=tele_on)
            state, l = out[:2]
            tr_losses.append(l)
            if on_nonfinite == "warn":
                if not warned and not np.isfinite(l):
                    warnings.warn(
                        f"epoch {t}: non-finite training loss {l!r} — training has "
                        "diverged (see fit(on_nonfinite=...))", RuntimeWarning, stacklevel=2)
                    warned = True
            elif not _epoch_finite(state, l, shards if sharded else None):
                if on_nonfinite == "raise":
                    raise DivergenceError(f"epoch {t}: non-finite loss or factors (loss={l!r})")
                state = prev             # halt: last finite state wins
                diverged_at = t
                break
            if test is not None:
                te_losses.append(sharded_dmf.test_loss_sharded(state, shards, test) if sharded
                                 else test_loss(state, test))
            if collector is not None:
                collector.record(t, train_loss=l, device_stats=out[2],
                                 test_loss=te_losses[-1] if test is not None else None,
                                 accountant=accountant, plan=churn_plan, ring=ring, byz=byz,
                                 wall_s=time.perf_counter() - t0)
            if logger is not None and ((t + 1) % log_every == 0 or t == epochs - 1):
                msg = f"epoch {t + 1}/{epochs} train_loss={l:.6f}"
                if test is not None:
                    msg += f" test_loss={te_losses[-1]:.6f}"
                if accountant is not None and accountant.eps_trajectory:
                    msg += f" eps={accountant.eps_trajectory[-1]:.4f}"
                logger.info(msg)
            if callback is not None:
                callback(t, state, l)
            if (checkpoint_dir is not None and checkpoint_every > 0
                    and (t + 1) % checkpoint_every == 0):
                from repro_torch.robustness import recovery
                # the unpadded snapshot in the reference's layout, written by
                # rank 0 after the gather; every rank waits for it
                snap = sharded_dmf.unpad_state(state, shards, cfg.n_users) if sharded else state
                if not sharded or shards.rank == 0:
                    recovery.save_training(checkpoint_dir, step=t + 1, state=snap, rng=rng,
                                           ring=ring, accountant=accountant,
                                           train_losses=tr_losses, test_losses=te_losses)
                del snap
                if sharded:
                    shards.group.barrier()
    finally:   # the JSONL stream closes on a raise too
        if collector is not None:
            collector.close()
    if sharded:
        state = sharded_dmf.unpad_state(state, shards, cfg.n_users)
    return FitResult(state, tr_losses, te_losses,
                     privacy=accountant.summary() if accountant else None,
                     diverged_at=diverged_at,
                     telemetry=collector.events if collector else None)


def evaluate(
    state: DMFState, train: np.ndarray, test: np.ndarray, n_users: int, n_items: int,
    ks=(5, 10), chunk_users: int | None = None, n_shards: int = 1, device="cuda",
) -> dict[str, float]:
    """P@k / R@k through the per-user top-k kernel
    (`ops.recommend_topk_peruser`, kernel 2): the (I, J) score matrix never
    materializes, and neither does V = P + Q: the kernel reads the P and Q
    rows in place and adds them in registers.

    ``chunk_users`` streams the user axis: each chunk builds only its own
    mask rows and reads its slices of U, P and Q (views, no copy). Hit
    counts are integers reduced in the same global user order, so the
    result is the same floats as unchunked.

    ``n_shards > 1`` runs on each rank of a learner group over its own
    users' rows of the full ``state`` (`sharding.dmf.evaluate_sharded`):
    the same metrics."""
    if n_shards > 1:
        from repro_torch.sharding import dmf as sharded_dmf
        return sharded_dmf.evaluate_sharded(state, train, test, n_users, n_items, n_shards,
                                            ks=ks, chunk_users=chunk_users, device=device)
    dev = _require_state_on(state, device, "evaluate")
    kmax = max(ks)
    if chunk_users is None:
        train_mask = metrics_lib.masks_from_interactions(n_users, n_items, train)
        test_mask = metrics_lib.masks_from_interactions(n_users, n_items, test)
        _, idx = ops.recommend_topk_peruser(state.U, state.P,
                                            torch.as_tensor(train_mask, device=dev), kmax,
                                            Q=state.Q)
        return metrics_lib.evaluate_ranking_from_topk(idx.cpu().numpy(), test_mask, ks)
    hits: dict[int, list[np.ndarray]] = {k: [] for k in ks}
    n_test_parts: list[np.ndarray] = []
    step = max(int(chunk_users), 1)
    for s in range(0, n_users, step):
        e = min(s + step, n_users)
        tm = metrics_lib.masks_from_interactions_rows(s, e - s, n_items, train)
        ts = metrics_lib.masks_from_interactions_rows(s, e - s, n_items, test)
        _, idx = ops.recommend_topk_peruser(state.U[s:e], state.P[s:e],
                                            torch.as_tensor(tm, device=dev), kmax,
                                            Q=state.Q[s:e])
        rec = idx.cpu().numpy()
        for k in ks:
            hits[k].append(metrics_lib.topk_hits(rec, ts, k))
        n_test_parts.append(ts.sum(axis=1))
    n_test = np.concatenate(n_test_parts) if n_test_parts else np.zeros(0, int)
    out = {}
    for k in ks:
        p, r = metrics_lib.precision_recall_from_hits(
            np.concatenate(hits[k]) if hits[k] else np.zeros(0, int), n_test, k)
        out[f"P@{k}"] = p
        out[f"R@{k}"] = r
    return out


def evaluate_dense(
    state: DMFState, train: np.ndarray, test: np.ndarray, n_users: int, n_items: int,
    ks=(5, 10), device="cuda",
) -> dict[str, float]:
    """Oracle evaluation through the dense (I, J) score matrix."""
    _require_state_on(state, device, "evaluate_dense")
    sc = scores(state.U, state.P, state.Q)
    train_mask = metrics_lib.masks_from_interactions(n_users, n_items, train)
    test_mask = metrics_lib.masks_from_interactions(n_users, n_items, test)
    return metrics_lib.evaluate_ranking(sc, train_mask, test_mask, ks)
