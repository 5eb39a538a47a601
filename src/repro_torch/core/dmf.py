"""Decentralized Matrix Factorization, the paper's Algorithm 1 — port of
`src/repro/core/dmf.py` for one device: `DMFConfig` (:55-98), `DMFState`
(:101-105), `init_state` (:114-129), `_grads_and_loss` (:143-153), the
dense oracle `_batch_step` (:156-183), `_step_deltas` (:186-217), the DP
step `_dp_noise_rows` / `_dp_message` / `_step_deltas_dp` (:220-271),
`_sparse_batch_update` (:323-364, :425-435; no churn, Byzantine or
telemetry), `_epoch_scan` (:438-496), `sample_with_negatives` /
`sample_epoch` (:751-777), `train_epoch_dense` (:780-805),
`_as_neighbor_table` / `epoch_dp_inputs` / `train_epoch` (:808-875,
``n_shards == 1``), `scores` / `test_loss` (:878-890), `FitResult`,
`DivergenceError`, `_epoch_finite`, `fit` (:893-1142; without churn,
attacks, checkpoints, telemetry, tracing or sharding) and `evaluate` /
`evaluate_dense` (:1145-1212, ``n_shards == 1``).

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
per-batch losses to the host once per epoch. The step always runs the
fused kernel (the reference's ``use_pallas=True`` path).
"""
from __future__ import annotations

import dataclasses
import logging
import math
import warnings
from typing import Callable

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import graph as graph_lib
from repro_torch.core import metrics as metrics_lib
from repro_torch.core.scatter import scatter_add_rows_
from repro_torch.kernels import ops
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
    dp_clip: float = float("inf")    # C — L2 bound per outgoing gradient message
    dp_sigma: float = 0.0            # σ — noise multiplier relative to C
    dp_seed: int = 0                 # DP mechanism base seed (privacy/mechanism.py)

    def __post_init__(self):
        if self.mode not in ("dmf", "gdmf", "ldmf"):
            raise ValueError(f"mode {self.mode!r} (dmf, gdmf or ldmf)")
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
    rng = rng or np.random.default_rng(cfg.seed)
    I, J, K = cfg.n_users, cfg.n_items, cfg.dim
    U = torch.as_tensor(rng.normal(0, cfg.init_scale, (I, K)).astype(np.float32), device=dev)
    P = torch.zeros((I, J, K), dtype=torch.float32, device=dev)
    Q = torch.zeros((I, J, K), dtype=torch.float32, device=dev)
    return DMFState(U=U, P=P, Q=Q)


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


def _sparse_batch_update(U, P, Q, nbr_idx, nbr_wgt, ui, vj, r, conf,
                         cfg: DMFConfig, valid=None, rid=None, dp_seed: int = 0,
                         noise=None) -> torch.Tensor:
    """One minibatch of Alg. 1 against the sparse neighbor table, in place
    on U/P/Q; returns the batch loss (0-d tensor).

    Line 11 and lines 13-15: sender b's message gp[b] lands on its S
    receivers at item vj[b], weighted by the walk weight (padded slots
    carry weight 0). With DP on, every receiver — the sender's own line-11
    update included — applies only the clipped, noised message. Duplicate
    (receiver, item) pairs are summed by `scatter.scatter_add_rows_`: in
    the same order on every run, in another order than XLA's scatter."""
    if cfg.dp:
        du, gp, dq, loss = _step_deltas_dp(U, P, Q, ui, vj, r, conf, cfg, valid,
                                           noise, rid, dp_seed)
    else:
        du, gp, dq, loss = _step_deltas(U, P, Q, ui, vj, r, conf, cfg, valid)
    scatter_add_rows_(U, (ui,), du)
    if cfg.mode != "gdmf":
        scatter_add_rows_(Q, (ui, vj), dq)
    if cfg.mode != "ldmf":
        nb = nbr_idx[ui]                                   # (B, S) receivers
        upd = nbr_wgt[ui][:, :, None] * gp[:, None, :]     # (B, S, K)
        scatter_add_rows_(P, (nb, vj[:, None].expand_as(nb)), -cfg.lr * upd)
    return loss


def _epoch_scan(U, P, Q, nbr_idx, nbr_wgt, ui, vj, r, conf, dp_seed: int,
                cfg: DMFConfig) -> torch.Tensor:
    """A full epoch over (nb, B) device-resident minibatches, in place on
    U/P/Q; returns the (nb,) per-batch losses, still on the device — the
    loop never waits for the card.

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
    losses = [
        _sparse_batch_update(
            U, P, Q, nbr_idx, nbr_wgt, ui[b], vj[b], r[b], conf[b], cfg,
            rid=None if rid is None else rid[b], dp_seed=dp_seed,
            noise=None if noise is None else noise[b])
        for b in range(nb)]
    if not losses:
        return torch.zeros(0, dtype=torch.float32, device=U.device)
    return torch.stack(losses)


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


def train_epoch(state: DMFState, prop, train: np.ndarray, cfg: DMFConfig,
                rng: np.random.Generator, accountant=None,
                device="cuda") -> tuple[DMFState, float]:
    """One epoch over the sparse neighbor table (``prop``: a
    `graph.NeighborTable`, or a dense (I, I) M, converted per call), in
    place on ``state``, which must lie on ``device``. The rng draws follow
    the reference: the epoch's sample first, then (DP only) its seed.

    ``accountant`` (a `privacy.GaussianAccountant`) observes the epoch's
    realized minibatch stream. Returns the state and float64(Σ per-batch
    fp32 losses) / rows, read from the card once."""
    dev = _require_state_on(state, device, "train_epoch")
    nbr = _as_neighbor_table(prop, dev)
    ui, vj, r, conf = sample_epoch(train, cfg, rng)
    B = cfg.batch_size
    nb = len(ui) // B
    n = nb * B
    _, dp_seed = epoch_dp_inputs(cfg, rng, n)
    if accountant is not None:
        accountant.observe_epoch(ui[:n].reshape(nb, B))
    ui_d, vj_d = (torch.as_tensor(x[:n].reshape(nb, B), dtype=torch.int64, device=dev)
                  for x in (ui, vj))
    r_d, conf_d = (torch.as_tensor(x[:n].reshape(nb, B), device=dev) for x in (r, conf))
    losses = _epoch_scan(state.U, state.P, state.Q, nbr.idx, nbr.wgt,
                         ui_d, vj_d, r_d, conf_d, dp_seed, cfg)
    total = float(losses.cpu().numpy().astype(np.float64).sum())
    return state, total / max(n, 1)


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


class DivergenceError(RuntimeError):
    """Training produced a non-finite loss or factor update
    (``fit(on_nonfinite="raise")``)."""


def _epoch_finite(state: DMFState, loss: float) -> bool:
    """Epoch health check: loss AND factors finite (only paid under
    on_nonfinite="raise" or "halt")."""
    if not np.isfinite(loss):
        return False
    return bool(torch.isfinite(state.U).all() & torch.isfinite(state.P).all()
                & torch.isfinite(state.Q).all())


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
    on_nonfinite: str = "warn",
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

    ``on_nonfinite``: "warn" (default) warns once on a non-finite epoch loss
    and goes on; "raise" raises `DivergenceError`; "halt" stops, returns the
    last finite state (a clone taken before each epoch, since the epoch
    updates in place) and sets `FitResult.diverged_at`."""
    if on_nonfinite not in ("warn", "raise", "halt"):
        raise ValueError(f"on_nonfinite={on_nonfinite!r} (warn, raise or halt)")
    dev = device_lib.resolve(device)
    rng = np.random.default_rng(cfg.seed if seed is None else seed)
    state = init_state(cfg, rng, device=dev)
    accountant = None
    if cfg.dp and cfg.dp_sigma > 0.0:   # ldmf: no releases, no ε claim
        accountant = GaussianAccountant(n_users=cfg.n_users, sigma=cfg.dp_sigma,
                                        delta=dp_delta)
    if dense_reference:
        if isinstance(M, graph_lib.NeighborTable):
            raise ValueError("dense_reference needs the dense M")
        if cfg.dp:
            raise ValueError("dense_reference is the un-noised oracle path")
        prop = _dense_matrix(M, dev)
    else:
        prop = _as_neighbor_table(M, dev)
    logger = logging.getLogger("repro_torch.dmf") if log_every else None
    tr_losses, te_losses = [], []
    diverged_at = None
    warned = False
    for t in range(epochs):
        if on_nonfinite == "halt":
            prev = DMFState(state.U.clone(), state.P.clone(), state.Q.clone())
        if dense_reference:
            state, l = train_epoch_dense(state, prop, train, cfg, rng, device=dev)
        else:
            state, l = train_epoch(state, prop, train, cfg, rng, accountant=accountant,
                                   device=dev)
        tr_losses.append(l)
        if on_nonfinite == "warn":
            if not warned and not np.isfinite(l):
                warnings.warn(
                    f"epoch {t}: non-finite training loss {l!r} — training has "
                    "diverged (see fit(on_nonfinite=...))", RuntimeWarning, stacklevel=2)
                warned = True
        elif not _epoch_finite(state, l):
            if on_nonfinite == "raise":
                raise DivergenceError(f"epoch {t}: non-finite loss or factors (loss={l!r})")
            state = prev             # halt: last finite state wins
            diverged_at = t
            break
        if test is not None:
            te_losses.append(test_loss(state, test))
        if logger is not None and ((t + 1) % log_every == 0 or t == epochs - 1):
            msg = f"epoch {t + 1}/{epochs} train_loss={l:.6f}"
            if test is not None:
                msg += f" test_loss={te_losses[-1]:.6f}"
            if accountant is not None and accountant.eps_trajectory:
                msg += f" eps={accountant.eps_trajectory[-1]:.4f}"
            logger.info(msg)
        if callback is not None:
            callback(t, state, l)
    return FitResult(state, tr_losses, te_losses,
                     privacy=accountant.summary() if accountant else None,
                     diverged_at=diverged_at)


def evaluate(
    state: DMFState, train: np.ndarray, test: np.ndarray, n_users: int, n_items: int,
    ks=(5, 10), chunk_users: int | None = None, device="cuda",
) -> dict[str, float]:
    """P@k / R@k through the per-user top-k kernel
    (`ops.recommend_topk_peruser`, kernel 2): the (I, J) score matrix never
    materializes, and neither does V = P + Q: the kernel reads the P and Q
    rows in place and adds them in registers.

    ``chunk_users`` streams the user axis: each chunk builds only its own
    mask rows and reads its slices of U, P and Q (views, no copy). Hit
    counts are integers reduced in the same global user order, so the
    result is the same floats as unchunked."""
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
