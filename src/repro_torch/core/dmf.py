"""Decentralized Matrix Factorization, the subset the serving slice runs —
port of `src/repro/core/dmf.py`: `DMFConfig` (:55-98), `DMFState`
(:101-105), `init_state` (:114-129), `_grads_and_loss` (:143-153),
`_step_deltas` (:186-217), the plain branch of `_sparse_batch_update`
(:323-364, :425-435; no DP, churn, Byzantine or telemetry),
`sample_with_negatives` (:751-769) and `test_loss` (:886-890). Training
(`_epoch_scan`, `fit`, `evaluate`) comes with the next slice.

Model (paper Eqs. 5-11): user i holds u_i (K,), a private copy p^i = P[i]
of the common item factors (J, K) and personal factors q^i = Q[i] (J, K);
v^i_j = p^i_j + q^i_j. A rating of item j by user i updates (u_i, p^i_j,
q^i_j) and sends ∂L/∂p^i_j to the user's walk neighbors, who apply it with
their walk weight.

Unlike the reference, which donates the U/P/Q buffers to a jitted step,
`_sparse_batch_update` updates U/P/Q **in place** with
``index_put_(accumulate=True)``: no (I, J, K) copy per batch.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.kernels import ops


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
    dp_clip: float = float("inf")    # C — DP message clip (not ported yet)
    dp_sigma: float = 0.0            # σ — DP noise multiplier (not ported yet)

    def __post_init__(self):
        assert self.mode in ("dmf", "gdmf", "ldmf"), self.mode
        assert self.dp_sigma >= 0.0 and self.dp_clip > 0.0, (self.dp_sigma, self.dp_clip)

    @property
    def dp(self) -> bool:
        """True iff outgoing messages would be clipped/noised. The DP
        mechanism is not ported yet; the paths that would run it raise."""
        if self.mode == "ldmf":
            return False
        return self.dp_sigma > 0.0 or math.isfinite(self.dp_clip)


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


def _grads_and_loss(u, p, q, r, conf, cfg: DMFConfig):
    """The unfused Eqs. 9-11 gradients and batch loss for gathered (B, K)
    factors, as the reference's jnp path computes them. The step itself
    runs the fused kernel (`_step_deltas`); this is its independent check."""
    v = p + q
    raw = r - (u * v).sum(-1)
    err = (conf * raw)[:, None]
    gu = -err * v + cfg.alpha * u
    gp = -err * u + cfg.beta * p
    gq = -err * u + cfg.gamma * q
    loss = 0.5 * (conf * raw * raw).sum()
    return gu, gp, gq, loss


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


def _sparse_batch_update(U, P, Q, nbr_idx, nbr_wgt, ui, vj, r, conf,
                         cfg: DMFConfig, valid=None) -> torch.Tensor:
    """One minibatch of Alg. 1 against the sparse neighbor table, in place
    on U/P/Q; returns the batch loss (0-d tensor).

    Line 11 and lines 13-15: sender b's message gp[b] lands on its S
    receivers at item vj[b], weighted by the walk weight (padded slots
    carry weight 0). Duplicate (receiver, item) pairs are summed by
    ``index_put_(accumulate=True)``, in another order than XLA's scatter."""
    if cfg.dp:
        raise NotImplementedError("the DP mechanism is not ported yet")
    du, gp, dq, loss = _step_deltas(U, P, Q, ui, vj, r, conf, cfg, valid)
    U.index_put_((ui,), du, accumulate=True)
    if cfg.mode != "gdmf":
        Q.index_put_((ui, vj), dq, accumulate=True)
    if cfg.mode != "ldmf":
        nb = nbr_idx[ui]                                   # (B, S) receivers
        upd = nbr_wgt[ui][:, :, None] * gp[:, None, :]     # (B, S, K)
        P.index_put_((nb, vj[:, None].expand_as(nb)), -cfg.lr * upd, accumulate=True)
    return loss


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


def test_loss(state: DMFState, test: np.ndarray) -> float:
    """½·mean (1 − û_i·v^i_j)² over held-out check-ins."""
    ui = torch.as_tensor(test[:, 0], device=state.U.device)
    vj = torch.as_tensor(test[:, 1], device=state.U.device)
    pred = (state.U[ui] * (state.P[ui, vj] + state.Q[ui, vj])).sum(-1)
    return float(0.5 * ((1.0 - pred) ** 2).mean())
