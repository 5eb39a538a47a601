"""Centralized baselines the paper compares against — port of
`src/repro/core/baselines.py:1-150` (`MFConfig`, `MFState`, `init_mf`,
`_mf_step`, `fit_mf`, `BPRConfig`, `_bpr_step`, `fit_bpr`, `mf_scores`,
`evaluate_mf`), plus `mf_state_from_numpy`.

* **MF** (Mnih & Salakhutdinov 2007): centralized least-square latent factor
  model — the same objective as Eq. 1, trained with SGD and the same
  unobserved-rating negative sampling as DMF (identical protocol, so the
  comparison isolates the decentralization).
* **BPR** (Rendle et al. 2009): pairwise-ranking latent factor model,
  trained on (user, positive, sampled-negative) triples with the sigmoid
  pairwise loss.
* **GDMF / LDMF** are the γ→∞ / β→∞ special cases of DMF and live in
  ``core.dmf`` (``mode="gdmf"|"ldmf"``).

The draws are the reference's, from the same `np.random.Generator` in the
same order: U then V, then per epoch the MF sample (`dmf.sample_epoch`), or
BPR's permutation and negatives. Unlike the reference, which donates U/V
to a jitted step, the port updates them in place with
`scatter.scatter_add_rows_` (duplicate rows sum, in the same order on every
run). A whole epoch's batches are uploaded once, the
per-batch losses stay on the device and are read once per epoch, then
summed in float64 in batch order, as the reference's ``tot += float(l)``
sums them with one host read per batch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import metrics as metrics_lib
from repro_torch.core.scatter import scatter_add_rows_
from repro_torch.kernels.ref import fp32_matmul


@dataclasses.dataclass(frozen=True)
class MFConfig:
    n_users: int
    n_items: int
    dim: int = 10
    alpha: float = 0.1      # user regularizer
    beta: float = 0.01      # item regularizer
    lr: float = 0.1
    neg_samples: int = 3
    batch_size: int = 256
    init_scale: float = 0.1
    seed: int = 0


@dataclasses.dataclass
class MFState:
    U: torch.Tensor  # (I, K)
    V: torch.Tensor  # (J, K)


def init_mf(cfg: MFConfig | BPRConfig, rng: np.random.Generator | None = None,
            device="cuda") -> MFState:
    """U then V, drawn with numpy from ``rng`` (so they equal the
    reference's), on ``device``. BPR starts from the same draws."""
    dev = device_lib.resolve(device)
    rng = rng or np.random.default_rng(cfg.seed)
    U, V = (torch.as_tensor(rng.normal(0, cfg.init_scale, (n, cfg.dim)).astype(np.float32),
                            device=dev) for n in (cfg.n_users, cfg.n_items))
    return MFState(U=U, V=V)


def mf_state_from_numpy(U, V, device="cuda") -> MFState:
    """A state from host arrays, e.g. a reference `MFState` carried across
    with ``np.asarray`` on each field."""
    dev = device_lib.resolve(device)
    return MFState(*(torch.as_tensor(np.array(x, np.float32), device=dev) for x in (U, V)))


def _mf_step(U, V, ui, vj, r, conf, cfg: MFConfig) -> torch.Tensor:
    """One MF minibatch, in place on U/V; returns the batch loss (0-d)."""
    u, v = U[ui], V[vj]
    err = conf * (r - (u * v).sum(-1))
    gu = -err[:, None] * v + cfg.alpha * u
    gv = -err[:, None] * u + cfg.beta * v
    loss = 0.5 * (conf * (r - (u * v).sum(-1)) ** 2).sum()
    scatter_add_rows_(U, (ui,), -cfg.lr * gu)
    scatter_add_rows_(V, (vj,), -cfg.lr * gv)
    return loss


def _epoch_mean(losses: list[torch.Tensor], n: int) -> float:
    """float64(Σ per-batch fp32 losses, in batch order) / rows, read from
    the device once."""
    tot = 0.0
    if losses:
        for l in torch.stack(losses).cpu().tolist():
            tot += l
    return tot / max(n, 1)


def _batches(dev, B: int, n: int, *arrays):
    """Each array's first n entries as (n // B, B) tensors on ``dev``."""
    return [torch.as_tensor(x[:n].reshape(n // B, B), device=dev) for x in arrays]


def fit_mf(cfg: MFConfig, train: np.ndarray, epochs: int = 30, seed: int | None = None,
           device="cuda"):
    """Train MF for ``epochs`` on ``device``. Returns (MFState, per-epoch
    mean losses)."""
    from repro_torch.core.dmf import DMFConfig, sample_epoch  # shared sampling protocol

    dev = device_lib.resolve(device)
    rng = np.random.default_rng(cfg.seed if seed is None else seed)
    state = init_mf(cfg, rng, device=dev)
    scfg = DMFConfig(
        n_users=cfg.n_users, n_items=cfg.n_items, dim=cfg.dim,
        neg_samples=cfg.neg_samples, batch_size=cfg.batch_size,
    )
    U, V = state.U, state.V
    losses = []
    B = cfg.batch_size
    for _ in range(epochs):
        ui, vj, r, conf = sample_epoch(train, scfg, rng)
        n = (len(ui) // B) * B
        ui, vj = (x.long() for x in _batches(dev, B, n, ui, vj))
        r, conf = _batches(dev, B, n, r, conf)
        losses.append(_epoch_mean(
            [_mf_step(U, V, ui[b], vj[b], r[b], conf[b], cfg) for b in range(n // B)], n))
    return MFState(U, V), losses


@dataclasses.dataclass(frozen=True)
class BPRConfig:
    n_users: int
    n_items: int
    dim: int = 10
    reg: float = 0.01
    lr: float = 0.05
    batch_size: int = 256
    init_scale: float = 0.1
    seed: int = 0


def _bpr_step(U, V, ui, vp, vn, cfg: BPRConfig) -> torch.Tensor:
    """One BPR minibatch, in place on U/V; returns the batch loss (0-d).
    u, xp and xn are gathered before either V update, and the positive
    and negative scatters land one after the other, as the reference's."""
    u, xp, xn = U[ui], V[vp], V[vn]
    diff = (u * (xp - xn)).sum(-1)
    sig = torch.sigmoid(-diff)              # d(-log σ(diff))/d(diff) = -σ(-diff)
    loss = torch.logaddexp(-diff, torch.zeros_like(diff)).sum()   # jax.nn.softplus
    gu = -sig[:, None] * (xp - xn) + cfg.reg * u
    gp = -sig[:, None] * u + cfg.reg * xp
    gn = sig[:, None] * u + cfg.reg * xn
    scatter_add_rows_(U, (ui,), -cfg.lr * gu)
    scatter_add_rows_(V, (vp,), -cfg.lr * gp)
    scatter_add_rows_(V, (vn,), -cfg.lr * gn)
    return loss


def fit_bpr(cfg: BPRConfig, train: np.ndarray, epochs: int = 30, seed: int | None = None,
            device="cuda"):
    """Train BPR for ``epochs`` on ``device``. Returns (MFState, per-epoch
    mean losses)."""
    dev = device_lib.resolve(device)
    rng = np.random.default_rng(cfg.seed if seed is None else seed)
    state = init_mf(cfg, rng, device=dev)
    U, V = state.U, state.V
    B = cfg.batch_size
    losses = []
    for _ in range(epochs):
        perm = rng.permutation(len(train))
        pos = train[perm]
        neg = rng.integers(0, cfg.n_items, size=len(pos))
        n = (len(pos) // B) * B
        ui, vp, vn = (x.long() for x in _batches(dev, B, n, pos[:, 0], pos[:, 1], neg))
        losses.append(_epoch_mean(
            [_bpr_step(U, V, ui[b], vp[b], vn[b], cfg) for b in range(n // B)], n))
    return MFState(U, V), losses


def mf_scores(state: MFState) -> torch.Tensor:
    """(I, J) scores U @ Vᵀ on the state's device, fp32 (TF32 off)."""
    with fp32_matmul():
        return state.U @ state.V.T


def evaluate_mf(state: MFState, train, test, n_users, n_items, ks=(5, 10),
                device="cuda") -> dict[str, float]:
    """P@k / R@k through the dense (I, J) score matrix, as the reference
    evaluates; ``state`` must lie on ``device``."""
    dev = device_lib.resolve(device)
    if state.U.device != dev:
        raise ValueError(f"evaluate_mf: the state lies on {state.U.device}, not on {dev}")
    sc = mf_scores(state)
    train_mask = metrics_lib.masks_from_interactions(n_users, n_items, train)
    test_mask = metrics_lib.masks_from_interactions(n_users, n_items, test)
    return metrics_lib.evaluate_ranking(sc, train_mask, test_mask, ks)
