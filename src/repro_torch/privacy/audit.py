"""Empirical leakage audit of the gradient-exchange channel — port of
`src/repro/privacy/audit.py:45-234` (`MessageLog`, `observe_messages`,
`_auc`, `_advantage`, `rating_reconstruction_attack`,
`membership_inference_attack`, `run_audit`, `screening_report`).

Threat model: an honest-but-curious neighbour observing the outbox stream
— tuples ``(sender i, item j, message g̃ = DP(∂L/∂p^i_j))`` — exactly what
`dmf._sparse_batch_update_messages` ships. Two attacks, host numpy as in
the reference:

* **Rating reconstruction** — early in training the raw message is
  ≈ −conf·r·u, so its magnitude tracks the rating. The attacker scores
  each message by its norm and by its projection on the sender's top
  right-singular vector, and separates r=1 check-ins from r=0 negatives.
* **Membership inference** — candidate (user, item) pairs scored by the
  largest observed message norm for the pair.

Reported as advantage = 2·AUC − 1: ≈ 1 with DP off, falling toward 0 as
the mechanism's noise grows.

Message capture replays the training path: same sampling stream, same
step, same counter-keyed noise. Each batch runs the port's
`_sparse_batch_update_messages` with the rows' stream ids and the epoch's
seed, so with DP on the message goes through the mechanism kernel (clip +
noise drawn by row id, kernel 8), as the DP online refresh does; the sent
messages are read to the host once per epoch.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import dmf


@dataclasses.dataclass
class MessageLog:
    """The observed outbox stream: one row per sent gradient message."""

    sender: np.ndarray    # (N,) int sender learner ids
    item: np.ndarray      # (N,) int item ids
    rating: np.ndarray    # (N,) float ground-truth r (attacker target, NOT observed)
    conf: np.ndarray      # (N,) float confidence (ground truth, NOT observed)
    gp: np.ndarray        # (N, K) the messages as shipped (post-DP)


def observe_messages(cfg: dmf.DMFConfig, train: np.ndarray, nbr, epochs: int = 1,
                     seed: int | None = None, device="cuda") -> MessageLog:
    """Run ``epochs`` of the sparse training path from a fresh init on
    ``device``, recording every gradient message as it leaves its sender
    (post-mechanism when ``cfg.dp``). Same rng protocol as `dmf.fit`, so
    the captured stream is what training would ship."""
    if cfg.mode == "ldmf":
        raise ValueError("ldmf exchanges nothing — nothing to audit")
    dev = device_lib.resolve(device)
    nbr = dmf._as_neighbor_table(nbr, dev)
    rng = np.random.default_rng(cfg.seed if seed is None else seed)
    state = dmf.init_state(cfg, rng, device=dev)
    B, K = cfg.batch_size, cfg.dim
    snd, itm, rat, cnf, msgs = [], [], [], [], []
    for _ in range(epochs):
        ui, vj, r, conf = dmf.sample_epoch(train, cfg, rng)
        nb = len(ui) // B
        n = nb * B
        rid, dp_seed = dmf.epoch_dp_inputs(cfg, rng, n)
        ui_d, vj_d = (torch.as_tensor(x[:n].reshape(nb, B), dtype=torch.int64, device=dev)
                      for x in (ui, vj))
        r_d, conf_d = (torch.as_tensor(x[:n].reshape(nb, B), device=dev) for x in (r, conf))
        rid_d = torch.as_tensor(rid.reshape(nb, B), device=dev)
        sent = torch.empty((nb, B, K), dtype=torch.float32, device=dev)
        for b in range(nb):
            _, gp = dmf._sparse_batch_update_messages(
                state.U, state.P, state.Q, nbr.idx, nbr.wgt, ui_d[b], vj_d[b], r_d[b],
                conf_d[b], cfg, rid=rid_d[b], dp_seed=dp_seed)
            sent[b].copy_(gp)
        snd.append(ui[:n])
        itm.append(vj[:n])
        rat.append(r[:n])
        cnf.append(conf[:n])
        msgs.append(sent.reshape(n, K).cpu().numpy())
    return MessageLog(sender=np.concatenate(snd), item=np.concatenate(itm),
                      rating=np.concatenate(rat), conf=np.concatenate(cnf),
                      gp=np.concatenate(msgs))


def _auc(pos: np.ndarray, neg: np.ndarray) -> float:
    """Rank-based AUC = P(score⁺ > score⁻) + ½·P(=), tie-averaged."""
    if len(pos) == 0 or len(neg) == 0:
        return 0.5
    s = np.concatenate([pos, neg]).astype(np.float64)
    _, inv, counts = np.unique(s, return_inverse=True, return_counts=True)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    ranks = (starts + (counts + 1) / 2.0)[inv]          # 1-based avg ranks
    u = ranks[: len(pos)].sum() - len(pos) * (len(pos) + 1) / 2.0
    return float(u / (len(pos) * len(neg)))


def _advantage(auc: float) -> float:
    return max(0.0, 2.0 * auc - 1.0)


def rating_reconstruction_attack(log: MessageLog) -> dict:
    """Distinguish real check-ins (r=1) from negative samples (r=0) in the
    observed stream. Two scorers: the message norm, and the
    gradient-inversion projection |g̃·ŵᵢ| with ŵᵢ the top right-singular
    vector of sender i's observed message matrix."""
    norms = np.linalg.norm(log.gp, axis=1)
    pos = log.rating > 0.5
    norm_auc = _auc(norms[pos], norms[~pos])

    proj = norms.copy()        # senders with a single message keep the norm
    for s in np.unique(log.sender):
        rows = np.nonzero(log.sender == s)[0]
        if len(rows) >= 2:
            G = log.gp[rows]
            # top right-singular vector = attacker's estimate of u_s
            _, _, vt = np.linalg.svd(G, full_matrices=False)
            proj[rows] = np.abs(G @ vt[0])
    inv_auc = _auc(proj[pos], proj[~pos])
    return {
        "rating_norm_auc": norm_auc,
        "rating_norm_advantage": _advantage(norm_auc),
        "rating_inversion_auc": inv_auc,
        "rating_inversion_advantage": _advantage(inv_auc),
    }


def membership_inference_attack(log: MessageLog, train: np.ndarray, n_users: int,
                                n_items: int, rng: np.random.Generator | None = None,
                                n_pairs: int = 2000) -> dict:
    """Score candidate (user, item) pairs by the largest observed message
    norm for the pair; members = train pairs, non-members = uniformly
    sampled unrated pairs. Unobserved pairs score 0."""
    rng = rng or np.random.default_rng(0)
    train = np.asarray(train)
    rated = set(map(tuple, train[:, :2].tolist()))
    key = log.sender.astype(np.int64) * n_items + log.item.astype(np.int64)
    norms = np.linalg.norm(log.gp, axis=1)
    best: dict[int, float] = {}
    for k, v in zip(key, norms):
        k = int(k)
        if v > best.get(k, 0.0):
            best[k] = float(v)

    m = min(n_pairs, len(train))
    members = train[rng.choice(len(train), m, replace=False), :2]
    non = []
    while len(non) < m:
        i = int(rng.integers(0, n_users))
        j = int(rng.integers(0, n_items))
        if (i, j) not in rated:
            non.append((i, j))
    non = np.asarray(non)

    def score(pairs):
        return np.asarray([best.get(int(i) * n_items + int(j), 0.0) for i, j in pairs])

    auc = _auc(score(members), score(non))
    return {"membership_auc": auc, "membership_advantage": _advantage(auc)}


def run_audit(cfg: dmf.DMFConfig, train: np.ndarray, nbr, n_users: int, n_items: int,
              epochs: int = 1, seed: int = 0, n_pairs: int = 2000, device="cuda") -> dict:
    """Capture the outbox stream for ``epochs`` on ``device`` and run both
    attacks. Returns the attack-advantage report for this config's (C, σ)."""
    log = observe_messages(cfg, train, nbr, epochs=epochs, seed=seed, device=device)
    out = {
        # None (not inf) for the no-clip case: the report is JSON-bound
        "dp_clip": float(cfg.dp_clip) if math.isfinite(cfg.dp_clip) else None,
        "dp_sigma": float(cfg.dp_sigma),
        "n_messages": int(len(log.sender)),
    }
    out.update(rating_reconstruction_attack(log))
    out.update(membership_inference_attack(
        log, train, n_users, n_items, rng=np.random.default_rng(seed + 1), n_pairs=n_pairs))
    return out


def screening_report(log: MessageLog, norm_cap: float, reject_prob: float | None = None) -> dict:
    """Privacy-side view of Byzantine receiver screening
    (robustness/byzantine.py): replay the accept gate over an observed
    HONEST stream and report its utility price (honest messages falsely
    rejected) and the 1-bit side channel of the accept bit (its AUC as a
    rating classifier). The accept bit is post-processing of the released
    message, so it costs no extra ε."""
    norms = np.linalg.norm(log.gp, axis=1)
    finite = np.isfinite(log.gp).all(axis=1)
    ok = finite & (norms <= norm_cap)
    pos = log.rating > 0.5
    auc = _auc(ok[pos].astype(np.float64), ok[~pos].astype(np.float64))
    out = {
        "norm_cap": float(norm_cap) if np.isfinite(norm_cap) else None,
        "n_messages": int(len(norms)),
        "pass_rate": float(ok.mean()) if len(norms) else 1.0,
        "reject_rate": float(1.0 - ok.mean()) if len(norms) else 0.0,
        "norm_p50": float(np.quantile(norms, 0.5)) if len(norms) else 0.0,
        "norm_p99": float(np.quantile(norms, 0.99)) if len(norms) else 0.0,
        "norm_max": float(norms.max()) if len(norms) else 0.0,
        "accept_bit_rating_auc": auc,
        "accept_bit_rating_advantage": _advantage(auc),
    }
    if reject_prob is not None:
        out["calibrated_reject_prob"] = float(reject_prob)
    return out
