"""Plain reference of the online check-in round (the cell
``foursquare.ingest_refresh``), written from the paper (Alg. 1 lines
9-15, Eqs. 9-11) and the repository's documented online refresh
(`OnlineConfig`: ``batch_cap``, ``steps``, ``neg_samples``), in PyTorch
and NumPy. It imports nothing of the program and takes nothing the
program made: the factors it starts from are drawn again from the seed,
the walk table is `reference/dmf.py`'s, and the negatives are drawn again
from a generator seeded as the deployment's.

A round takes its new check-ins ``steps`` times. Each time the check-ins
are followed by m negatives of their sender (POI uniform over all POIs, r
= 0, confidence 1/m), drawn in one call, and all rows are shuffled
together by one permutation; they go in batches of ``batch_cap`` rows, the
last padded with rows that carry nothing. Each row of a batch reads (u_i,
p^i_j, q^i_j) as the batch found them; u_i and q^i_j take -θ times their
gradient (Eqs. 9, 11) and every receiver k of i's walk table takes -θ
M[i, k] times the p gradient (Eq. 10, lines 11-15), duplicates summed.

Precision: the state and the arithmetic are float64 (``dtype``), from
the float32 factors as served; TF32 matrix products stay off. The control
replays in float32 with the state rounded to TF32 after every batch
(``tf32``). The replay also records which entries it changed since the
seeded state, and which users a round changed, for the check.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import dmf as ref_dmf


def sample(events: np.ndarray, n_items: int, m: int, rng: np.random.Generator):
    """One step's rows: the check-ins, then m negatives of each (their
    POIs in one draw), shuffled together by one permutation. Returns (ui,
    vj, r, conf) host arrays."""
    n = len(events)
    users = events[:, 0].astype(np.int64)
    neg_j = rng.integers(0, n_items, size=n * m)
    ui = np.concatenate([users, np.repeat(users, m)])
    vj = np.concatenate([events[:, 1].astype(np.int64), neg_j])
    r = np.concatenate([np.ones(n), np.zeros(n * m)])
    conf = np.concatenate([np.ones(n), np.full(n * m, 1.0 / m)])
    order = rng.permutation(len(ui))
    return ui[order], vj[order], r[order], conf[order]


def padded_batches(ui, vj, r, conf, cap: int):
    """The rows in batches of ``cap``: (ui, vj, r, conf, valid) host
    arrays, the last batch padded with rows of user 0, POI 0, r = conf =
    0 and valid 0."""
    for s in range(0, len(ui), cap):
        b = min(s + cap, len(ui)) - s
        pad = cap - b
        yield (np.pad(ui[s:s + b], (0, pad)), np.pad(vj[s:s + b], (0, pad)),
               np.pad(r[s:s + b], (0, pad)), np.pad(conf[s:s + b], (0, pad)),
               (np.arange(cap) < b).astype(np.float64))


class OnlineReplay:
    """The deployment's rounds replayed from the seeded served factors
    (U (I, K), P and Q (I, J, K), on their device), the walk table (idx,
    wgt) of `reference/dmf.py`, the model's hyperparameters ``hp``, the
    online settings ``online`` and the generator ``rng`` seeded as the
    deployment's. ``u_changed`` (I,), ``q_changed`` and ``p_changed`` (I,
    J) mark the entries any round so far changed."""

    def __init__(self, U, P, Q, table, hp: dict, online: dict, rng: np.random.Generator,
                 dtype=torch.float64, tf32: bool = False):
        self.hp, self.online, self.rng, self.dtype, self.tf32 = hp, online, rng, dtype, tf32
        self.U, self.P, self.Q = (x.to(dtype, copy=True) for x in (U, P, Q))
        self._round_state()
        self.idx, self.wgt = table[0], table[1].to(dtype)
        I, J = P.shape[:2]
        self.device = U.device
        self.u_changed = torch.zeros(I, dtype=torch.bool, device=self.device)
        self.q_changed = torch.zeros((I, J), dtype=torch.bool, device=self.device)
        self.p_changed = torch.zeros((I, J), dtype=torch.bool, device=self.device)

    def round(self, events: np.ndarray) -> np.ndarray:
        """One round over ``events`` (n, 2) (user, POI); returns the users
        whose factors it changed (ascending)."""
        on = self.online
        users = torch.zeros(self.U.shape[0], dtype=torch.bool, device=self.device)
        for _ in range(on["steps"]):
            rows = sample(events, self.P.shape[1], on["neg_samples"], self.rng)
            for batch in padded_batches(*rows, on["batch_cap"]):
                users |= self._batch(*batch)
        return users.nonzero().flatten().cpu().numpy()

    def _batch(self, ui, vj, r, conf, valid) -> torch.Tensor:
        dev, dt, hp = self.device, self.dtype, self.hp
        ui, vj = (torch.as_tensor(x, dtype=torch.int64, device=dev) for x in (ui, vj))
        r, conf, valid = (torch.as_tensor(x, dtype=dt, device=dev) for x in (r, conf, valid))
        th = hp["lr"]
        u, p, q = self.U[ui], self.P[ui, vj], self.Q[ui, vj]
        raw = r - (u * (p + q)).sum(-1)
        err = (conf * raw)[:, None]
        keep = valid[:, None]
        gu = (-err * (p + q) + hp["alpha"] * u) * keep
        gp = (-err * u + hp["beta"] * p) * keep
        gq = (-err * u + hp["gamma"] * q) * keep
        self.U.index_put_((ui,), -th * gu, accumulate=True)
        self.Q.index_put_((ui, vj), -th * gq, accumulate=True)
        recv = self.idx[ui]                                       # (B, S)
        w = self.wgt[ui] * keep                                   # (B, S)
        msg = -th * w[:, :, None] * gp[:, None, :]                 # (B, S, K)
        self.P.index_put_((recv, vj[:, None].expand_as(recv)), msg, accumulate=True)
        real = valid > 0
        self.u_changed[ui[real]] = True
        self.q_changed[ui[real], vj[real]] = True
        live = w > 0
        self.p_changed[recv[live], vj[:, None].expand_as(recv)[live]] = True
        users = torch.zeros(self.U.shape[0], dtype=torch.bool, device=dev)
        users[ui[real]] = True
        users[recv[live]] = True
        self._round_state()
        return users

    def _round_state(self) -> None:
        """With ``tf32`` (a float32 replay, the control), the state rounded
        to TF32's 10 explicit mantissa bits, as a state kept in the
        nearest precision below float32 would be."""
        if self.tf32:
            for x in (self.U, self.P, self.Q):
                x.copy_(ref_dmf._tf32(x))


def replay(U, P, Q, table, hp: dict, online: dict, seed: int, **kw) -> OnlineReplay:
    """A replay over the seeded factors with the deployment's generator
    seeded ``seed`` (``kw``: ``dtype``, ``tf32``); TF32 matrix products
    off."""
    ref_dmf.tf32_off()
    return OnlineReplay(U, P, Q, table, hp, online, np.random.default_rng(seed), **kw)
