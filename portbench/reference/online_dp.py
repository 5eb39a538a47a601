"""Plain reference of the private online check-in round (the cell
``foursquare.ingest_refresh_dp``): `reference/online.py`'s round with the
DP mechanism on every outgoing gradient message, written from the paper
(Alg. 1 lines 9-15, Eqs. 9-11), the mechanism's statement
g̃ = g·min(1, C/‖g‖₂) + N(0, (σC)²I) and the spec of its counter-keyed
noise stream, in NumPy and PyTorch. It imports nothing of the program.

Order of the draws (the deployment's online refresh): a round first draws
one integer in [0, 2^31 - 1) from the deployment's generator and folds it
with the configuration's ``dp_seed`` into the round's mechanism seed,
``(dp_seed·0x9E3779B9 + draw) mod 2^32 & 0x7FFFFFFF``; then each step
draws its negatives and permutation as `reference/online.py` does. Row i
of step s (padded rows counted) is the stream's row
``rid = s·stream_len + i``, ``stream_len`` the step's real rows.

The stream, from its spec: with lowbias32 ``mix(x)`` (x ^= x >> 16; x *=
0x21F0AAAD; x ^= x >> 15; x *= 0x735A2D97; x ^= x >> 15, all mod 2^32),
``s = mix(seed)``, the row's key ``s_row = mix(s ^ ((rid >> 23)·0x9E3779B9
+ 1))``, the counter ``c = (rid mod 2^23)·512 + 2k`` for column k, the
words ``h1 = mix(c ^ s_row)`` and ``h2 = mix((c + 1) ^ (s_row·0x9E3779B9))``,
the 24-bit uniforms ``u1 = ((h1 >> 8) + 1)·2^-24`` in (0, 1] and ``u2 =
(h2 >> 8)·2^-24`` in [0, 1), and one standard normal by Box-Muller, ``z =
sqrt(-2 ln u1)·cos(2π·u2)``.

The mechanism acts on each row's p message (the ∂L/∂p of Eq. 10, before
the learning rate): the row's L2 norm clipped to C, then σC·z added, then
padded rows zeroed again (the noise lands on their zero messages too).
Every receiver of the walk table applies the noised message, the sender's
own line-11 slot among them; U and Q take their gradients unnoised.

Departures from the program's float32, each below the cell's
``factor_gap`` limit: the state, the gradients, the clip (norm, ratio,
scale) and the add are float64; the uniforms are exact in both; the
Box-Muller transform is float64 with 2π in float64, where the program
computes logf, sqrtf and cosf in float32 after rounding 2π and 2π·u2 to
float32 (a draw differs by a few float32 ulps, ~1e-7 of σC). With
``dtype=float32`` and ``tf32`` (the control) the state is float32 and
rounded to TF32 after every batch; the stream is the same float64 draw
cast to the state's dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import dmf as ref_dmf
from portbench.reference import online as ref_online

_GOLDEN = np.uint32(0x9E3779B9)
_M1, _M2 = np.uint32(0x21F0AAAD), np.uint32(0x735A2D97)
_STRIDE = np.uint32(512)           # 2·256 counters a row, whatever K


def _mix(x: np.ndarray) -> np.ndarray:
    """lowbias32 on uint32 arrays (products wrap mod 2^32)."""
    x = x ^ (x >> np.uint32(16))
    x = x * _M1
    x = x ^ (x >> np.uint32(15))
    x = x * _M2
    return x ^ (x >> np.uint32(15))


def mechanism_seed(dp_seed: int, draw: int) -> int:
    """The round's seed: ``draw`` folded with ``dp_seed`` mod 2^32, the top
    bit cleared."""
    with np.errstate(over="ignore"):
        s = np.array([dp_seed % 2 ** 32], np.uint32) * _GOLDEN + np.array([draw], np.uint32)
    return int(s[0] & np.uint32(0x7FFFFFFF))


def stream_words(seed: int, rid: np.ndarray, n_cols: int) -> tuple[np.ndarray, np.ndarray]:
    """The hash words (h1, h2), (N, n_cols) uint32, of the rows ``rid``."""
    with np.errstate(over="ignore"):
        r = np.asarray(rid).astype(np.int64).astype(np.uint32).reshape(-1, 1)
        s = _mix(np.array([seed % 2 ** 32], np.uint32))
        s_row = _mix(s ^ ((r >> np.uint32(23)) * _GOLDEN + np.uint32(1)))
        col = np.arange(n_cols, dtype=np.uint32)[None, :]
        base = (r & np.uint32(0x7FFFFF)) * _STRIDE + np.uint32(2) * col
        h1 = _mix(base ^ s_row)
        h2 = _mix((base + np.uint32(1)) ^ (s_row * _GOLDEN))
    return h1, h2


def stream(seed: int, rid: np.ndarray, n_cols: int) -> np.ndarray:
    """(N, n_cols) float64 standard normals of the rows ``rid``."""
    h1, h2 = stream_words(seed, rid, n_cols)
    u1 = ((h1 >> np.uint32(8)).astype(np.float64) + 1.0) * 2.0 ** -24
    u2 = (h2 >> np.uint32(8)).astype(np.float64) * 2.0 ** -24
    return np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)


class OnlineDPReplay(ref_online.OnlineReplay):
    """`reference/online.py`'s replay with the mechanism (``dp``: ``sigma``
    and ``clip``) keyed by ``dp_seed``. ``n_released`` counts the real
    messages released; ``n_clipped`` those whose norm exceeded C."""

    def __init__(self, *a, dp: dict, dp_seed: int, **kw):
        super().__init__(*a, **kw)
        self.sigma, self.clip, self.dp_seed = float(dp["sigma"]), float(dp["clip"]), dp_seed
        self.seeds: list[int] = []              # each round's mechanism seed
        self.n_released = self.n_clipped = 0

    def round(self, events: np.ndarray) -> np.ndarray:
        on = self.online
        self.seeds.append(mechanism_seed(self.dp_seed, int(self.rng.integers(0, 2 ** 31 - 1))))
        stream_len = len(events) * (1 + on["neg_samples"])
        cap = on["batch_cap"]
        users = torch.zeros(self.U.shape[0], dtype=torch.bool, device=self.device)
        for step in range(on["steps"]):
            rows = ref_online.sample(events, self.P.shape[1], on["neg_samples"], self.rng)
            for b, batch in enumerate(ref_online.padded_batches(*rows, cap)):
                rid = step * stream_len + b * cap + np.arange(cap)
                users |= self._dp_batch(*batch, rid)
        return users.nonzero().flatten().cpu().numpy()

    def _message(self, gp: torch.Tensor, rid: np.ndarray, keep: torch.Tensor) -> torch.Tensor:
        """The released messages of the batch's (B, K) ``gp``: clipped to
        C, noised, padded rows zeroed."""
        norm = gp.norm(dim=1, keepdim=True)
        scale = torch.clamp(self.clip / norm, max=1.0)            # C/0 = inf: scale 1
        z = torch.as_tensor(stream(self.seeds[-1], rid, gp.shape[1]), device=gp.device)
        real = keep[:, 0] > 0
        self.n_released += int(real.sum())
        self.n_clipped += int((real & (norm[:, 0] > self.clip)).sum())
        return (gp * scale + (self.sigma * self.clip) * z.to(gp.dtype)) * keep

    def _dp_batch(self, ui, vj, r, conf, valid, rid) -> torch.Tensor:
        dev, dt, hp = self.device, self.dtype, self.hp
        ui, vj = (torch.as_tensor(x, dtype=torch.int64, device=dev) for x in (ui, vj))
        r, conf, valid = (torch.as_tensor(x, dtype=dt, device=dev) for x in (r, conf, valid))
        th = hp["lr"]
        u, p, q = self.U[ui], self.P[ui, vj], self.Q[ui, vj]
        raw = r - (u * (p + q)).sum(-1)
        err = (conf * raw)[:, None]
        keep = valid[:, None]
        gu = (-err * (p + q) + hp["alpha"] * u) * keep
        gp = self._message((-err * u + hp["beta"] * p) * keep, rid, keep)
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


def replay(U, P, Q, table, hp: dict, online: dict, seed: int, dp: dict, dp_seed: int,
           **kw) -> OnlineDPReplay:
    """A DP replay over the seeded factors with the deployment's generator
    seeded ``seed`` and the mechanism ``dp`` keyed by ``dp_seed`` (``kw``:
    ``dtype``, ``tf32``); TF32 matrix products off."""
    ref_dmf.tf32_off()
    return OnlineDPReplay(U, P, Q, table, hp, online, np.random.default_rng(seed), dp=dp,
                          dp_seed=dp_seed, **kw)
