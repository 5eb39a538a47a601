"""Deterministic fault injection: learner churn + stale gradient exchange —
port of `src/repro/robustness/faults.py:49-219` (`ChurnConfig`,
`no_churn`, `ChurnPlan`, `DelayRing`).

Real learners are phones: they drop out, straggle and join mid-training.
A `ChurnConfig` compiles ahead of the run, from its OWN seed, into a
fixed-shape `ChurnPlan` (an (epochs, I) participation mask and an (I,)
delay class), host numpy with the reference's draws in the reference's
order — so a plan equals the reference's, and the training rng stream is
never touched (a no-churn plan leaves the fault-free run bit-exact).

Fault semantics (the reference's contract):

* An offline learner is bit-frozen: its rows send nothing (its ratings are
  masked out of the epoch) and receive nothing (scatter weights into
  offline receivers are zeroed). Messages to an offline learner are LOST,
  not queued.
* A straggler's own line-11 update applies at once; only its neighbour
  deliveries lag, through the `DelayRing`: messages released in epoch t
  with delay k are applied at the START of epoch t+k, gated by the
  receivers' online mask then.
* The ring buffers messages AFTER the DP mechanism, so staleness does not
  touch the privacy contract.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as device_lib


@dataclasses.dataclass(frozen=True)
class ChurnConfig:
    """Schedule parameters. `compile(n_users, epochs)` realizes them into a
    `ChurnPlan`; the draw order (sessions → dropout → late join → delay
    classes) is fixed, so a seed fully determines the plan."""

    dropout: float = 0.0            # per-epoch Bernoulli offline probability
    session_alpha: float = 0.0      # >0: Pareto tail index of session lengths
    session_scale: float = 4.0      # min online-session length (epochs)
    offline_scale: float = 1.0      # min offline-gap length (epochs)
    late_frac: float = 0.0          # fraction of learners joining mid-run
    late_by: float = 0.5            # joins land uniformly in [1, late_by·T]
    delay_classes: tuple = (0,)     # straggler classes (epochs of staleness)
    delay_probs: tuple | None = None  # class probabilities (default uniform)
    seed: int = 0

    def __post_init__(self):
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"dropout={self.dropout} must be in [0, 1)")
        if not 0.0 <= self.late_frac <= 1.0:
            raise ValueError(f"late_frac={self.late_frac} must be in [0, 1]")
        if not all(int(d) == d and d >= 0 for d in self.delay_classes):
            raise ValueError(f"delay_classes={self.delay_classes} must be integers >= 0")
        if self.delay_probs is not None and len(self.delay_probs) != len(self.delay_classes):
            raise ValueError("delay_probs needs one probability per delay class")

    def compile(self, n_users: int, epochs: int) -> "ChurnPlan":
        rng = np.random.default_rng(self.seed)
        online = np.ones((epochs, n_users), dtype=bool)
        # 1. power-law sessions: alternate online/offline runs per learner
        if self.session_alpha > 0:
            for i in range(n_users):
                t, up = 0, bool(rng.random() < 0.8)   # most start online
                while t < epochs:
                    scale = self.session_scale if up else self.offline_scale
                    length = int(np.ceil(scale * (1.0 + rng.pareto(self.session_alpha))))
                    if not up:
                        online[t: t + length, i] = False
                    t += length
                    up = not up
        # 2. i.i.d. per-epoch dropout on top of the session process
        if self.dropout > 0:
            online &= rng.random((epochs, n_users)) >= self.dropout
        # 3. late joiners: offline (and stateless) before their join epoch
        n_late = int(round(self.late_frac * n_users))
        join = np.zeros(n_users, np.int32)
        if n_late > 0:
            late_users = rng.choice(n_users, size=n_late, replace=False)
            hi = max(2, int(round(self.late_by * epochs)))
            join[late_users] = rng.integers(1, hi + 1, size=n_late)
            for u in late_users:
                online[: join[u], u] = False
        # 4. straggler delay classes
        classes = np.asarray(self.delay_classes, np.int32)
        probs = (None if self.delay_probs is None
                 else np.asarray(self.delay_probs, np.float64))
        delay = rng.choice(classes, size=n_users, p=probs).astype(np.int32)
        return ChurnPlan(online=online, delay=delay, join_epoch=join, config=self)


def no_churn(n_users: int, epochs: int) -> "ChurnPlan":
    """The trivial plan: everyone online every epoch, zero staleness. The
    churn epoch under it is bit-exact with the fault-free epoch."""
    return ChurnConfig().compile(n_users, epochs)


@dataclasses.dataclass(frozen=True)
class ChurnPlan:
    """A compiled schedule: pure data, safe to hash/ship/replay."""

    online: np.ndarray       # (epochs, I) bool — participation mask
    delay: np.ndarray        # (I,) int32 — per-learner staleness class
    join_epoch: np.ndarray   # (I,) int32 — 0 for from-the-start learners
    config: ChurnConfig | None = None

    @property
    def n_epochs(self) -> int:
        return int(self.online.shape[0])

    @property
    def n_users(self) -> int:
        return int(self.online.shape[1])

    @property
    def k_max(self) -> int:
        """Ring depth: the largest staleness any learner's messages carry."""
        return int(self.delay.max()) if self.delay.size else 0

    @property
    def participation_rate(self) -> float:
        return float(self.online.mean()) if self.online.size else 1.0

    def is_trivial(self) -> bool:
        return bool(self.online.all()) and self.k_max == 0

    def epoch_row_masks(self, t: int, ui: np.ndarray):
        """Per-row fault gates for epoch ``t`` of a sampled (nb, B) sender
        stream ``ui``: ``on`` (I,) this epoch's online mask; ``sender_on``
        the row's sender is online (False: the row is inert, its U/Q rows
        frozen); ``prop_now`` sender online AND delay class 0 (the full
        neighbour scatter happens now; stragglers scatter only their own
        line-11 self slot); ``due`` the delivery epoch of the row's
        buffered message (t + delay for online stragglers, -1 = never)."""
        if not 0 <= t < self.n_epochs:
            raise ValueError(f"epoch {t} outside the plan's {self.n_epochs} epochs")
        on = self.online[t]
        sender_on = on[ui]
        d = self.delay[ui]
        prop_now = sender_on & (d == 0)
        due = np.where(sender_on & (d > 0), t + d, -1).astype(np.int32)
        return on, sender_on, prop_now, due


@dataclasses.dataclass
class DelayRing:
    """Fixed-shape stale-message buffer, carried across epochs by `fit`.

    Slot ``t % slots`` holds ALL of epoch t's released messages (one row
    per stream position — ``gp`` the post-DP content on the device,
    ``ui``/``vj``/``due`` its addressing on the host). Every delay class is
    ≤ ``slots``, so a slot overwritten at epoch t was written at t - slots
    and all its rows had due ≤ t — already delivered: the ring is
    collision-free by construction. Delivery each epoch scans all slots
    with a ``due == t`` mask: exact, fixed-shape, one scatter."""

    gp: torch.Tensor  # (slots, n, K) float32 — released message content
    ui: np.ndarray    # (slots, n) int32 — global sender ids
    vj: np.ndarray    # (slots, n) int32 — item ids
    due: np.ndarray   # (slots, n) int32 — delivery epoch, -1 = empty

    @classmethod
    def create(cls, k_max: int, n: int, dim: int, device="cuda") -> "DelayRing | None":
        """Ring for staleness ≤ k_max over an n-row epoch stream; None when
        k_max == 0 (no stragglers: no buffer, no extra work)."""
        if k_max <= 0:
            return None
        return cls(
            gp=torch.zeros((k_max, n, dim), dtype=torch.float32,
                           device=device_lib.resolve(device)),
            ui=np.zeros((k_max, n), np.int32),
            vj=np.zeros((k_max, n), np.int32),
            due=np.full((k_max, n), -1, np.int32),
        )

    @property
    def slots(self) -> int:
        return int(self.ui.shape[0])

    def write(self, t: int, gp_new: torch.Tensor, ui: np.ndarray, vj: np.ndarray,
              due: np.ndarray) -> None:
        """Record epoch t's released messages into its ring slot (called
        AFTER the epoch delivered everything due at t).

        ``gp`` is written in place: the epoch's reads of the slot were
        queued before this copy on the same stream. The host arrays are
        copied, never written in place, as the reference does: on the CPU
        `torch.as_tensor` hands the epoch a view of them, not a copy."""
        s = t % self.slots
        self.gp[s].copy_(gp_new.reshape(self.gp.shape[1:]))
        for name, new in (("ui", ui), ("vj", vj), ("due", due)):
            arr = getattr(self, name).copy()
            arr[s] = np.asarray(new).reshape(-1)
            setattr(self, name, arr)
