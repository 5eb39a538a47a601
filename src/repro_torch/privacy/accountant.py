"""Rényi-DP accounting for the subsampled Gaussian gradient exchange — a
numpy copy of `src/repro/privacy/accountant.py` (`DEFAULT_ALPHAS`,
`rdp_subsampled_gaussian`, `rdp_to_epsilon`, `sigma_for_epsilon`,
`GaussianAccountant`).

Each minibatch step, a learner's participating message rows are clipped
to C and noised with N(0, (σC)²) before leaving: the subsampled Gaussian
mechanism with rate qᵢ, estimated from the REALIZED minibatch stream. RDP
at integer order α (Wang, Balle & Kasiviswanathan 2019, Poisson sampling):

    ε(α) = log( Σ_{j=0..α} C(α,j) (1-q)^{α-j} q^j · exp(j(j-1)/(2σ²)) ) / (α-1)

composed additively over steps, then ε = min_α [ε_RDP(α) + log(1/δ)/(α-1)].
A participating batch's k simultaneous per-row releases are accounted as
one √k·C-sensitivity release (multiplier σ/√k̄, k̄ the learner's realized
mean rows per participating batch, rounded up to an eighth).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

DEFAULT_ALPHAS = tuple(range(2, 33)) + (40, 48, 64, 96, 128, 192, 256)


def _log_comb(n: int, k: np.ndarray) -> np.ndarray:
    return (math.lgamma(n + 1)
            - np.vectorize(math.lgamma)(k + 1.0)
            - np.vectorize(math.lgamma)(n - k + 1.0))


def rdp_subsampled_gaussian(q, sigma: float, alphas=DEFAULT_ALPHAS) -> np.ndarray:
    """Per-step RDP ε(α) of the q-subsampled Gaussian with noise multiplier
    ``sigma`` at integer orders ``alphas``. ``q`` scalar or (N,) rates in
    [0, 1]; returns (N, len(alphas)) (or (len(alphas),) for scalar q). q=0
    rows cost exactly 0; q=1 rows are the plain Gaussian α/(2σ²)."""
    scalar = np.ndim(q) == 0
    q = np.atleast_1d(np.asarray(q, np.float64))
    assert ((q >= 0) & (q <= 1)).all(), "sampling rates must be in [0, 1]"
    assert sigma > 0, "accounting needs dp_sigma > 0"
    out = np.zeros((len(q), len(alphas)), np.float64)
    full = q >= 1.0
    mid = (q > 0.0) & ~full
    qm = q[mid]
    for a_ix, alpha in enumerate(alphas):
        assert int(alpha) == alpha and alpha >= 2, alpha
        alpha = int(alpha)
        out[full, a_ix] = alpha / (2.0 * sigma * sigma)
        if qm.size:
            j = np.arange(alpha + 1, dtype=np.float64)
            log_terms = (
                _log_comb(alpha, j)[None, :]
                + (alpha - j)[None, :] * np.log1p(-qm)[:, None]
                + j[None, :] * np.log(qm)[:, None]
                + (j * (j - 1) / (2.0 * sigma * sigma))[None, :]
            )
            m = log_terms.max(axis=1, keepdims=True)
            lse = m[:, 0] + np.log(np.exp(log_terms - m).sum(axis=1))
            out[mid, a_ix] = np.maximum(lse, 0.0) / (alpha - 1)
    return out[0] if scalar else out


def rdp_to_epsilon(rdp: np.ndarray, alphas=DEFAULT_ALPHAS,
                   delta: float = 1e-5) -> tuple[np.ndarray, np.ndarray]:
    """(ε, δ)-DP from accumulated RDP: ε = min_α [rdp(α) + log(1/δ)/(α-1)].
    Returns (eps (...,), best alpha (...,)); all-zero rows give ε = 0."""
    rdp = np.asarray(rdp, np.float64)
    alphas = np.asarray(alphas, np.float64)
    cand = rdp + math.log(1.0 / delta) / (alphas - 1.0)
    best = cand.argmin(axis=-1)
    eps = np.where((rdp == 0.0).all(axis=-1), 0.0, cand.min(axis=-1))
    return eps, alphas[best]


def sigma_for_epsilon(eps_target: float, q: float, steps: int,
                      delta: float = 1e-5, alphas=DEFAULT_ALPHAS,
                      lo: float = 0.05, hi: float = 200.0,
                      rows_per_step: float = 1.0) -> float:
    """Smallest noise multiplier σ meeting ε(δ) ≤ eps_target after
    ``steps`` compositions at rate ``q`` with ``rows_per_step`` releases per
    participating step (multiplier σ/√k). Bisection on the monotone ε(σ)."""
    assert eps_target > 0 and steps >= 1 and rows_per_step >= 1

    def eps_at(sigma: float) -> float:
        rdp = steps * rdp_subsampled_gaussian(
            q, sigma / math.sqrt(rows_per_step), alphas)
        return float(rdp_to_epsilon(rdp, alphas, delta)[0])

    if eps_at(hi) > eps_target:
        raise ValueError(
            f"eps_target={eps_target} unreachable even at sigma={hi}")
    if eps_at(lo) <= eps_target:
        return lo
    for _ in range(60):
        mid = math.sqrt(lo * hi)
        if eps_at(mid) > eps_target:
            lo = mid
        else:
            hi = mid
    return hi


@dataclasses.dataclass
class GaussianAccountant:
    """Per-learner RDP ledger across epochs: feed each epoch's realized
    (nb, B) sender-id stream to `observe_epoch`; read ε(δ) with `epsilon()`
    or `summary()`. `dmf.fit` owns one when DP noise is on."""

    n_users: int
    sigma: float
    delta: float = 1e-5
    alphas: tuple = DEFAULT_ALPHAS

    def __post_init__(self):
        self._rdp = np.zeros((self.n_users, len(self.alphas)), np.float64)
        self.messages = np.zeros(self.n_users, np.int64)
        self.epochs = 0
        self.eps_trajectory: list[float] = []

    def observe_epoch(self, ui_batches: np.ndarray, valid=None) -> None:
        """Account one epoch: learner i's rate is (their participating
        batches)/nb, composed over nb steps at multiplier σ/√k̄. ``valid``
        (optional (nb, B) bool) masks rows that did not release."""
        ui = np.asarray(ui_batches)
        assert ui.ndim == 2, ui.shape
        nb = ui.shape[0]
        # unique (batch, user) pair keys: O(stream), not O(batches · users)
        keys = (np.repeat(np.arange(nb, dtype=np.int64), ui.shape[1])
                * self.n_users + ui.reshape(-1))
        if valid is not None:
            keys = keys[np.asarray(valid).reshape(-1).astype(bool)]
        uniq, counts = np.unique(keys, return_counts=True)
        users = (uniq % self.n_users).astype(np.int64)
        msgs = np.bincount(users, weights=counts,
                           minlength=self.n_users).astype(np.int64)
        self.messages += msgs
        part = np.bincount(users, minlength=self.n_users)
        q = np.minimum(part / nb, 1.0)
        kbar = np.ceil(8.0 * msgs / np.maximum(part, 1)) / 8.0  # round up
        for k in np.unique(kbar[part > 0]):
            sel = (kbar == k) & (part > 0)
            self._rdp[sel] += nb * rdp_subsampled_gaussian(
                q[sel], self.sigma / math.sqrt(k), self.alphas)
        self.epochs += 1
        self.eps_trajectory.append(float(self.epsilon()[0].max()))

    def epsilon(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-learner (ε(δ), best α) under the accumulated composition."""
        return rdp_to_epsilon(self._rdp, self.alphas, self.delta)

    def summary(self) -> dict:
        eps, _ = self.epsilon()
        active = self.messages > 0
        return {
            "sigma": float(self.sigma),
            "delta": float(self.delta),
            "epochs": int(self.epochs),
            "eps_max": float(eps.max()) if eps.size else 0.0,
            "eps_median_active": float(np.median(eps[active])) if active.any() else 0.0,
            "messages_total": int(self.messages.sum()),
            "messages_max_per_learner": int(self.messages.max()) if eps.size else 0,
            "eps_trajectory": [round(e, 6) for e in self.eps_trajectory],
        }
