"""The DP mechanism on the gradient-exchange channel: config surface and
seed/std conventions — a numpy copy of `src/repro/privacy/mechanism.py`
(`dp_enabled`, `noise_std`, `screening_threshold`, `epoch_noise_seed`).

What leaves a learner in Alg. 1 is the global-factor gradient message
∂L/∂p^i_j. The mechanism makes that message differentially private at the
sender, before any routing:

    g̃ = g · min(1, C / ‖g‖₂)  +  N(0, (σC)² I)                 (local DP)

The clip+noise math runs where it executes: the fused DP step kernel
(`ops.dmf_fused_step_dp`, every training minibatch) and the standalone
mechanism kernel (`ops.dp_clip_noise`, every online-refresh batch), both
drawing the one counter-keyed stream `ops.gauss_counter`.

Config surface (`core/dmf.DMFConfig`): ``dp_clip`` C (inf = no clipping),
``dp_sigma`` σ relative to C (0 = no noise), ``dp_seed`` the base seed,
folded with a fresh per-epoch draw so noise never repeats across epochs.
"""
from __future__ import annotations

import math

import numpy as np

_GOLDEN = 0x9E3779B9
_U32 = 1 << 32


def dp_enabled(cfg) -> bool:
    """True iff the config requests any DP processing of the messages."""
    return cfg.dp_sigma > 0.0 or math.isfinite(cfg.dp_clip)


def noise_std(cfg) -> float:
    """Absolute noise std σ·C (0 when σ=0; σ>0 requires finite C —
    enforced by DMFConfig.__post_init__)."""
    if cfg.dp_sigma <= 0.0:
        return 0.0
    return cfg.dp_sigma * cfg.dp_clip


def screening_threshold(cfg, dim: int, reject_prob: float = 1e-6) -> float:
    """Norm cap τ for receiver-side screening, calibrated so honest DP
    releases pass: an honest message is clip_C(g) + N(0, (σC)² I_K), so by
    the Laurent–Massart χ² tail bound with t = ln(1/p)

        τ = C + σC · √(K + 2√(K·t) + 2t)

    rejects an honest message with probability ≤ ``reject_prob``. σ=0 gives
    τ=C exactly; C=∞ (no DP) gives τ=∞."""
    assert 0.0 < reject_prob < 1.0, reject_prob
    if not math.isfinite(cfg.dp_clip):
        return float("inf")
    if cfg.dp_sigma <= 0.0:
        return float(cfg.dp_clip)
    t = math.log(1.0 / reject_prob)
    k = float(dim)
    chi2 = k + 2.0 * math.sqrt(k * t) + 2.0 * t
    return float(cfg.dp_clip + noise_std(cfg) * math.sqrt(chi2))


def epoch_noise_seed(rng: np.random.Generator, cfg) -> int:
    """Per-epoch mechanism seed: a fresh rng draw folded with ``dp_seed``.

    A training epoch draws it AFTER its minibatch sampling; an online
    refresh draws it BEFORE sampling its negatives (the reference's orders).
    Noise re-used across epochs would cancel in update differences and
    leak; the fresh draw gives a new stream every epoch. DP-off paths never
    call this, so their rng stream is unchanged."""
    draw = int(rng.integers(0, 2**31 - 1))
    return int((cfg.dp_seed * _GOLDEN + draw) % _U32) & 0x7FFFFFFF
