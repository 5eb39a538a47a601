"""Token data pipeline for the LM training examples — port of
`src/repro/data/lm_pipeline.py` (all of it: `LMDataConfig`, `SyntheticLM`
with `batch` and `unigram_entropy`).

No external corpora offline, so the pipeline generates a *structured*
synthetic language (Zipfian unigrams + Markov bigram structure + copy
motifs) — enough signal for a ~100M model's loss to drop well below the
unigram entropy, which is what the end-to-end example asserts.

numpy, as the reference is: the same ``default_rng(seed)`` tables and the
same ``default_rng((seed, step))`` draws in the same order, so every batch
equals the reference's bit for bit (int32 tokens and labels; with
codebooks, the stacked ``(tokens + q) % vocab`` of each codebook q).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab_size: int = 8192
    seq_len: int = 512
    batch_size: int = 8
    markov_order: float = 0.9    # prob of following the bigram chain
    n_states: int = 16           # latent chain states
    seed: int = 0


class SyntheticLM:
    """Deterministic per-seed stream of (tokens, labels) batches."""

    def __init__(self, cfg: LMDataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V, S = cfg.vocab_size, cfg.n_states
        # Zipfian emission per latent state over a state-specific vocab slice
        self.state_next = rng.integers(0, S, size=(S, 4))      # sparse chain
        probs = 1.0 / np.arange(1, 65) ** 1.8
        self.emit_probs = probs / probs.sum()
        self.emit_vocab = rng.integers(0, V, size=(S, 64))

    def batch(self, step: int, n_codebooks: int = 0) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, L = cfg.batch_size, cfg.seq_len + 1
        state = rng.integers(0, cfg.n_states, size=B)
        toks = np.empty((B, L), np.int32)
        for t in range(L):
            emit_idx = rng.choice(64, size=B, p=self.emit_probs)
            toks[:, t] = self.emit_vocab[state, emit_idx]
            follow = rng.random(B) < cfg.markov_order
            nxt = self.state_next[state, rng.integers(0, 4, size=B)]
            state = np.where(follow, nxt, rng.integers(0, cfg.n_states, size=B))
        tokens, labels = toks[:, :-1], toks[:, 1:]
        if n_codebooks:
            tokens = np.stack([(tokens + q) % cfg.vocab_size for q in range(n_codebooks)], -1)
            labels = np.stack([(labels + q) % cfg.vocab_size for q in range(n_codebooks)], -1)
        return {"tokens": tokens, "labels": labels}

    def unigram_entropy(self) -> float:
        """Upper bound a memorizing-unigram model should beat."""
        p = self.emit_probs
        return float(-(p * np.log(p)).sum())
