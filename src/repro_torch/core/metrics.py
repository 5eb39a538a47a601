"""Evaluation metrics P@k and R@k — port of `src/repro/core/metrics.py`
(`topk_hits`, `precision_recall_from_hits`, `precision_recall_from_topk`,
`masks_from_interactions`). numpy only: the inputs are top-k index
arrays and boolean masks on the host.

    P@k = |S_i^T ∩ S_i^R| / k          R@k = |S_i^T ∩ S_i^R| / |S_i^T|

averaged over users with a non-empty test set.
"""
from __future__ import annotations

import numpy as np


def topk_hits(rec: np.ndarray, test_mask: np.ndarray, k: int) -> np.ndarray:
    """(n,) int per-user hit counts in the first k recommendation slots;
    unfilled slots (id < 0) count as misses."""
    rec_k = np.asarray(rec[:, :k])
    filled = rec_k >= 0
    safe = np.where(filled, rec_k, 0)
    return (np.take_along_axis(test_mask, safe, axis=1) & filled).sum(axis=1)


def precision_recall_from_hits(
    hits: np.ndarray, n_test: np.ndarray, k: int
) -> tuple[float, float]:
    """Mean P@k / R@k over users with ≥1 test item."""
    valid = n_test > 0
    if not valid.any():
        return 0.0, 0.0
    p_at_k = float((hits[valid] / k).mean())
    r_at_k = float((hits[valid] / n_test[valid]).mean())
    return p_at_k, r_at_k


def precision_recall_from_topk(
    rec: np.ndarray, test_mask: np.ndarray, k: int
) -> tuple[float, float]:
    """P@k / R@k from top-K indices (K ≥ k, descending score order)."""
    assert rec.shape[1] >= k, (rec.shape, k)
    hits = topk_hits(rec, test_mask, k)
    n_test = test_mask.sum(axis=1)
    return precision_recall_from_hits(hits, n_test, k)


def masks_from_interactions(n_users: int, n_items: int, pairs: np.ndarray) -> np.ndarray:
    """(I, J) bool mask from an (n, 2) array of (user, item) pairs."""
    m = np.zeros((n_users, n_items), dtype=bool)
    if len(pairs):
        m[pairs[:, 0], pairs[:, 1]] = True
    return m
