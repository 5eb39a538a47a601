"""Evaluation metrics P@k and R@k — port of `src/repro/core/metrics.py`
(`topk_recommend` :15, `precision_recall_at_k` :25, `topk_hits`,
`precision_recall_from_hits`, `precision_recall_from_topk`,
`evaluate_ranking_from_topk` :74, `evaluate_ranking` :85,
`masks_from_interactions`, `masks_from_interactions_rows` :102). numpy on
the host, except the dense top-k of the oracle path, which runs in PyTorch
on the scores' device.

    P@k = |S_i^T ∩ S_i^R| / k          R@k = |S_i^T ∩ S_i^R| / |S_i^T|

averaged over users with a non-empty test set; training items are
excluded from the candidates.
"""
from __future__ import annotations

import numpy as np
import torch


def topk_recommend(scores, train_mask, k: int) -> torch.Tensor:
    """Top-k item indices per user, training items excluded: (I, k) int64
    on the scores' device. scores: (I, J) float; train_mask: (I, J) bool.
    Ties go to the lowest item id (a stable descending sort), as the
    reference's `lax.top_k` orders them."""
    scores = torch.as_tensor(scores)
    mask = torch.as_tensor(train_mask, device=scores.device)
    masked = scores.masked_fill(mask, float("-inf"))
    return torch.sort(masked, dim=1, descending=True, stable=True)[1][:, :k]


def precision_recall_at_k(scores, train_mask, test_mask: np.ndarray,
                          k: int) -> tuple[float, float]:
    """Mean P@k and R@k over users with >=1 test item."""
    rec = topk_recommend(scores, train_mask, k).cpu().numpy()
    return precision_recall_from_topk(rec, test_mask, k)


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


def evaluate_ranking_from_topk(rec: np.ndarray, test_mask: np.ndarray,
                               ks=(5, 10)) -> dict[str, float]:
    """``{"P@k": ..., "R@k": ...}`` from streaming top-k output — no (I, J)
    score matrix involved."""
    out = {}
    for k in ks:
        p, r = precision_recall_from_topk(rec, test_mask, k)
        out[f"P@{k}"] = p
        out[f"R@{k}"] = r
    return out


def evaluate_ranking(scores, train_mask, test_mask: np.ndarray,
                     ks=(5, 10)) -> dict[str, float]:
    """``{"P@k": ..., "R@k": ...}`` from a dense (I, J) score matrix."""
    out = {}
    for k in ks:
        p, r = precision_recall_at_k(scores, train_mask, test_mask, k)
        out[f"P@{k}"] = p
        out[f"R@{k}"] = r
    return out


def masks_from_interactions(n_users: int, n_items: int, pairs: np.ndarray) -> np.ndarray:
    """(I, J) bool mask from an (n, 2) array of (user, item) pairs."""
    m = np.zeros((n_users, n_items), dtype=bool)
    if len(pairs):
        m[pairs[:, 0], pairs[:, 1]] = True
    return m


def masks_from_interactions_rows(
    row_start: int, n_rows: int, n_items: int, pairs: np.ndarray
) -> np.ndarray:
    """Row window [row_start, row_start + n_rows) of the (I, J) interaction
    mask, without building the full matrix; pairs outside the window are
    ignored."""
    m = np.zeros((n_rows, n_items), dtype=bool)
    if len(pairs):
        sel = (pairs[:, 0] >= row_start) & (pairs[:, 0] < row_start + n_rows)
        p = pairs[sel]
        m[p[:, 0] - row_start, p[:, 1]] = True
    return m
