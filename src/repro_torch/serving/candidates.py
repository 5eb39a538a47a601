"""City-bucketed candidate index — a numpy copy of
`src/repro/serving/candidates.py:42-171` (`CandidateIndex`,
`build_candidate_index`, `index_from_dataset`).

* ``bucket_items (C, cap) int32`` — each city's POI ids in **ascending id
  order**, padded with -1 to a shared cap (a multiple of 128). Ascending
  order is contractual: the serve kernel breaks score ties toward the
  lowest item id, and zero-initialised item factors make exact 0.0 ties
  common.
* ``user_bucket (I,)`` — home-city bucket per user (the request router key).

A city larger than ``cap`` keeps its ``cap`` items of highest priority
(popularity when given, lowest ids otherwise) and records the truncation.
"""
from __future__ import annotations

import dataclasses

import numpy as np

LANE = 128


@dataclasses.dataclass(frozen=True)
class CandidateIndex:
    bucket_items: np.ndarray    # (C, cap) int32, -1 padded, ascending per row
    bucket_size: np.ndarray     # (C,) int32 — items actually indexed (≤ cap)
    city_size: np.ndarray       # (C,) int32 — true city sizes (pre-truncation)
    user_bucket: np.ndarray     # (I,) int32 home bucket per user
    n_items: int

    @property
    def cap(self) -> int:
        return int(self.bucket_items.shape[1])

    @property
    def n_buckets(self) -> int:
        return int(self.bucket_items.shape[0])

    @property
    def n_truncated_buckets(self) -> int:
        return int((self.city_size > self.bucket_size).sum())

    def user_fits(self) -> np.ndarray:
        """(I,) bool — True where the user's full city fits the bucket."""
        return (self.city_size == self.bucket_size)[self.user_bucket]

    def eligible_mask_chunks(self, users: np.ndarray, rows_per_chunk: int = 256):
        """Yield ``(row_start, mask_chunk)``: dense (≤rows_per_chunk, J)
        bool eligibility blocks over ``users`` in order."""
        users = np.asarray(users)
        for s in range(0, len(users), rows_per_chunk):
            chunk = users[s : s + rows_per_chunk]
            items = self.bucket_items[self.user_bucket[chunk]]   # (r, cap)
            rows, cols = np.nonzero(items >= 0)
            elig = np.zeros((len(chunk), self.n_items), dtype=bool)
            elig[rows, items[rows, cols]] = True
            yield s, elig

    def eligible_mask(self, users: np.ndarray,
                      rows_per_chunk: int | None = None) -> np.ndarray:
        """(len(users), J) bool candidate-eligibility rows."""
        users = np.asarray(users)
        out = np.zeros((len(users), self.n_items), dtype=bool)
        step = rows_per_chunk or max(len(users), 1)
        for s, elig in self.eligible_mask_chunks(users, step):
            out[s : s + len(elig)] = elig
        return out


def build_candidate_index(
    item_city: np.ndarray,
    user_city: np.ndarray,
    *,
    n_items: int | None = None,
    cap: int | None = None,
    pad_to: int = LANE,
    item_priority: np.ndarray | None = None,
) -> CandidateIndex:
    """Bucket POIs by city. ``cap`` bounds the per-bucket candidate count
    (default: the largest city, rounded up to ``pad_to`` — lossless);
    ``item_priority`` (higher = kept first) decides what survives
    truncation. A city with users but no POIs gets an all-empty bucket."""
    item_city = np.asarray(item_city).reshape(-1)
    user_city = np.asarray(user_city).reshape(-1)
    J = int(n_items) if n_items is not None else int(len(item_city))
    assert len(item_city) == J, (len(item_city), J)
    if len(item_city):
        assert int(item_city.min()) >= 0, "negative item city"
    if len(user_city):
        assert int(user_city.min()) >= 0, "negative user city"
    C = max(
        int(item_city.max()) + 1 if len(item_city) else 0,
        int(user_city.max()) + 1 if len(user_city) else 0,
        1,
    )
    # one stable sort groups items by city with ascending ids in each
    order = np.argsort(item_city, kind="stable") if len(item_city) else (
        np.empty(0, dtype=np.int64))
    sorted_city = item_city[order]
    starts = np.searchsorted(sorted_city, np.arange(C), side="left")
    ends = np.searchsorted(sorted_city, np.arange(C), side="right")
    buckets = [order[s:e] for s, e in zip(starts, ends)]
    city_size = (ends - starts).astype(np.int32)
    max_city = int(city_size.max()) if C else 0
    if cap is None:
        cap = max_city
    cap = max(int(-(-max(cap, 1) // pad_to)) * pad_to, pad_to)

    bucket_items = np.full((C, cap), -1, dtype=np.int32)
    bucket_size = np.zeros(C, dtype=np.int32)
    for c, items in enumerate(buckets):
        if len(items) > cap:
            if item_priority is not None:
                keep = items[np.argsort(-np.asarray(item_priority)[items],
                                        kind="stable")[:cap]]
            else:
                keep = items[:cap]
            items = np.sort(keep)   # ascending-id order is contractual
        bucket_items[c, : len(items)] = items
        bucket_size[c] = len(items)
    return CandidateIndex(
        bucket_items=bucket_items,
        bucket_size=bucket_size,
        city_size=city_size,
        user_bucket=user_city.astype(np.int32),
        n_items=J,
    )


def index_from_dataset(ds, **kw) -> CandidateIndex:
    """Index straight from a `synthetic_poi.POIDataset`."""
    return build_candidate_index(ds.item_city, ds.user_city, n_items=ds.n_items, **kw)
