"""City-bucketed candidate index and its geohash-cell refinement — a
numpy copy of `src/repro/serving/candidates.py:42-300` (`CandidateIndex`,
`build_candidate_index`, `index_from_dataset`, `HierarchicalIndex`,
`build_hierarchical_index`).

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


@dataclasses.dataclass(frozen=True)
class HierarchicalIndex:
    """Geohash-style refinement of the flat city buckets. ``flat`` is a
    plain `CandidateIndex` whose buckets are the leaf cells; the other
    arrays describe the hierarchy."""
    flat: CandidateIndex
    cell_of_item: np.ndarray    # (J,) int32 leaf cell per item
    cell_of_user: np.ndarray    # (I,) int32 leaf cell per user
    cell_city: np.ndarray       # (n_cells,) int32 source city of each cell
    cell_depth: np.ndarray      # (n_cells,) int32 splits below the city root

    @property
    def n_cells(self) -> int:
        return int(len(self.cell_city))

    @property
    def max_depth(self) -> int:
        return int(self.cell_depth.max()) if len(self.cell_depth) else 0

    def stats(self) -> dict:
        """How far the hierarchy shrank the serving cap."""
        depth = self.cell_depth
        return {
            "n_cells": self.n_cells,
            "max_depth": self.max_depth,
            "mean_depth": float(depth.mean()) if len(depth) else 0.0,
            "cap": self.flat.cap,
            "n_empty_cells": int((self.flat.bucket_size == 0).sum()),
            "mean_cell_items": float(self.flat.bucket_size.mean()),
        }


def build_hierarchical_index(
    item_city: np.ndarray,
    user_city: np.ndarray,
    item_coords: np.ndarray,
    user_coords: np.ndarray,
    *,
    cell_cap: int = 128,
    cap: int | None = None,
    pad_to: int = LANE,
    max_depth: int = 16,
    item_priority: np.ndarray | None = None,
) -> HierarchicalIndex:
    """Recursively halve every city holding more than ``cell_cap`` POIs at
    the midpoint of its items' bounding box, alternating lon/lat per level
    (a geohash's bit order), until each leaf fits ``cell_cap`` or
    ``max_depth`` is reached. Users follow the same splits by their own
    coordinates. Cells are numbered in the reference's order (cities
    ascending, each city's stack popped right half first), so cell ids,
    and with them the flat index, equal the reference's."""
    item_city = np.asarray(item_city).reshape(-1)
    user_city = np.asarray(user_city).reshape(-1)
    item_coords = np.asarray(item_coords, dtype=np.float64).reshape(-1, 2)
    user_coords = np.asarray(user_coords, dtype=np.float64).reshape(-1, 2)
    J, I = len(item_city), len(user_city)
    assert item_coords.shape == (J, 2), (item_coords.shape, J)
    assert user_coords.shape == (I, 2), (user_coords.shape, I)
    n_cities = max(
        int(item_city.max()) + 1 if J else 0,
        int(user_city.max()) + 1 if I else 0,
        1,
    )
    cell_of_item = np.zeros(J, dtype=np.int32)
    cell_of_user = np.zeros(I, dtype=np.int32)
    cell_city: list[int] = []
    cell_depth: list[int] = []

    def emit(cell_items, cell_users, city: int, depth: int) -> None:
        cid = len(cell_city)
        cell_of_item[cell_items] = cid
        cell_of_user[cell_users] = cid
        cell_city.append(city)
        cell_depth.append(depth)

    for c in range(n_cities):
        items_c = np.flatnonzero(item_city == c)
        users_c = np.flatnonzero(user_city == c)
        if len(items_c) == 0 and len(users_c) == 0:
            continue
        stack = [(items_c, users_c, 0)]
        while stack:
            it, us, depth = stack.pop()
            if len(it) <= cell_cap or depth >= max_depth:
                emit(it, us, c, depth)
                continue
            ax = depth % 2
            lo = item_coords[it, ax].min()
            hi = item_coords[it, ax].max()
            mid = 0.5 * (lo + hi)
            left_i = item_coords[it, ax] <= mid
            if left_i.all() or not left_i.any():
                emit(it, us, c, depth)          # degenerate: co-located POIs
                continue
            left_u = user_coords[us, ax] <= mid
            stack.append((it[left_i], us[left_u], depth + 1))
            stack.append((it[~left_i], us[~left_u], depth + 1))

    flat = build_candidate_index(
        cell_of_item if J else np.empty(0, np.int32),
        cell_of_user if I else np.empty(0, np.int32),
        n_items=J, cap=cap, pad_to=pad_to, item_priority=item_priority,
    )
    return HierarchicalIndex(
        flat=flat,
        cell_of_item=cell_of_item,
        cell_of_user=cell_of_user,
        cell_city=np.asarray(cell_city, dtype=np.int32),
        cell_depth=np.asarray(cell_depth, dtype=np.int32),
    )
