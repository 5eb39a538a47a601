"""User adjacency graph + random-walk propagation (paper Eqs. 2-4) — port
of `src/repro/core/graph.py:33-163` (`GraphConfig`, `pairwise_dist`,
`build_adjacency`, `row_normalize`, `walk_propagation_matrix`,
`NeighborTable`, `neighbor_table_from_dense`, `walk_neighbor_table`),
:166-216 (`PartitionedNeighborTable`, `partition_neighbor_table`) and
:231-254 (`neighbor_counts`, `communication_bytes`).

The graph is built on the host in numpy, exactly as the reference does,
so the dense matrices are bit-identical. Only the exported neighbor table
moves to the device, as torch tensors: ``idx`` int64 (it indexes U/P/Q
directly) and ``wgt`` float32. Its split for learner sharding stays on the
host, in numpy; each rank uploads its own slices (`sharding/dmf.py`).

    w_{ii'} = I^{ii'} * f(d_{ii'})                         (Eq. 2)
    P(n_i = k)  = w_{ik} / sum_{i'} w_{ii'}                (Eq. 3)
    P(n_i = k') ∝ sum_k w_{ik} w_{kk'}                     (Eq. 4)
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import device as device_lib


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    n_neighbors: int = 2        # N — max direct neighbors per user (paper: N=2)
    walk_length: int = 3        # D — max random-walk distance (paper sweeps 1..4)
    hop_damping: float = 1.0    # c — per-hop damping c^d on Ŵ^d
    uniform_weights: bool = True  # paper experiments "simply set w_{ii'}=1"
    paper_literal: bool = False   # keep Alg.1's |N^d(i)| amplification factor
    same_city_only: bool = True   # I^{ii'} indicator from Eq. 2


def pairwise_dist(coords: np.ndarray) -> np.ndarray:
    d2 = np.sum((coords[:, None, :] - coords[None, :, :]) ** 2, axis=-1)
    return np.sqrt(np.maximum(d2, 0.0))


def build_adjacency(coords: np.ndarray, cities: np.ndarray, cfg: GraphConfig) -> np.ndarray:
    """Dense (I, I) adjacency W per Eq. 2, truncated to the top-N nearest
    same-city neighbors, zero diagonal, symmetrized by max(W, W^T)."""
    I = coords.shape[0]
    dist = pairwise_dist(coords)
    same_city = cities[:, None] == cities[None, :]
    np.fill_diagonal(same_city, False)
    if cfg.uniform_weights:
        w_full = same_city.astype(np.float64)
    else:
        w_full = same_city / (1.0 + dist)
    if not cfg.same_city_only:
        w_cross = (~same_city) / (1.0 + dist)
        np.fill_diagonal(w_cross, 0.0)
        w_full = w_full + 1e-3 * w_cross
    order = np.argsort(np.where(w_full > 0, dist, np.inf), axis=1)
    W = np.zeros((I, I), dtype=np.float32)
    rows = np.arange(I)[:, None]
    top = order[:, : cfg.n_neighbors]
    keep = np.take_along_axis(w_full, top, axis=1) > 0
    W[rows.repeat(cfg.n_neighbors, 1)[keep], top[keep]] = np.take_along_axis(
        w_full, top, axis=1
    )[keep].astype(np.float32)
    return np.maximum(W, W.T)


def row_normalize(W: np.ndarray) -> np.ndarray:
    """Random-walk transition matrix Ŵ (Eq. 3). Isolated rows stay zero."""
    deg = W.sum(axis=1, keepdims=True)
    return np.where(deg > 0, W / np.maximum(deg, 1e-12), 0.0).astype(np.float32)


def walk_propagation_matrix(W: np.ndarray, cfg: GraphConfig) -> np.ndarray:
    """M (I, I): per-event propagation weights of the global-factor
    gradient, M[i, i] = 1 for the sender's own line-11 update:

        M = I + sum_{d=1..D} c^d * Ŵ^d            (default, normalized)
        M = I + sum_{d=1..D} |N^d(i)| * W^d       (paper_literal)
    """
    I = W.shape[0]
    M = np.eye(I, dtype=np.float64)
    if cfg.paper_literal:
        Wd = np.eye(I)
        for _ in range(cfg.walk_length):
            Wd = Wd @ W
            nd = (Wd > 0).sum(axis=1, keepdims=True).astype(np.float64)
            M += nd * Wd
    else:
        What = row_normalize(W).astype(np.float64)
        Wd = np.eye(I)
        for d in range(1, cfg.walk_length + 1):
            Wd = Wd @ What
            M += (cfg.hop_damping ** d) * Wd
    return M.astype(np.float32)


class NeighborTable(NamedTuple):
    """Compact multi-hop neighborhood of M: ``idx[i, s]`` the receivers of
    user i's gradient message (ascending column order), ``wgt[i, s]`` the
    walk weight M[i, idx[i, s]]. Rows are padded to S = max realized
    1 + |N^D(i)| with the sender's own index at weight 0, so a padded slot
    scatter-adds exactly zero."""

    idx: torch.Tensor   # (I, S) int64
    wgt: torch.Tensor   # (I, S) float32


def neighbor_table_from_dense(M: np.ndarray, device="cuda") -> NeighborTable:
    """Extract the (idx, wgt) neighbor table from a dense propagation
    matrix and place it on ``device``."""
    dev = device_lib.resolve(device)
    M = np.asarray(M)
    I = M.shape[0]
    nz = M != 0.0
    S = max(int(nz.sum(axis=1).max()) if I else 0, 1)
    # stable argsort puts nonzero columns first, in ascending column order
    order = np.argsort(~nz, axis=1, kind="stable")[:, :S]
    taken = np.take_along_axis(nz, order, axis=1)
    self_idx = np.arange(I, dtype=np.int64)[:, None]
    idx = np.where(taken, order, self_idx)
    wgt = np.where(taken, np.take_along_axis(M, order, axis=1), 0.0)
    return NeighborTable(
        idx=torch.as_tensor(idx, dtype=torch.int64, device=dev),
        wgt=torch.as_tensor(wgt.astype(np.float32), device=dev),
    )


def walk_neighbor_table(W: np.ndarray, cfg: GraphConfig, device="cuda") -> NeighborTable:
    """Sparse export of `walk_propagation_matrix`, shape (I, S)."""
    return neighbor_table_from_dense(walk_propagation_matrix(W, cfg), device)


class PartitionedNeighborTable(NamedTuple):
    """`NeighborTable` split for a row-sharded learner group, on the host.

    Users are partitioned contiguously into ``n_shards`` shards of
    ``rows_per_shard`` rows (the user axis padded to ``n_shards *
    rows_per_shard``). Slot (i, d, s) carries the weight and the
    **shard-local** row of receiver ``nbr.idx[i, s]`` iff that receiver
    lives on shard d, else (0, 0.0): a weight-0 slot scatter-adds exactly
    zero. What shard s ships to shard d for sender i is the (i, d, :)
    slice weighted by i's batch gradient, so the exchange has one static
    shape per step."""

    idx: np.ndarray    # (I_pad, n_shards, S) int64 — receiver rows, shard-local
    wgt: np.ndarray    # (I_pad, n_shards, S) float32
    rows_per_shard: int
    n_users: int       # real (unpadded) user count


def partition_neighbor_table(nbr: NeighborTable, n_shards: int,
                             n_users: int | None = None) -> PartitionedNeighborTable:
    """Split each user's (S,) receiver row by the receiver's home shard
    (``r // rows_per_shard``), re-indexed to shard-local rows; slots whose
    receiver lives elsewhere become (0, 0.0). Summed over destinations the
    split gives back the original table exactly."""
    idx, wgt = nbr.idx.cpu().numpy(), nbr.wgt.cpu().numpy()
    I, S = idx.shape
    if n_users is None:
        n_users = I
    rows = -(-I // n_shards)
    dest = idx // rows
    local = idx % rows
    live = wgt != 0.0
    pidx = np.zeros((rows * n_shards, n_shards, S), np.int64)
    pwgt = np.zeros((rows * n_shards, n_shards, S), np.float32)
    for d in range(n_shards):
        keep = live & (dest == d)
        pidx[:I, d] = np.where(keep, local, 0)
        pwgt[:I, d] = np.where(keep, wgt, 0.0)
    return PartitionedNeighborTable(idx=pidx, wgt=pwgt, rows_per_shard=rows, n_users=n_users)


def neighbor_counts(W: np.ndarray, max_d: int) -> np.ndarray:
    """|N^d(i)| for d=1..max_d: (max_d, I) counts of users first reached
    at exactly d hops."""
    I = W.shape[0]
    A = (W > 0).astype(np.float64)
    reached = np.eye(I, dtype=bool)
    counts = np.zeros((max_d, I), dtype=np.int64)
    Ad = np.eye(I)
    for d in range(max_d):
        Ad = Ad @ A
        new = (Ad > 0) & ~reached
        counts[d] = new.sum(axis=1)
        reached |= new
    return counts


def communication_bytes(W: np.ndarray, D: int, K: int, n_ratings: int) -> int:
    """Paper §Complexity: |O| · mean |N^D(i)| · 4K bytes per epoch — the
    realized mean multi-hop fan-out of one gradient message times its
    size."""
    counts = neighbor_counts(W, D).sum(axis=0)  # |N^D(i)| per user
    mean_fanout = float(counts.mean())
    return int(round(n_ratings * mean_fanout * 4 * K))
