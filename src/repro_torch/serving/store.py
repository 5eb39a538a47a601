"""Million-user serving: a device-resident tiled factor store and its
quantized engine — port of `src/repro/serving/store.py:48-379`
(`_BF16_EPS`, `synthetic_world`, `SyntheticFactors`, `TiledFactorStore`,
`TiledServingEngine`), plus `store_from_numpy`, which carries a store
built by the reference across.

Each user i owns an item view v^i = p^i + q^i; at 1M users × 100k POIs
the (I, J, K) tensor would be 3.2 TB. Serving only reads v^i at the
user's candidate cell, so the store keeps, per user, only that window:

    slab (I, cap, K) f32  — v^i at ``bucket_items[bucket(i)]``, column-aligned
    seen (I, cap) int8    — the user's seen bits, same alignment
    U    (I, K) f32       — user factors

At cap 128 that is 4.1 GB of fp32, 1.03 GB as int8 codes plus a
per-user scale, 2.05 GB as bf16 (byte counts, the reference's
``million.resident_gb``). Unlike the reference, which keeps the slabs in
host numpy and gathers windows on the host, the port keeps every slab on
the store's device (an H100's 80 GB holds all three precisions at once):
a dispatch uploads R user ids and runs one kernel. int8 and bf16 read the
store in place (`ops.serve_topk_tiled_quant`); fp32 gathers R windows on
the device first (`ops.serve_topk_window`). The dispatch goes through
`serving/engine.py`'s `_DispatchPlan`: on a card a captured CUDA graph,
replayed. The index, the cold flags and the item counts stay host numpy;
so does the popularity fallback (`serving/engine.py`'s, shared).

Quantization, exact to the reference's numpy and bf16 cast bit for bit:

    int8: scale = max(max|v^i| / 127, 1e-12), codes = round(v / scale)
          (half to even) clipped to ±127  ⇒ |Δscore| ≤ ||u_i||₁ · scale/2
    bf16: round to nearest even          ⇒ |Δscore| ≤ Σ_k |u_k·v_k| · 2⁻⁸

`shard_rows` slices the store along `sharding.dmf.shard_row_slices`, so
requests route by ``user // rows_per_shard``; shard-local results equal
the unsharded store's bit for bit. Each dispatch runs in the reference's
``tiled.dispatch`` trace span (``mode=``) with the port's five phase
spans inside it (`TiledServingEngine.recommend`).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.kernels import ops
from repro_torch.obs import trace as trace_lib
from repro_torch.serving.candidates import CandidateIndex
from repro_torch.serving.engine import (EngineStats, ServingConfig, _DispatchPlan, _overwrite,
                                        _popularity)

_BF16_EPS = 2.0 ** -8     # round-to-nearest relative error bound of bfloat16


def synthetic_world(
    n_users: int, n_items: int, n_cities: int, seed: int = 0,
    zipf_a: float = 0.8, city_sigma: float = 0.03,
):
    """Vectorized million-scale geography: zipf-weighted city assignment
    for users and POIs, Gaussian coordinates around each city center.
    Returns (user_city, item_city, user_coords, item_coords), equal to the
    reference's bit for bit (same numpy draws in the same order)."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n_cities + 1) ** zipf_a
    w /= w.sum()
    user_city = rng.choice(n_cities, size=n_users, p=w).astype(np.int32)
    item_city = rng.choice(n_cities, size=n_items, p=w).astype(np.int32)
    centers = rng.uniform(0.0, 1.0, size=(n_cities, 2))
    user_coords = (centers[user_city]
                   + city_sigma * rng.standard_normal((n_users, 2)))
    item_coords = (centers[item_city]
                   + city_sigma * rng.standard_normal((n_items, 2)))
    return user_city, item_city, user_coords.astype(np.float64), \
        item_coords.astype(np.float64)


@dataclasses.dataclass(frozen=True)
class SyntheticFactors:
    """Deterministic rank-structured factors for million-scale serving:
    v^i_j = B1_j · s_i + B2_j from O(J·K) host tables (equal to the
    reference's), so the dense item view of any user recomputes exactly
    (`dense_rows`). Rows are computed on a device as two eager ops, a
    multiply and an add, each rounded as numpy rounds it (never a fused
    multiply-add), so they equal the reference's bit for bit."""
    B1: np.ndarray        # (J, K) f32 shared item basis
    B2: np.ndarray        # (J, K) f32 shared item offset
    s_user: np.ndarray    # (I,) f32 per-user blend
    U: np.ndarray         # (I, K) f32 user factors

    @classmethod
    def create(cls, n_users: int, n_items: int, dim: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        return cls(
            B1=rng.standard_normal((n_items, dim)).astype(np.float32),
            B2=(0.1 * rng.standard_normal((n_items, dim))).astype(np.float32),
            s_user=rng.standard_normal(n_users).astype(np.float32),
            U=(rng.standard_normal((n_users, dim)).astype(np.float32)
               / np.float32(np.sqrt(dim))),
        )

    def _tables(self, dev: torch.device):
        return tuple(torch.as_tensor(x, device=dev) for x in (self.B1, self.B2, self.s_user))

    def item_rows(self, users, items, device="cuda") -> torch.Tensor:
        """v^{users[r]} at ``items[r]`` on ``device``: users (n,), items
        (n, m) int, numpy or tensors; negative ids read item 0 (callers
        mask them). Returns (n, m, K) f32."""
        dev = device_lib.resolve(device)
        B1, B2, s = self._tables(dev)
        users = torch.as_tensor(users, device=dev).long()
        safe = torch.as_tensor(items, device=dev).long().clamp_min(0)
        return B1[safe] * s[users][:, None, None] + B2[safe]

    def dense_rows(self, users, device="cuda") -> torch.Tensor:
        """Full (len(users), J, K) item views on ``device``: the oracle
        input for bitwise checks of the tiled store at sampled users."""
        dev = device_lib.resolve(device)
        B1, B2, s = self._tables(dev)
        users = torch.as_tensor(users, device=dev).long()
        return B1[None, :, :] * s[users][:, None, None] + B2[None, :, :]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def int8_rows(rows: torch.Tensor):
    """Per-row symmetric int8 of (n, cap, K) f32 windows: scale =
    max|row| / 127, floored at 1e-12 so all-zero rows stay exact; codes =
    round(v / scale) (half to even) clipped to ±127, elementwise error ≤
    scale/2. Returns (codes (n, cap, K) int8, scale (n,) f32), equal to the
    reference's numpy bit for bit."""
    # a tensor divisor: PyTorch's CUDA division by a host scalar multiplies
    # by its reciprocal, which can round otherwise than numpy's division
    d127 = torch.tensor(127.0, dtype=torch.float32, device=rows.device)
    scale = (rows.abs().amax(dim=(1, 2)) / d127).clamp_min(1e-12)
    codes = torch.round(rows / scale[:, None, None]).clamp_(-127, 127).to(torch.int8)
    return codes, scale


def _windows(synth: SyntheticFactors, index: CandidateIndex, chunk_rows: int,
             dev: torch.device) -> torch.Tensor:
    """Every user's (cap, K) f32 window of ``synth`` at its bucket's items
    (padding columns read item 0), computed on ``dev`` chunk by chunk."""
    I, cap, K = len(synth.s_user), index.cap, synth.B1.shape[1]
    slab = torch.empty((I, cap, K), dtype=torch.float32, device=dev)
    bucket_items = torch.as_tensor(index.bucket_items, device=dev)
    user_bucket = torch.as_tensor(index.user_bucket, dtype=torch.int64, device=dev)
    for s in range(0, I, chunk_rows):
        e = min(s + chunk_rows, I)
        slab[s:e] = synth.item_rows(torch.arange(s, e, device=dev),
                                    bucket_items[user_bucket[s:e]], device=dev)
    return slab


@dataclasses.dataclass
class TiledFactorStore:
    """Per-user candidate-window slabs on one device; see the module
    docstring. ``seen`` is column-aligned to
    ``index.bucket_items[index.user_bucket]``; ``cold`` and ``item_counts``
    (host numpy) carry the engine's fallback state, as in `ServingEngine`
    (cold = a user with no interactions anywhere)."""
    U: torch.Tensor                          # (I, K) f32
    slab: torch.Tensor                       # (I, cap, K) f32
    seen: torch.Tensor                       # (I, cap) int8
    index: CandidateIndex
    cold: np.ndarray                         # (I,) bool
    item_counts: np.ndarray                  # (J,) int64 check-in counts
    q_codes: torch.Tensor | None = None      # (I, cap, K) int8
    q_scale: torch.Tensor | None = None      # (I,) f32, dequant = codes · scale
    slab_bf16: torch.Tensor | None = None    # (I, cap, K) bfloat16

    @property
    def n_users(self) -> int:
        return int(self.U.shape[0])

    @property
    def cap(self) -> int:
        return int(self.slab.shape[1])

    @property
    def dim(self) -> int:
        return int(self.U.shape[1])

    @property
    def device(self) -> torch.device:
        return self.U.device

    def nbytes(self) -> dict[str, int]:
        out = {"U": _nbytes(self.U), "slab_fp32": _nbytes(self.slab),
               "seen": _nbytes(self.seen)}
        if self.q_codes is not None:
            out["slab_int8"] = _nbytes(self.q_codes) + _nbytes(self.q_scale)
        if self.slab_bf16 is not None:
            out["slab_bf16"] = _nbytes(self.slab_bf16)
        return out

    # -------------------------------------------------------- constructors
    @classmethod
    def from_state(cls, state, index: CandidateIndex, seen: np.ndarray,
                   chunk_rows: int = 65536) -> "TiledFactorStore":
        """Build from a port `DMFState` and a dense (I, J) host seen mask,
        on the state's device. Gathers P and Q at the windows and adds them,
        chunked: elementwise add commutes with the gather, so the slab
        equals `ServingEngine`'s V = P + Q at the same windows bit for
        bit."""
        dev = state.U.device
        seen_np = np.asarray(seen).astype(bool)
        seen_t = torch.as_tensor(seen_np, device=dev)
        bucket_items = torch.as_tensor(index.bucket_items, device=dev)
        user_bucket = torch.as_tensor(index.user_bucket, dtype=torch.int64, device=dev)
        I, cap, K = state.U.shape[0], index.cap, state.P.shape[2]
        slab = torch.empty((I, cap, K), dtype=torch.float32, device=dev)
        seen_w = torch.empty((I, cap), dtype=torch.int8, device=dev)
        for s in range(0, I, chunk_rows):
            e = min(s + chunk_rows, I)
            rows = torch.arange(s, e, device=dev)[:, None]
            cand = bucket_items[user_bucket[s:e]]
            safe = cand.clamp_min(0).long()
            slab[s:e] = state.P[rows, safe] + state.Q[rows, safe]
            seen_w[s:e] = ((cand >= 0) & seen_t[rows, safe]).to(torch.int8)
        return cls(U=state.U.to(torch.float32, copy=True), slab=slab, seen=seen_w,
                   index=index, cold=~seen_np.any(axis=1),
                   item_counts=seen_np.sum(axis=0).astype(np.int64))

    @classmethod
    def synthetic(cls, synth: SyntheticFactors, index: CandidateIndex,
                  seen_per_user: int = 4, seed: int = 0,
                  chunk_rows: int = 131072, device="cuda") -> "TiledFactorStore":
        """Million-scale constructor: the slab from the rank-structured
        generator, computed on ``device`` chunk by chunk, and
        ``seen_per_user`` seen bits per user inside their bucket, drawn on
        the host with the reference's numpy stream (same chunks, same draws,
        same order), then uploaded."""
        dev = device_lib.resolve(device)
        rng = np.random.default_rng(seed)
        I, cap = len(synth.s_user), index.cap
        J = synth.B1.shape[0]
        slab = _windows(synth, index, chunk_rows, dev)
        seen_w = np.zeros((I, cap), np.int8)
        counts = np.zeros(J, np.int64)
        for s in range(0, I, chunk_rows):
            e = min(s + chunk_rows, I)
            rows = np.arange(s, e)
            size = index.bucket_size[index.user_bucket[rows]]
            if seen_per_user > 0:
                # positions within each user's real bucket extent
                pos = np.floor(rng.random((e - s, seen_per_user))
                               * np.maximum(size, 1)[:, None]).astype(np.int64)
                has = size > 0
                seen_w[np.repeat(rows, seen_per_user)[np.repeat(has, seen_per_user)],
                       pos[has].ravel()] = 1
                # counts from the set bits, so sum(counts) == sum(seen)
                ri, ci = np.nonzero(seen_w[s:e])
                np.add.at(counts, index.bucket_items[index.user_bucket[rows[ri]], ci], 1)
        return cls(U=torch.as_tensor(synth.U, device=dev), slab=slab,
                   seen=torch.as_tensor(seen_w, device=dev), index=index,
                   cold=np.zeros(I, bool), item_counts=counts)

    @classmethod
    def from_checkins(cls, synth: SyntheticFactors, index: CandidateIndex, checkins,
                      chunk_rows: int = 131072, device="cuda") -> "TiledFactorStore":
        """A deployment's store from its users' check-ins, on ``device``:
        the windows from ``synth`` as `synthetic` computes them (padding
        columns hold item 0's view), and the seen windows, ``item_counts``
        and ``cold`` from ``checkins``, an (m, 2) array of (user, item)
        pairs, repeats allowed. Each pair's item is matched against its
        user's window on the device; a pair whose item lies outside the
        window sets no seen bit. The fields equal `from_state`'s for the
        dense seen mask of those pairs (``item_counts`` counts the
        distinct pairs, ``cold`` marks users with none), and nothing of
        shape (I, J) is built."""
        dev = device_lib.resolve(device)
        I, cap = len(synth.s_user), index.cap
        J = synth.B1.shape[0]
        pairs = np.asarray(checkins, dtype=np.int64).reshape(-1, 2)
        if len(pairs) and (pairs.min() < 0 or pairs[:, 0].max() >= I
                           or pairs[:, 1].max() >= J):
            raise ValueError(f"from_checkins: a pair outside [0, {I}) x [0, {J})")
        slab = _windows(synth, index, chunk_rows, dev)
        bucket_items = torch.as_tensor(index.bucket_items, device=dev)
        user_bucket = torch.as_tensor(index.user_bucket, dtype=torch.int64, device=dev)
        seen_w = torch.zeros((I, cap), dtype=torch.int8, device=dev)
        pairs_t = torch.as_tensor(pairs, device=dev)
        for s in range(0, len(pairs), chunk_rows):
            users, items = pairs_t[s:s + chunk_rows].unbind(1)
            rows, cols = (bucket_items[user_bucket[users]] == items[:, None]).nonzero(
                as_tuple=True)
            seen_w[users[rows], cols] = 1
        distinct = np.unique(pairs[:, 0] * J + pairs[:, 1])
        cold = np.ones(I, bool)
        cold[distinct // J] = False
        return cls(U=torch.as_tensor(synth.U, device=dev), slab=slab, seen=seen_w,
                   index=index, cold=cold,
                   item_counts=np.bincount(distinct % J, minlength=J).astype(np.int64))

    # --------------------------------------------------------- quantization
    def quantize_int8(self, chunk_rows: int = 131072) -> None:
        """Per-user symmetric int8 on the store's device (`int8_rows`),
        chunked."""
        I, cap, K = self.slab.shape
        codes = torch.empty((I, cap, K), dtype=torch.int8, device=self.device)
        scale = torch.empty(I, dtype=torch.float32, device=self.device)
        for s in range(0, I, chunk_rows):
            e = min(s + chunk_rows, I)
            codes[s:e], scale[s:e] = int8_rows(self.slab[s:e])
        self.q_codes, self.q_scale = codes, scale

    def quantize_bf16(self) -> None:
        self.slab_bf16 = self.slab.to(torch.bfloat16)

    def int8_score_bound(self, users) -> np.ndarray:
        """Per-request analytic |Δscore| bound ||u||₁ · scale/2, float64.
        Computed on the host with the reference's numpy expression on the
        gathered rows, so it equals the reference's."""
        assert self.q_scale is not None, "quantize_int8 first"
        users = torch.as_tensor(np.asarray(users), device=self.device).long()
        u = self.U[users].cpu().numpy()
        sc = self.q_scale[users].cpu().numpy()
        return (np.abs(u).sum(axis=1) * sc * 0.5).astype(np.float64)

    def bf16_score_bound(self, users) -> np.ndarray:
        """Per-request analytic |Δscore| bound max_c Σ_k |u_k·v_kc| · 2⁻⁸,
        float64, on the host as `int8_score_bound`."""
        users = torch.as_tensor(np.asarray(users), device=self.device).long()
        u = np.abs(self.U[users].cpu().numpy())            # (n, K)
        w = np.abs(self.slab[users].cpu().numpy())         # (n, cap, K)
        return ((w * u[:, None, :]).sum(axis=2).max(axis=1)
                * _BF16_EPS).astype(np.float64)

    # ---------------------------------------------------------- row sharding
    def shard_rows(self, n_shards: int) -> list[tuple[int, "TiledFactorStore"]]:
        """Row sharding by views (no copy) of every tensor, user buckets
        rebased to shard-local rows. Returns [(row_start, shard_store), ...]
        along `sharding.dmf`'s ceil-div layout, so routing is
        ``user // rows_per_shard``."""
        from repro_torch.sharding.dmf import shard_row_slices

        def part(t, s, e):
            return None if t is None else t[s:e]
        out = []
        for s, e in shard_row_slices(self.n_users, n_shards):
            idx = dataclasses.replace(self.index, user_bucket=self.index.user_bucket[s:e])
            out.append((s, TiledFactorStore(
                U=self.U[s:e], slab=self.slab[s:e], seen=self.seen[s:e], index=idx,
                cold=self.cold[s:e], item_counts=self.item_counts,
                q_codes=part(self.q_codes, s, e), q_scale=part(self.q_scale, s, e),
                slab_bf16=part(self.slab_bf16, s, e))))
        return out


def store_from_numpy(U, slab, seen, index: CandidateIndex, cold, item_counts, *,
                     q_codes=None, q_scale=None, slab_bf16_bits=None,
                     device="cuda") -> TiledFactorStore:
    """A store from host arrays, e.g. a reference `TiledFactorStore`
    carried across field by field with ``np.asarray``. bf16 factors arrive
    as their uint16 bits (``slab_bf16.view(np.uint16)``) and become a
    `torch.bfloat16` view, so no bf16 numpy type is needed."""
    dev = device_lib.resolve(device)

    def put(x, dtype):
        return None if x is None else torch.as_tensor(np.asarray(x, dtype), device=dev)
    bf16 = None
    if slab_bf16_bits is not None:
        bits = np.ascontiguousarray(np.asarray(slab_bf16_bits, np.uint16)).view(np.int16)
        bf16 = torch.as_tensor(bits, device=dev).view(torch.bfloat16)
    return TiledFactorStore(
        U=put(U, np.float32), slab=put(slab, np.float32), seen=put(seen, np.int8),
        index=index, cold=np.asarray(cold, bool), item_counts=np.asarray(item_counts, np.int64),
        q_codes=put(q_codes, np.int8), q_scale=put(q_scale, np.float32), slab_bf16=bf16)


class TiledServingEngine:
    """Microbatched serving straight off a `TiledFactorStore`, on the
    store's device: the million-scale sibling of `ServingEngine`, with the
    same `ServingConfig`, `EngineStats` and popularity fallback (unknown,
    cold and empty-bucket requests get the flagged popularity slate).
    ``mode``: 'fp32' (bit for bit `ServingEngine.recommend` pruned on the
    same factors), 'int8' or 'bf16' (bounded score error)."""

    def __init__(self, store: TiledFactorStore,
                 cfg: ServingConfig = ServingConfig(), *, mode: str = "fp32"):
        assert mode in ("fp32", "int8", "bf16"), mode
        if mode == "int8" and store.q_codes is None:
            store.quantize_int8()
        if mode == "bf16" and store.slab_bf16 is None:
            store.quantize_bf16()
        assert cfg.prune, "the tiled store is the pruned candidate path"
        self.store = store
        self.cfg = cfg
        self.mode = mode
        self.stats = EngineStats()
        dev = store.device
        self._bucket_items = torch.as_tensor(store.index.bucket_items, dtype=torch.int32,
                                             device=dev)
        self._user_bucket = torch.as_tensor(store.index.user_bucket, dtype=torch.int64,
                                            device=dev)
        self._bucket_empty = (store.index.bucket_items < 0).all(axis=1)
        self._pop_items, self._pop_vals = _popularity(store.item_counts, cfg.k)
        self._plan = _DispatchPlan(dev, cfg.microbatch, cfg.k)
        self._kernel = ops.serve_topk_window if mode == "fp32" else ops.serve_topk_tiled_quant
        self._out_ptrs: set[int] = set()      # base addresses of the outputs handed out

    def _fallback_mask(self, user_ids: np.ndarray) -> np.ndarray:
        uids = np.asarray(user_ids)
        n = self.store.n_users
        unknown = (uids < 0) | (uids >= n)
        safe = np.clip(uids, 0, n - 1)
        return (unknown | self.store.cold[safe]
                | self._bucket_empty[self.store.index.user_bucket[safe]])

    def _operands(self) -> tuple[torch.Tensor, ...]:
        """Every tensor `_launch` reads in the engine's mode."""
        st = self.store
        win = {"fp32": (st.slab,), "int8": (st.q_codes, st.q_scale),
               "bf16": (st.slab_bf16,)}[self.mode]
        return (st.U, *win, self._user_bucket, self._bucket_items, st.seen)

    def _outputs(self, n: int) -> tuple[np.ndarray, np.ndarray, int]:
        """A call's outputs, vals (n, k) f32 and idx (n, k) i32, and whether
        this engine handed their memory out before (1) or not (0). On a
        card both are numpy views of one block of PyTorch's pinned caching
        host allocator, vals first, as the plan's packet is laid out: the
        block stays the caller's while either view lives, then goes back
        to the allocator's free list (no stream used it), and a later call
        of a like size gets it back with its pages resident instead of
        faulting in fresh ones. On the CPU they are fresh arrays (0)."""
        k = self.cfg.k
        if not self._plan.replay:
            return np.empty((n, k), np.float32), np.empty((n, k), np.int32), 0
        buf = torch.empty(8 * n * k, dtype=torch.uint8, pin_memory=True)
        ptr = buf.data_ptr()
        reused = int(ptr in self._out_ptrs)
        self._out_ptrs.add(ptr)
        return (buf[:4 * n * k].view(torch.float32).view(n, k).numpy(),
                buf[4 * n * k:].view(torch.int32).view(n, k).numpy(), reused)

    def _launch(self, ids: torch.Tensor):
        """One fixed-shape microbatch on the store's device, the ids already
        there: int8 and bf16 read the store in place
        (`ops.serve_topk_tiled_quant`: no gathers); fp32 gathers the windows
        off the device-resident store first (`ops.serve_topk_window`).
        Returns the slates on the store's device."""
        st, k = self.store, self.cfg.k
        if self.mode == "fp32":
            cand = self._bucket_items[self._user_bucket[ids]]
            return ops.serve_topk_window(st.U[ids], st.slab[ids], cand, st.seen[ids], k)
        Vq, scale = ((st.q_codes, st.q_scale) if self.mode == "int8"
                     else (st.slab_bf16, None))
        return ops.serve_topk_tiled_quant(ids, st.U, Vq, scale, self._user_bucket,
                                          self._bucket_items, st.seen, k)

    def recommend(self, user_ids, return_flags: bool = False):
        """Serve a batch of user ids, results in input order — the contract
        of `ServingEngine.recommend` (fallback slates flagged), in arrays
        the caller owns: no later call writes them while they live. On a
        card they are views of one block of pinned host memory
        (`_outputs`), held until the caller drops both; a later call gets
        the block back with its pages resident. On the CPU they are fresh
        arrays.

        Each microbatch goes through the engine's plan (`_DispatchPlan`):
        on a card one CUDA graph replay of `_launch`, captured on the
        first dispatch and again whenever an operand it reads moved
        (``stats.n_captures``); on the CPU the same phases call the
        kernels' plain versions.

        Each microbatch is one dispatch, in the reference's
        ``tiled.dispatch`` span: its args are ``mode``, the engine's
        ``dispatch`` number, ``rows`` launched (padding included),
        ``replay`` (1 where the plan replayed it on a card, else 0),
        ``out_reused`` (1 where the call's outputs start at an address this
        engine handed out before, else 0, as on every CPU dispatch),
        ``n_real`` and ``n_fallback``. Inside it, in order:
        ``tiled.prepare`` (the ids, padded with the first, into the plan's
        buffer), ``tiled.upload`` (one non-blocking copy to the card; none
        on the CPU), ``tiled.launch`` (the operands' pointers checked, the
        replay and its event; on the CPU the gathers for fp32 and the
        kernel's wrapper), ``tiled.readback`` (the wait for the event; on
        the CPU the slates as arrays) and ``tiled.finish`` (one copy of the
        plan's rows into the call's outputs, the stats); each has the
        ``dispatch`` arg."""
        user_ids = np.asarray(user_ids)
        R, k = self.cfg.microbatch, self.cfg.k
        n = len(user_ids)
        if n == 0:
            out = (np.empty((0, k), np.float32), np.empty((0, k), np.int32))
            return out + (np.empty(0, bool),) if return_flags else out
        flags = (self._fallback_mask(user_ids) if self.cfg.fallback
                 else np.zeros(n, bool))
        safe_ids = np.where(flags, 0, user_ids).astype(np.int64)
        vals, idx, reused = self._outputs(n)
        plan = self._plan
        t_call = time.perf_counter()
        for s in range(0, n, R):
            e = min(s + R, n)
            d = self.stats.n_dispatches
            with trace_lib.span("tiled.dispatch", mode=self.mode, dispatch=d, rows=R,
                                replay=int(plan.replay), out_reused=reused) as sp:
                with trace_lib.span("tiled.prepare", dispatch=d):
                    buf = plan.ids_np
                    buf[: e - s] = safe_ids[s:e]
                    buf[e - s:] = buf[0]   # pad with a real id (results dropped)
                with trace_lib.span("tiled.upload", dispatch=d):
                    t0 = time.perf_counter()
                    plan.upload()
                with trace_lib.span("tiled.launch", dispatch=d):
                    self.stats.n_captures += plan.launch(self._operands(), self._launch,
                                                         self._kernel)
                with trace_lib.span("tiled.readback", dispatch=d):
                    v, i = plan.wait()
                    t1 = time.perf_counter()
                with trace_lib.span("tiled.finish", dispatch=d):
                    vals[s:e] = v[: e - s]
                    idx[s:e] = i[: e - s]
                    self.stats.dispatch_seconds.append(t1 - t0)
                    self.stats.request_seconds.extend([t1 - t_call] * (e - s))
                    self.stats.n_dispatches += 1
                    self.stats.n_requests += e - s
                    if sp is not None:
                        sp.args.update(n_real=e - s, n_fallback=int(flags[s:e].sum()))
        if flags.any():
            _overwrite(vals, idx, flags, self._pop_items, self._pop_vals)
            self.stats.n_fallbacks += int(flags.sum())
        if return_flags:
            return vals, idx, flags
        return vals, idx

    @property
    def requests_per_sec(self) -> float:
        s = sum(self.stats.dispatch_seconds)
        return self.stats.n_requests / s if s > 0 else float("nan")
