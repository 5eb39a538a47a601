"""Plain reference of the million-user int8 refresh cell, in PyTorch and
NumPy. It imports nothing of the program and takes nothing the program
made: from the benchmark's own inputs (the world's cities and coordinates,
the factor tables B1, B2, s and U, the check-in pairs) it works out again
each user's geohash cell, window, int8 codes and slate.

- Cells: every city whose POIs number more than ``cell_cap`` is halved at
  the midpoint of its POIs' bounding box, longitude first, then latitude,
  alternating, until each cell holds at most ``cell_cap`` POIs (a half
  that would be empty stops the split; so does a depth of 16). Users
  follow the same cuts by their own coordinates. The split is made level
  by level over all cities at once.
- Windows: a user i's window holds v_j = B1[j] * s[i] + B2[j] for each POI
  j of the user's cell, as two rounded float32 operations (a multiply,
  then an add; no fused multiply-add), and ``cap - |cell|`` padding
  columns, where ``cap`` is the largest cell rounded up to a multiple of
  ``pad_to``. The deployment defines a padding column as POI 0's view.
- int8: ``scale = max(max|window| / 127, 1e-12)`` over the whole window,
  padding columns included, the division by a float32 tensor; codes =
  round(v / scale), half to even, clipped to ±127. Padding counts in the
  scale as the deployment defines it; how many users' scales it sets
  depends on the factors (at full size: one user, 1.9% wider, on the
  source's factors; up to 1.3% of users, up to 49% wider, on others), and
  a reference that left it out would misread those users' codes.
- Slates: the k best unseen POIs of the cell by u_i . (code_j * scale_i),
  in float64, ties to the lower POI id; a cell with fewer than k unseen
  POIs leaves dead slots (id -1). A user with no check-in, or in a cell
  with no POI, gets the popularity slate: the k POIs with the most
  distinct check-ins (ties to the lower id), scored count / max count.

Precision: the windows and codes in float32 as the deployment states them
(TF32 off; nothing here multiplies matrices), the truth in float64.
``serve`` gives the slates of the unquantized float32 or of the bfloat16
window too, which the limits are set against.
"""
from __future__ import annotations

import numpy as np
import torch

DEAD = -1e30     # a dead slot's score, as the program returns it


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def cells(item_city, user_city, item_coords, user_coords, cell_cap: int, max_depth: int = 16):
    """The geohash split: (cell_of_item (J,) int64, cell_of_user (I,)
    int64), cells numbered 0.. in no particular order. A city with users
    and no POI is one empty cell."""
    node_i = np.asarray(item_city, np.int64).copy()
    node_u = np.asarray(user_city, np.int64).copy()
    xy_i = np.asarray(item_coords, np.float64)
    xy_u = np.asarray(user_coords, np.float64)
    n_nodes = int(max(node_i.max(initial=-1), node_u.max(initial=-1))) + 1
    stopped = np.zeros(n_nodes, bool)
    for depth in range(max_depth):
        count = np.bincount(node_i, minlength=n_nodes)
        split = (count > cell_cap) & ~stopped
        if not split.any():
            break
        x_i, x_u = xy_i[:, depth % 2], xy_u[:, depth % 2]
        lo = np.full(n_nodes, np.inf)
        hi = np.full(n_nodes, -np.inf)
        np.minimum.at(lo, node_i, x_i)
        np.maximum.at(hi, node_i, x_i)
        mid = np.where(split, 0.5 * (np.where(split, lo, 0.0) + np.where(split, hi, 0.0)), 0.0)
        left_i = x_i <= mid[node_i]
        n_left = np.bincount(node_i[left_i], minlength=n_nodes)
        flat = split & ((n_left == 0) | (n_left == count))     # co-located POIs
        stopped |= flat
        split &= ~flat
        child = n_nodes + 2 * (np.cumsum(split) - 1)           # left child; right is +1
        moved = split[node_i]
        node_i[moved] = child[node_i[moved]] + ~left_i[moved]
        moved = split[node_u]
        node_u[moved] = child[node_u[moved]] + (x_u[moved] > mid[node_u[moved]])
        n_new = 2 * int(split.sum())
        stopped = np.concatenate([stopped, np.zeros(n_new, bool)])
        n_nodes += n_new
    _, compact = np.unique(np.concatenate([node_i, node_u]), return_inverse=True)
    return compact[: len(node_i)].astype(np.int64), compact[len(node_i):].astype(np.int64)


class Reference:
    """The cell's truth, worked out from the benchmark's inputs on
    ``device``: ``world`` = (user_city, item_city, user_coords,
    item_coords), ``factors`` = {"B1", "B2", "s", "U"} host float32 arrays,
    ``checkins`` (m, 2) (user, POI) pairs. ``split`` may hand in
    `cells`'s result for the same world and ``cell_cap``."""

    def __init__(self, world, factors: dict, checkins: np.ndarray, *, cell_cap: int,
                 pad_to: int, k: int, device, split=None, block: int = 65536):
        tf32_off()
        user_city, item_city, user_coords, item_coords = world
        cell_i, cell_u = split if split is not None else cells(
            item_city, user_city, item_coords, user_coords, cell_cap)
        I, J = len(cell_u), len(cell_i)
        self.I, self.J, self.k, self.block, self.dev = I, J, k, block, device
        n_cells = int(max(cell_i.max(initial=-1), cell_u.max(initial=-1))) + 1
        size = np.bincount(cell_i, minlength=n_cells)
        width = max(int(size.max(initial=0)), 1)
        self.cap = max(-(-width // pad_to) * pad_to, pad_to)
        # each cell's POIs ascending, padded with J so that rows stay sorted
        order = np.lexsort((np.arange(J), cell_i))
        table = np.full((n_cells, width), J, np.int64)
        starts = np.concatenate([[0], np.cumsum(size)[:-1]])
        col = np.arange(J) - np.repeat(starts, size)
        table[cell_i[order], col] = order
        put = lambda x: torch.as_tensor(x, device=device)
        self.table, self.size, self.cell_u = put(table), put(size), put(cell_u)
        self.B1, self.B2 = put(factors["B1"]), put(factors["B2"])
        self.s, self.U = put(factors["s"]), put(factors["U"])
        pairs = np.asarray(checkins, np.int64).reshape(-1, 2)
        self.seen_keys = put(np.unique(pairs[:, 0] * J + pairs[:, 1]))
        distinct = self.seen_keys.cpu().numpy()
        counts = np.bincount(distinct % J, minlength=J)
        self.pop_ids = np.argsort(-counts, kind="stable")[:k].astype(np.int32)
        self.pop_vals = (counts[self.pop_ids] / max(int(counts.max(initial=0)), 1)).astype(
            np.float32)
        cold = np.ones(I, bool)
        cold[distinct // J] = False
        self.fallback = cold | (size[cell_u] == 0)

    # ------------------------------------------------------------ windows
    def _block(self, a: int, b: int, precision: str):
        """Users [a, b): (items (n, W) int64 with J as padding, live (n, W)
        unseen POIs of the cell, scores (n, W) float64 of the int8 codes,
        their scale (n,), and the window in ``precision`` as float32)."""
        users = torch.arange(a, b, device=self.dev)
        items = self.table[self.cell_u[users]]
        real = items < self.J
        safe = items.clamp_max(self.J - 1)
        s = self.s[users]
        v = self.B1[safe] * s[:, None, None]
        v = v + self.B2[safe]
        v0 = self.B1[0] * s[:, None]
        v0 = v0 + self.B2[0]
        peak = v.abs().masked_fill(~real[..., None], 0.0).amax(dim=(1, 2))
        padded = self.size[self.cell_u[users]] < self.cap
        peak = torch.maximum(peak, torch.where(padded, v0.abs().amax(1), 0.0))
        d127 = torch.tensor(127.0, dtype=torch.float32, device=self.dev)
        scale = (peak / d127).clamp_min(1e-12)
        codes = torch.round(v / scale[:, None, None]).clamp(-127, 127)
        deq = codes.double() * scale.double()[:, None, None]
        u = self.U[users].double()
        scores = (deq * u[:, None, :]).sum(-1)
        size = (deq.abs() * u.abs()[:, None, :]).sum(-1)
        seen = torch.isin(users[:, None] * self.J + items, self.seen_keys) & real
        live = real & ~seen
        window = {"int8": codes * scale[:, None, None], "fp32": v,
                  "bf16": v.to(torch.bfloat16).float()}[precision]
        return items, live, scores, size.masked_fill(~live, 0.0).amax(1), window

    def serve(self, precision: str = "int8"):
        """Every user's slate from the window in ``precision`` ("int8",
        "fp32" or "bf16"), scored in float32: (vals (I, k) float32, ids (I,
        k) int32) in user order, dead slots (DEAD, -1), fallback users the
        popularity slate."""
        vals = np.empty((self.I, self.k), np.float32)
        ids = np.empty((self.I, self.k), np.int32)
        for a in range(0, self.I, self.block):
            b = min(a + self.block, self.I)
            items, live, _, _, w = self._block(a, b, precision)
            sc = (w * self.U[a:b][:, None, :]).sum(-1).masked_fill(~live, float("-inf"))
            top, pos = _top(sc, self.k)
            got = torch.gather(items, 1, pos.clamp_max(items.shape[1] - 1))
            dead = ~torch.isfinite(top)
            vals[a:b] = top.masked_fill(dead, DEAD).cpu().numpy()
            ids[a:b] = got.masked_fill(dead, -1).cpu().numpy()
        vals[self.fallback] = self.pop_vals
        ids[self.fallback] = self.pop_ids
        return vals, ids

    # -------------------------------------------------------------- judge
    def judge(self, passes) -> dict:
        """Readings over served passes, each (vals (I, k), ids (I, k)) in
        user order:

        - ``score_gap``: the widest gap between a served score and the
          truth's score of the served POI, over the user's score scale
          (the largest sum_k |u_ik code_jk scale_i| over unseen POIs);
        - ``rank_gap``: the widest shortfall of a served POI's true score
          below the truth's score at the same rank, over that scale;
        - ``bad_slates``: slates of a user served from the factors with an
          id outside the user's cell, repeated or seen, a live slot dead or
          a dead one live; and fallback slates that are not the popularity
          slate, ids and values both."""
        k = self.k
        score_gap = rank_gap = 0.0
        bad = 0
        rank = torch.arange(k, device=self.dev)
        for a in range(0, self.I, self.block):
            b = min(a + self.block, self.I)
            items, live, scores, scale, _ = self._block(a, b, "int8")
            truth, _ = _top(scores.masked_fill(~live, float("-inf")), k)
            n_live = live.sum(1, keepdim=True)
            fb = torch.as_tensor(self.fallback[a:b], device=self.dev)
            users = torch.arange(a, b, device=self.dev)
            for vals, ids in passes:
                sid = torch.as_tensor(ids[a:b].astype(np.int64), device=self.dev)
                sval = torch.as_tensor(vals[a:b], device=self.dev).double()
                want = rank[None, :] < n_live                    # slots that must be live
                pos = torch.searchsorted(items, sid).clamp_max(items.shape[1] - 1)
                in_cell = (torch.gather(items, 1, pos) == sid) & (sid >= 0)
                seen = torch.isin(users[:, None] * self.J + sid, self.seen_keys)
                srt = torch.sort(sid.masked_fill(~want, -1), dim=1).values
                repeated = ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any(1)
                wrong = (want & (~in_cell | seen)) | (~want & (sid != -1))
                bad_warm = (wrong.any(1) | repeated) & ~fb
                pop_ok = ((sid == torch.as_tensor(self.pop_ids, device=self.dev)).all(1)
                          & (sval == torch.as_tensor(self.pop_vals, device=self.dev)
                             .double()).all(1))
                bad += int(bad_warm.sum()) + int((fb & ~pop_ok).sum())
                ok = want & in_cell & ~fb[:, None]
                if not ok.any():
                    continue
                served = torch.gather(scores, 1, pos)
                sc = scale.clamp_min(1e-30)[:, None]
                g = ((sval - served).abs() / sc).masked_fill(~ok, 0.0)
                r = ((truth - served).clamp_min(0.0) / sc).masked_fill(~ok, 0.0)
                score_gap = max(score_gap, float(g.max()))
                rank_gap = max(rank_gap, float(r.max()))
        return {"score_gap": score_gap, "rank_gap": rank_gap, "bad_slates": float(bad)}


def _top(scores: torch.Tensor, k: int):
    """The k best columns a row, ties to the lower column (the rows' POIs
    ascend), rows narrower than k padded with -inf."""
    if scores.shape[1] < k:
        scores = torch.cat([scores, scores.new_full((scores.shape[0], k - scores.shape[1]),
                                                    float("-inf"))], 1)
    top, pos = torch.sort(scores, dim=1, descending=True, stable=True)
    return top[:, :k], pos[:, :k]
