"""Plain reference of the DMF cells, written from the paper (Alg. 1, Eqs.
2-11) in PyTorch and NumPy. It imports nothing of the program and takes
nothing the program made: it works out again the walk neighbour table, the
training stream's draws, every update and every slate from the benchmark's
own inputs (the data set, the seeds, the served factors).

Precision: the configurations state float32. ``dtype`` picks the precision
of the training state and arithmetic (float32 for the reference, bfloat16
for its control); the slates' truth is computed in float64, and
``tf32=True`` rounds the factors to TF32's 10-bit mantissa before scoring
(the control of the refresh cells). TF32 matrix products stay off.
"""
from __future__ import annotations

import numpy as np
import torch


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ----------------------------------------------------------------- graph
def neighbor_table(coords: np.ndarray, cities: np.ndarray, graph: dict, device):
    """The walk neighbour table of paper Eqs. 2-4: each user's N nearest
    same-city users (uniform weights, symmetrized), the row-normalized walk
    matrix W, and M = I + sum_{d=1..D} c^d W^d. Returns (idx (I, S) int64,
    wgt (I, S) float32): row i's nonzero columns of M in ascending order,
    padded with i at weight 0."""
    if not graph.get("uniform_weights", True) or not graph.get("same_city_only", True) \
            or graph.get("paper_literal", False):
        raise ValueError("the reference builds the paper's experimental graph only "
                         "(uniform weights, same-city neighbours, normalized walk)")
    N, D, c = graph["n_neighbors"], graph["walk_length"], graph.get("hop_damping", 1.0)
    xy = torch.as_tensor(np.asarray(coords, np.float32), device=device)
    city = torch.as_tensor(np.asarray(cities), device=device)
    I = xy.shape[0]
    # distances as the data's float32 gives them: (dx² + dy²) then sqrt
    dist = torch.sqrt((xy[:, None, :] - xy[None, :, :]).square().sum(-1).clamp_min(0.0))
    same = city[:, None] == city[None, :]
    same.fill_diagonal_(False)
    near = torch.topk(dist.masked_fill(~same, float("inf")), min(N, I), dim=1,
                      largest=False)
    A = torch.zeros((I, I), dtype=torch.float64, device=device)
    rows = torch.arange(I, device=device)[:, None].expand_as(near.indices)
    keep = torch.isfinite(near.values)
    A[rows[keep], near.indices[keep]] = 1.0
    A = torch.maximum(A, A.T)
    deg = A.sum(1, keepdim=True)
    Wn = torch.where(deg > 0, A.float() / deg.float().clamp_min(1e-12), 0.0).double()
    M = torch.eye(I, dtype=torch.float64, device=device)
    Wd = torch.eye(I, dtype=torch.float64, device=device)
    for d in range(1, D + 1):
        Wd = Wd @ Wn
        M += c ** d * Wd
    M = M.float()
    nz = M != 0
    S = max(int(nz.sum(1).max()), 1)
    order = torch.argsort((~nz).to(torch.int8), dim=1, stable=True)[:, :S]
    taken = torch.gather(nz, 1, order)
    self_idx = torch.arange(I, device=device)[:, None].expand(I, S)
    idx = torch.where(taken, order, self_idx)
    wgt = torch.where(taken, torch.gather(M, 1, order), 0.0)
    return idx.contiguous(), wgt.contiguous()


# --------------------------------------------------------------- sampler
def initial_users(seed: int, n_users: int, dim: int, init_scale: float):
    """The training job's initial U, the first draw of the job's stream,
    and the stream, which the epochs' samples continue."""
    rng = np.random.default_rng(seed)
    return rng.normal(0, init_scale, (n_users, dim)).astype(np.float32), rng


def sample_epoch(rng: np.random.Generator, train: np.ndarray, n_items: int, m: int):
    """One epoch's events: the train pairs in a fresh order, each followed
    by m unobserved negatives of its user (item uniform, r = 0, confidence
    1/m), all shuffled together (paper §Unobserved rating sample)."""
    pos = train[rng.permutation(len(train))]
    n = len(pos)
    neg_j = rng.integers(0, n_items, size=n * m)
    ui = np.concatenate([pos[:, 0], np.repeat(pos[:, 0], m)])
    vj = np.concatenate([pos[:, 1], neg_j])
    r = np.concatenate([np.ones(n, np.float32), np.zeros(n * m, np.float32)])
    conf = np.concatenate([np.ones(n, np.float32), np.full(n * m, 1.0 / m, np.float32)])
    order = rng.permutation(len(ui))
    return ui[order], vj[order], r[order], conf[order]


def epoch_senders(seed: int, train: np.ndarray, n_users: int, n_items: int, dim: int,
                  init_scale: float, m: int, B: int, epochs: int) -> list[np.ndarray]:
    """The senders of the events in whole rounds, epoch by epoch, of the
    job seeded ``seed`` (for the benchmark's operation counts)."""
    _, rng = initial_users(seed, n_users, dim, init_scale)
    out = []
    for _ in range(epochs):
        ui = sample_epoch(rng, train, n_items, m)[0]
        out.append(ui[: (len(ui) // B) * B])
    return out


# -------------------------------------------------------------- training
class Trainer:
    """Alg. 1 in rounds of B concurrent learner updates, on the device:
    every event of a round reads (u_i, p^i_j, q^i_j) as the round found
    them; u_i and q^i_j take -θ times their gradient (Eqs. 9, 11) and every
    receiver k of i's walk table takes -θ M[i, k] times the p gradient
    (Eq. 10 and lines 11-15), duplicates summed."""

    def __init__(self, hp: dict, n_items: int, table, U0: np.ndarray, dtype, device):
        self.hp, self.J, self.dtype = hp, n_items, dtype
        self.idx, self.wgt = table[0], table[1].to(dtype)
        I, K = U0.shape
        self.U = torch.tensor(U0, dtype=dtype, device=device)     # a copy: U0 stays the start
        self.P = torch.zeros((I, n_items, K), dtype=dtype, device=device)
        self.Q = torch.zeros((I, n_items, K), dtype=dtype, device=device)
        self.device = device

    def round(self, ui, vj, r, conf) -> float:
        hp = self.hp
        th = hp["lr"]
        u, p, q = self.U[ui], self.P[ui, vj], self.Q[ui, vj]
        raw = r - (u * (p + q)).sum(-1)
        err = (conf * raw)[:, None]
        gu = -err * (p + q) + hp["alpha"] * u
        gp = -err * u + hp["beta"] * p
        gq = -err * u + hp["gamma"] * q
        self.U.index_put_((ui,), -th * gu, accumulate=True)
        self.Q.index_put_((ui, vj), -th * gq, accumulate=True)
        recv = self.idx[ui]                                    # (B, S)
        msg = self.wgt[ui][:, :, None] * gp[:, None, :]        # (B, S, K)
        self.P.index_put_((recv, vj[:, None].expand_as(recv)), -th * msg, accumulate=True)
        return float((0.5 * conf.double() * raw.double() ** 2).sum())

    def epoch(self, rng, train: np.ndarray, B: int) -> float:
        """One epoch in whole rounds; the mean loss of its events."""
        ui, vj, r, conf = sample_epoch(rng, train, self.J, self.hp["neg_samples"])
        nb = len(ui) // B
        dev = self.device
        ui, vj = (torch.as_tensor(x[: nb * B], device=dev).reshape(nb, B) for x in (ui, vj))
        r, conf = (torch.as_tensor(x[: nb * B], device=dev).reshape(nb, B).to(self.dtype)
                   for x in (r, conf))
        total = sum(self.round(ui[b], vj[b], r[b], conf[b]) for b in range(nb))
        return total / max(nb * B, 1)

    def leaves(self) -> dict:
        return {"U": self.U, "P": self.P, "Q": self.Q}


def change_norms(leaves: dict, U0) -> dict:
    """Each leaf's L2 norm of its change from the job's start (P and Q
    start at 0), in float64."""
    out = {}
    for name, x in leaves.items():
        if name == "U":
            x = x.double() - torch.as_tensor(U0, device=x.device).double()
        out[name] = float(torch.linalg.vector_norm(x, dtype=torch.float64))
    return out


def train_job(train: np.ndarray, table, hp: dict, n_items: int, seed: int, B: int, epochs: int,
              dtype=torch.float32, device="cpu") -> dict:
    """The first ``epochs`` epochs of the job seeded ``seed``: each epoch's
    loss, and each leaf's change norm after each epoch."""
    tf32_off()
    U0, rng = initial_users(seed, table[0].shape[0], hp["dim"], hp["init_scale"])
    t = Trainer(hp, n_items, table, U0, dtype, device)
    losses, norms = [], []
    for _ in range(epochs):
        losses.append(t.epoch(rng, train, B))
        norms.append(change_norms(t.leaves(), U0))
    del t
    return {"losses": losses, "norms": norms}


# --------------------------------------------------------------- serving
def popularity(train: np.ndarray, n_items: int, k: int):
    """The fallback slate of a user with no check-in: the k POIs with the
    most train check-ins (ties to the lower id), scored count / max count."""
    counts = np.bincount(train[:, 1], minlength=n_items).astype(np.int64)
    top = np.argsort(-counts, kind="stable")[:k]
    return top.astype(np.int32), (counts[top] / max(int(counts.max()), 1)).astype(np.float32)


def seen_mask(train: np.ndarray, n_users: int, n_items: int, device) -> torch.Tensor:
    seen = torch.zeros((n_users, n_items), dtype=torch.bool, device=device)
    t = torch.as_tensor(train, device=device)
    seen[t[:, 0], t[:, 1]] = True
    return seen


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits, to nearest)."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x1000) & ~0x1FFF
    return b.view(torch.float32)


def slate_truth(U, P, Q, seen: torch.Tensor, k: int, block: int = 256, tf32: bool = False):
    """Every user's best k unseen POIs by u_i . (p^i_j + q^i_j): (vals (I,
    k) float64, ids (I, k) int64, scale (I,) float64), ties to the lower
    id. ``scale`` is the user's largest sum_k |u_ik v_ijk| over unseen POIs,
    the size of the rounding a score can carry. ``tf32`` scores the
    TF32-rounded factors in float32 instead (the control)."""
    I = U.shape[0]
    vals, ids, scale = [], [], []
    for s in range(0, I, block):
        e = min(s + block, I)
        if tf32:
            u, v = _tf32(U[s:e]), _tf32(P[s:e] + Q[s:e])
            sc = torch.einsum("uk,ujk->uj", u, v)
            cond = torch.einsum("uk,ujk->uj", u.abs(), v.abs())
        else:
            u = U[s:e].double()
            v = P[s:e].double() + Q[s:e].double()
            sc = torch.einsum("uk,ujk->uj", u, v)
            cond = torch.einsum("uk,ujk->uj", u.abs(), v.abs())
        m = seen[s:e]
        sc = sc.double().masked_fill(m, float("-inf"))
        srt, pos = torch.sort(sc, dim=1, descending=True, stable=True)
        vals.append(srt[:, :k])
        ids.append(pos[:, :k])
        scale.append(cond.double().masked_fill(m, 0.0).amax(1))
        del u, v, sc, cond
    return torch.cat(vals), torch.cat(ids), torch.cat(scale)


def served_scores(U, P, Q, users: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """float64 u_i . (p^i_j + q^i_j) of served ids (n, k) of users (n,)."""
    safe = ids.clamp(0, P.shape[1] - 1)
    rows = users[:, None].expand_as(safe)
    v = P[rows, safe].double() + Q[rows, safe].double()
    return torch.einsum("nk,njk->nj", U[users].double(), v)
