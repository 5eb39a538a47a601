"""The comparisons that decide a run's ``correct``: what the timed path
produced, read against the plain reference (`reference/dmf.py`). Each
function returns readings, one number each, that `verdict` holds against
the cell's limits (``limits/<workload>.json``); a reading above its limit,
or one that is not a number, makes the run not correct.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import dmf as ref


def judge_slates(served, U, P, Q, train: np.ndarray, k: int) -> dict:
    """Readings over served slates ``served`` = (users (n,), vals (n, k),
    ids (n, k)), host arrays, against the slates the reference works out
    from the served factors U, P, Q (on their device) and the train pairs:

    - ``score_gap``: the widest gap between a served score and the
      reference's score of the served POI, over the user's score scale;
    - ``rank_gap``: the widest shortfall of a served POI's reference score
      below the reference's score at the same rank, over that scale (0 for
      a true top-k; a near tie swapped reads the tie's width);
    - ``bad_slates``: slates with an id out of range, repeated or already
      seen, and fallback slates (users with no check-in) that are not the
      popularity slate, ids and values both.
    """
    users, vals, ids = served
    dev = U.device
    I, J = U.shape[0], P.shape[1]
    seen = ref.seen_mask(train, I, J, dev)
    t_vals, _, scale = ref.slate_truth(U, P, Q, seen, k)
    cold = np.ones(I, bool)
    cold[np.unique(train[:, 0])] = False
    pop_ids, pop_vals = ref.popularity(train, J, k)

    is_cold = cold[users]
    fb = is_cold.nonzero()[0]
    bad_fb = ((ids[fb] != pop_ids[None]).any(1) | (vals[fb] != pop_vals[None]).any(1))
    warm = (~is_cold).nonzero()[0]
    u = torch.as_tensor(users[warm], device=dev)
    sid = torch.as_tensor(ids[warm].astype(np.int64), device=dev)
    sval = torch.as_tensor(vals[warm], device=dev).double()
    in_range = (sid >= 0) & (sid < J)
    srt = torch.sort(sid, dim=1).values
    repeated = (srt[:, 1:] == srt[:, :-1]).any(1)
    was_seen = seen[u[:, None].expand_as(sid), sid.clamp(0, J - 1)] & in_range
    bad_warm = ~in_range.all(1) | repeated | was_seen.any(1)
    sc = scale[u].clamp_min(1e-30)[:, None]
    ref_served = ref.served_scores(U, P, Q, u, sid)
    score_gap = ((sval - ref_served).abs() / sc).masked_fill(~in_range, 0.0)
    rank_gap = ((t_vals[u] - ref_served).clamp_min(0.0) / sc).masked_fill(~in_range, 0.0)
    n_bad = int(bad_fb.sum()) + int(bad_warm.sum())
    return {"score_gap": float(score_gap.max()) if len(warm) else 0.0,
            "rank_gap": float(rank_gap.max()) if len(warm) else 0.0,
            "bad_slates": float(n_bad)}


def judge_training(prog: dict, want: dict) -> dict:
    """Readings of a training job's first epochs, the program's ``prog``
    against the reference's ``want`` (each {"losses": [one an epoch],
    "norms": [{leaf: change norm}, ...]}):

    - ``loss_gap``: the widest relative gap of an epoch's loss;
    - ``grad_gap``: after the first epoch, the worst leaf's gap between the
      two change norms (the first gradient as SGD applied it, times θ),
      over the larger of the reference's norm of that leaf and of the
      median leaf;
    - ``change_gap``: the same after the last epoch compared (``norms``
      holds the first epoch's and the last epoch's).

    A leaf whose first reference change is under a thousandth of the
    median leaf's moves by rounding alone and is left out of both."""
    n = len(want["losses"])
    loss_gap = max(abs(prog["losses"][t] - want["losses"][t]) / abs(want["losses"][t])
                   for t in range(n))
    first = want["norms"][0]
    med0 = float(np.median(list(first.values())))
    leaves = [name for name, v in first.items() if v >= 1e-3 * med0]

    def gap(t):
        w = want["norms"][t]
        med = float(np.median(list(w.values())))
        return max(abs(prog["norms"][t][name] - w[name]) / max(w[name], med) for name in leaves)
    return {"loss_gap": loss_gap, "grad_gap": gap(0), "change_gap": gap(-1)}


def verdict(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(every reading within its limit, {name: {"value", "limit"}}). A
    reading that is not a finite number fails; so does a limit with no
    reading."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = readings.get(name, float("nan"))
        checks[name] = {"value": v, "limit": limit}
        ok = ok and math.isfinite(v) and v <= limit
    return ok, checks
