"""Synthetic POI check-ins at the paper's Table 1 sizes: a frozen copy of
the repository's generator (`repro_torch/data/synthetic_poi.py`, itself
equal to the JAX package's draw for draw), so that the benchmark makes its
own data and hands the same arrays to the program and to the reference.

Users and POIs are clustered in cities (the location aggregation of the
paper's Fig. 2), tastes vary smoothly in space, activity and popularity
follow power laws, and feedback is implicit (a check-in is r = 1). Every
draw comes from one generator seeded with ``seed``, in a fixed order.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# the generator's shape parameters and their defaults; a configuration's
# "dataset" object sets the sizes and may set any of these
DEFAULTS = dict(idiosyncrasy=0.9, latent_dim=8, cross_city_frac=0.03, taste_spatial_scale=0.35,
                distance_weight=1.0, popularity_scale=0.8, test_frac=0.10)
SIZES = ("n_users", "n_items", "n_ratings", "n_cities")


@dataclasses.dataclass
class Dataset:
    train: np.ndarray        # (n_train, 2) int64 (user, item)
    test: np.ndarray         # (n_test, 2) int64
    user_coords: np.ndarray  # (I, 2) float32
    user_city: np.ndarray    # (I,) int64
    item_city: np.ndarray    # (J,) int64
    n_users: int
    n_items: int


def _zipf_sizes(n_bins: int, total: int, a: float, rng: np.random.Generator) -> np.ndarray:
    w = 1.0 / np.arange(1, n_bins + 1) ** a
    w = w / w.sum()
    return np.maximum(rng.multinomial(total, w), 1)


def generate(params: dict, seed: int) -> Dataset:
    """The data set of a configuration's ``params`` (the four sizes of
    `SIZES`, and optionally any key of `DEFAULTS`) from ``seed``."""
    unknown = set(params) - set(SIZES) - set(DEFAULTS)
    if unknown:
        raise ValueError(f"unknown dataset keys {sorted(unknown)}")
    p = {**DEFAULTS, **params}
    rng = np.random.default_rng(seed)
    I, J, C = p["n_users"], p["n_items"], p["n_cities"]

    centers = rng.uniform(0.0, 10.0 * np.sqrt(C), size=(C, 2))
    user_city = np.repeat(np.arange(C), _zipf_sizes(C, I, 0.8, rng))[:I]
    item_city = np.repeat(np.arange(C), _zipf_sizes(C, J, 0.8, rng))[:J]
    rng.shuffle(user_city)
    rng.shuffle(item_city)
    user_coords = centers[user_city] + rng.normal(0, 1.0, size=(I, 2))
    item_coords = centers[item_city] + rng.normal(0, 1.0, size=(J, 2))

    K = p["latent_dim"]
    city_taste = rng.normal(0, 1.0, size=(C, K))
    proj = rng.normal(0, p["taste_spatial_scale"], size=(2, K))
    u_true = (city_taste[user_city] + user_coords @ proj
              + p["idiosyncrasy"] * rng.normal(0, 1, (I, K)))
    v_true = city_taste[item_city] + item_coords @ proj + 0.3 * rng.normal(0, 1, (J, K))

    user_act = _zipf_sizes(I, p["n_ratings"], 1.1, rng)
    log_pop = p["popularity_scale"] * (-np.log(np.arange(1, J + 1)))
    rng.shuffle(log_pop)

    # check-ins: mostly home-city POIs, softmax over taste match +
    # popularity - distance; repeated pairs are kept once
    pairs = set()
    records = []
    items_by_city = [np.flatnonzero(item_city == c) for c in range(C)]
    all_items = np.arange(J)
    for i in range(I):
        home = items_by_city[user_city[i]]
        for _ in range(int(user_act[i])):
            pool = home if (rng.random() > p["cross_city_frac"] and len(home) > 0) else all_items
            dist = np.linalg.norm(item_coords[pool] - user_coords[i], axis=-1)
            logits = 0.5 * (v_true[pool] @ u_true[i]) + log_pop[pool] - p["distance_weight"] * dist
            logits = logits - logits.max()
            prob = np.exp(logits)
            prob /= prob.sum()
            j = int(rng.choice(pool, p=prob))
            if (i, j) not in pairs:
                pairs.add((i, j))
                records.append((i, j))
    records = np.array(records, dtype=np.int64)

    perm = rng.permutation(len(records))
    n_test = max(1, int(round(p["test_frac"] * len(records))))
    return Dataset(train=records[perm[n_test:]], test=records[perm[:n_test]],
                   user_coords=user_coords.astype(np.float32), user_city=user_city,
                   item_city=item_city, n_users=I, n_items=J)
