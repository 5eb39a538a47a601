"""Synthetic POI check-in data — a numpy copy of
`src/repro/data/synthetic_poi.py` (`POIDatasetConfig`, `POIDataset`,
`generate`, `foursquare_like`, `alipay_like`).

The draws are the reference's, in the reference's order, so the arrays
equal the reference's bit for bit for the same seed. The generator
reproduces the structure the paper's method exploits: users and POIs
clustered in cities (location aggregation, paper Fig. 2), geographically
smooth tastes, power-law activity and popularity, implicit feedback.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class POIDatasetConfig:
    n_users: int = 500
    n_items: int = 400
    n_ratings: int = 4500
    n_cities: int = 12
    idiosyncrasy: float = 0.9
    latent_dim: int = 8
    cross_city_frac: float = 0.03
    taste_spatial_scale: float = 0.35
    distance_weight: float = 1.0
    popularity_scale: float = 0.8
    test_frac: float = 0.10
    seed: int = 0


@dataclasses.dataclass
class POIDataset:
    config: POIDatasetConfig
    train: np.ndarray        # (n_train, 2) int (user, item)
    test: np.ndarray         # (n_test, 2) int
    user_coords: np.ndarray  # (I, 2) float
    user_city: np.ndarray    # (I,) int
    item_city: np.ndarray    # (J,) int

    @property
    def n_users(self) -> int:
        return self.config.n_users

    @property
    def n_items(self) -> int:
        return self.config.n_items


def _zipf_sizes(n_bins: int, total: int, a: float, rng: np.random.Generator) -> np.ndarray:
    w = 1.0 / np.arange(1, n_bins + 1) ** a
    w = w / w.sum()
    sizes = rng.multinomial(total, w)
    return np.maximum(sizes, 1)


def _cum_assign(n: int, c: int, rng: np.random.Generator) -> np.ndarray:
    return _zipf_sizes(c, n, 0.8, rng)


def generate(cfg: POIDatasetConfig) -> POIDataset:
    rng = np.random.default_rng(cfg.seed)
    I, J, C = cfg.n_users, cfg.n_items, cfg.n_cities

    # geography: city centers on a plane, users/items gaussian around them
    centers = rng.uniform(0.0, 10.0 * np.sqrt(C), size=(C, 2))
    user_city = np.repeat(np.arange(C), _cum_assign(I, C, rng))[:I]
    item_city = np.repeat(np.arange(C), _cum_assign(J, C, rng))[:J]
    rng.shuffle(user_city)
    rng.shuffle(item_city)
    user_coords = centers[user_city] + rng.normal(0, 1.0, size=(I, 2))
    item_coords = centers[item_city] + rng.normal(0, 1.0, size=(J, 2))

    # ground-truth taste: city mean + spatially smooth local component
    K = cfg.latent_dim
    city_taste = rng.normal(0, 1.0, size=(C, K))
    proj = rng.normal(0, cfg.taste_spatial_scale, size=(2, K))
    u_true = (
        city_taste[user_city] + user_coords @ proj
        + cfg.idiosyncrasy * rng.normal(0, 1, (I, K))
    )
    v_true = city_taste[item_city] + item_coords @ proj + 0.3 * rng.normal(0, 1, (J, K))

    # activity / popularity power laws
    user_act = _zipf_sizes(I, cfg.n_ratings, 1.1, rng)
    log_pop = cfg.popularity_scale * (-np.log(np.arange(1, J + 1)))
    rng.shuffle(log_pop)

    # check-ins: mostly home-city POIs, softmax over taste-match +
    # popularity - distance
    pairs = set()
    records = []
    items_by_city = [np.flatnonzero(item_city == c) for c in range(C)]
    all_items = np.arange(J)
    for i in range(I):
        n_i = int(user_act[i])
        home = items_by_city[user_city[i]]
        for _ in range(n_i):
            pool = home if (rng.random() > cfg.cross_city_frac and len(home) > 0) else all_items
            dist = np.linalg.norm(item_coords[pool] - user_coords[i], axis=-1)
            logits = (
                0.5 * (v_true[pool] @ u_true[i])
                + log_pop[pool]
                - cfg.distance_weight * dist
            )
            logits = logits - logits.max()
            p = np.exp(logits)
            p /= p.sum()
            j = int(rng.choice(pool, p=p))
            if (i, j) not in pairs:
                pairs.add((i, j))
                records.append((i, j))
    records = np.array(records, dtype=np.int64)

    # 90/10 split (paper: random 90% train / 10% test)
    n = len(records)
    perm = rng.permutation(n)
    n_test = max(1, int(round(cfg.test_frac * n)))
    test = records[perm[:n_test]]
    train = records[perm[n_test:]]
    return POIDataset(cfg, train, test, user_coords.astype(np.float32), user_city, item_city)


def foursquare_like(reduced: bool = True, seed: int = 0) -> POIDataset:
    """Table 1 Foursquare row: 6,524 users / 3,197 POIs / 26,186 ratings / 117 cities."""
    if reduced:
        cfg = POIDatasetConfig(n_users=500, n_items=320, n_ratings=4500, n_cities=12, seed=seed)
    else:
        cfg = POIDatasetConfig(n_users=6524, n_items=3197, n_ratings=26186, n_cities=117, seed=seed)
    return generate(cfg)


def alipay_like(reduced: bool = True, seed: int = 1) -> POIDataset:
    """Table 1 Alipay row: 5,996 users / 7,404 POIs / 18,978 ratings / 298 cities."""
    if reduced:
        cfg = POIDatasetConfig(n_users=450, n_items=560, n_ratings=3400, n_cities=24, seed=seed)
    else:
        cfg = POIDatasetConfig(n_users=5996, n_items=7404, n_ratings=18978, n_cities=298, seed=seed)
    return generate(cfg)
