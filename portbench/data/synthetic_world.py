"""The million-user world of the tiled deployment: a frozen copy of the
repository's `synthetic_world` (`repro_torch/serving/store.py`, itself
equal to the JAX package's draw for draw), so that the benchmark makes its
own users and POIs and hands the same arrays to the program and to the
reference.

Cities take Zipf weights; users and POIs pick a city by weight and sit at
Gaussian offsets around its centre. Every draw comes from one generator
seeded with ``seed``, in a fixed order.
"""
from __future__ import annotations

import numpy as np


def generate(n_users: int, n_items: int, n_cities: int, seed: int, zipf_a: float = 0.8,
             city_sigma: float = 0.03):
    """(user_city (I,) int32, item_city (J,) int32, user_coords (I, 2)
    float64, item_coords (J, 2) float64)."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n_cities + 1) ** zipf_a
    w /= w.sum()
    user_city = rng.choice(n_cities, size=n_users, p=w).astype(np.int32)
    item_city = rng.choice(n_cities, size=n_items, p=w).astype(np.int32)
    centers = rng.uniform(0.0, 1.0, size=(n_cities, 2))
    user_coords = centers[user_city] + city_sigma * rng.standard_normal((n_users, 2))
    item_coords = centers[item_city] + city_sigma * rng.standard_normal((n_items, 2))
    return user_city, item_city, user_coords.astype(np.float64), item_coords.astype(np.float64)
