"""The port's host-side inputs equal the reference's: synthetic data, user
graph, neighbor table, candidate index, the event sampler, metrics and the
initial state. Everything here is numpy on both sides, so arrays are
compared for equality; only the neighbor table's float32 weights carry a
1e-6 tolerance (they equal the reference's today, the tolerance is the
stated contract)."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs import dmf_foursquare as ref_fsq  # noqa: E402
from repro.core import dmf as ref_dmf  # noqa: E402
from repro.core import graph as ref_graph  # noqa: E402
from repro.core import metrics as ref_metrics  # noqa: E402
from repro.data import synthetic_poi as ref_poi  # noqa: E402
from repro.obs import metrics as ref_obs  # noqa: E402
from repro.serving import candidates as ref_cand  # noqa: E402
from repro_torch.configs import dmf_foursquare as fsq  # noqa: E402
from repro_torch.core import dmf, graph, metrics  # noqa: E402
from repro_torch.data import synthetic_poi  # noqa: E402
from repro_torch.obs import metrics as obs  # noqa: E402
from repro_torch.serving import candidates  # noqa: E402


@pytest.fixture(scope="module")
def datasets():
    return ref_poi.foursquare_like(reduced=True), synthetic_poi.foursquare_like(reduced=True)


DATA_FIELDS = ("train", "test", "user_coords", "user_city", "item_city")


@pytest.mark.parametrize("field", DATA_FIELDS)
def test_foursquare_reduced_equals_reference(datasets, field):
    ref_ds, ds = datasets
    a, b = getattr(ref_ds, field), getattr(ds, field)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 3])
def test_generate_small_config_equals_reference(seed):
    kw = dict(n_users=60, n_items=40, n_ratings=300, n_cities=5, seed=seed)
    a = ref_poi.generate(ref_poi.POIDatasetConfig(**kw))
    b = synthetic_poi.generate(synthetic_poi.POIDatasetConfig(**kw))
    for f in DATA_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert dataclasses.asdict(a.config) == dataclasses.asdict(b.config)


GRAPHS = {
    "foursquare": {},
    "paper_literal": dict(paper_literal=True),
    "distance_weights": dict(uniform_weights=False, hop_damping=0.5),
    "cross_city": dict(same_city_only=False, n_neighbors=3, walk_length=2),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_and_neighbor_table_equal_reference(datasets, name):
    ref_ds, ds = datasets
    rcfg = dataclasses.replace(ref_fsq.GRAPH, **GRAPHS[name])
    pcfg = dataclasses.replace(fsq.GRAPH, **GRAPHS[name])
    W_ref = ref_graph.build_adjacency(ref_ds.user_coords, ref_ds.user_city, rcfg)
    W = graph.build_adjacency(ds.user_coords, ds.user_city, pcfg)
    np.testing.assert_array_equal(W, W_ref)
    np.testing.assert_array_equal(graph.row_normalize(W), ref_graph.row_normalize(W_ref))
    np.testing.assert_array_equal(graph.walk_propagation_matrix(W, pcfg),
                                  ref_graph.walk_propagation_matrix(W_ref, rcfg))
    nbr_ref = ref_graph.walk_neighbor_table(W_ref, rcfg)
    nbr = graph.walk_neighbor_table(W, pcfg, device="cpu")
    assert nbr.idx.dtype == torch.int64 and nbr.wgt.dtype == torch.float32
    np.testing.assert_array_equal(nbr.idx.numpy(), np.asarray(nbr_ref.idx))
    np.testing.assert_allclose(nbr.wgt.numpy(), np.asarray(nbr_ref.wgt), rtol=0, atol=1e-6)


@pytest.mark.parametrize("kw", [{}, dict(cap=128), dict(cap=40, pad_to=8, priority=True)],
                         ids=["lossless", "cap128", "truncated"])
def test_candidate_index_equals_reference(datasets, kw):
    ref_ds, ds = datasets
    kw = dict(kw)
    if kw.pop("priority", False):
        kw["item_priority"] = np.bincount(ds.train[:, 1], minlength=ds.n_items)
    a = ref_cand.index_from_dataset(ref_ds, **kw)
    b = candidates.index_from_dataset(ds, **kw)
    for f in ("bucket_items", "bucket_size", "city_size", "user_bucket"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
        assert getattr(b, f).dtype == getattr(a, f).dtype
    assert (b.cap, b.n_buckets, b.n_truncated_buckets) == (a.cap, a.n_buckets,
                                                          a.n_truncated_buckets)
    np.testing.assert_array_equal(b.user_fits(), a.user_fits())
    users = np.arange(0, ds.n_users, 7)
    np.testing.assert_array_equal(b.eligible_mask(users, rows_per_chunk=16),
                                  a.eligible_mask(users, rows_per_chunk=16))
    rows = b.bucket_items[b.bucket_items[:, 1] >= 0]
    assert (np.diff(rows[:, :2], axis=1) > 0).all()   # ascending ids


def test_candidate_index_edge_cases_equal_reference():
    cases = [
        (np.zeros(300, np.int64), np.zeros(4, np.int64), dict(cap=128, item_priority=np.arange(300))),
        (np.array([0, 0, 2]), np.array([0, 1, 3]), {}),     # cities with users, no POIs
        (np.empty(0, np.int64), np.empty(0, np.int64), {}),
    ]
    for item_city, user_city, kw in cases:
        a = ref_cand.build_candidate_index(item_city, user_city, **kw)
        b = candidates.build_candidate_index(item_city, user_city, **kw)
        np.testing.assert_array_equal(b.bucket_items, a.bucket_items)
        np.testing.assert_array_equal(b.user_bucket, a.user_bucket)


def test_sample_with_negatives_equals_reference(datasets):
    _, ds = datasets
    a = ref_dmf.sample_with_negatives(ds.train, ds.n_items, 3, np.random.default_rng(11))
    b = dmf.sample_with_negatives(ds.train, ds.n_items, 3, np.random.default_rng(11))
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_init_state_and_configs_equal_reference(datasets):
    _, ds = datasets
    rcfg = ref_fsq.dmf_config(ds.n_users, ds.n_items)
    pcfg = fsq.dmf_config(ds.n_users, ds.n_items)
    for f in ("n_users", "n_items", "dim", "alpha", "beta", "gamma", "lr", "neg_samples",
              "batch_size", "mode", "init_scale", "seed"):
        assert getattr(pcfg, f) == getattr(rcfg, f), f
    assert pcfg.dp is False and rcfg.dp is False
    ref_state = ref_dmf.init_state(rcfg)
    state = dmf.init_state(pcfg, device="cpu")
    np.testing.assert_array_equal(state.U.numpy(), np.asarray(ref_state.U))
    assert state.P.shape == ref_state.P.shape and not state.P.any() and not state.Q.any()


def test_metrics_equal_reference(datasets):
    _, ds = datasets
    rng = np.random.default_rng(2)
    test_mask = metrics.masks_from_interactions(ds.n_users, ds.n_items, ds.test)
    np.testing.assert_array_equal(
        test_mask, ref_metrics.masks_from_interactions(ds.n_users, ds.n_items, ds.test))
    rec = rng.integers(-1, ds.n_items, (ds.n_users, 10))
    for k in (5, 10):
        np.testing.assert_array_equal(metrics.topk_hits(rec, test_mask, k),
                                      ref_metrics.topk_hits(rec, test_mask, k))
        assert (metrics.precision_recall_from_topk(rec, test_mask, k)
                == ref_metrics.precision_recall_from_topk(rec, test_mask, k))
    lat = rng.exponential(0.01, 257)
    assert obs.latency_percentiles(lat) == ref_obs.latency_percentiles(lat)
    assert np.isnan(obs.latency_percentiles([])["p50_ms"])
