"""Rounds of the online refresh on the card: `ServingEngine.ingest` then
`recommend(touched)`, as the deployment runs them.

Marked ``cuda``: skips with a reason where no card is present (the CPU
tests hold the plain path against the benchmark's reference instead). On
a machine with a card and without JAX, run with

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_online_cuda.py

A short run of rounds gives, after each round, the touched users and the
factors of the same rounds on the CPU's plain path (factors within 1e-5
of the larger of the CPU's entry and its leaf's median |entry|, as the
benchmark's check reads them; the two devices sum duplicate scatters in
another order), slates equal bit for bit to those of a fresh engine over
the card's post-round state, and one captured plan for all rounds: the
graph replays over the ingest's in-place writes.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import dmf, graph
from repro_torch.data import synthetic_poi
from repro_torch.serving import ServingConfig, ServingEngine, index_from_dataset

pytestmark = pytest.mark.cuda
TOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU tests cover the plain path")
    return torch.device("cuda")


def _world():
    ds = synthetic_poi.generate(synthetic_poi.POIDatasetConfig(
        n_users=1500, n_items=700, n_ratings=12000, n_cities=10, seed=0))
    gcfg = graph.GraphConfig(n_neighbors=2, walk_length=3)
    nbr = graph.walk_neighbor_table(graph.build_adjacency(ds.user_coords, ds.user_city, gcfg),
                                    gcfg, device="cpu")
    cfg = dmf.DMFConfig(n_users=ds.n_users, n_items=ds.n_items, dim=10, beta=0.1, seed=7)
    g = torch.Generator().manual_seed(3)
    state = dmf.DMFState(*(0.1 * torch.randn(s, generator=g) for s in
                           ((ds.n_users, 10), (ds.n_users, ds.n_items, 10),
                            (ds.n_users, ds.n_items, 10))))
    return ds, nbr, cfg, state


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.cpu().double(), want.double()
    scale = torch.maximum(want.abs(), want.abs().median())
    return float(((got - want).abs() / scale).max())


def test_online_rounds_follow_the_cpu_and_a_fresh_engine(dev):
    ds, nbr, cfg, state = _world()
    scfg = ServingConfig(microbatch=512, k=10, prune=False)
    card, cpu = (ServingEngine(state, index_from_dataset(ds), scfg, train=ds.train, nbr=nbr,
                               dmf_cfg=cfg, device=d) for d in (dev, "cpu"))
    card.recommend(np.arange(ds.n_users))           # captures the plan
    assert card.stats.n_captures == 1
    rng = np.random.default_rng(9)
    for _ in range(4):
        events = np.stack([rng.integers(0, ds.n_users, 200),
                           rng.integers(0, ds.n_items, 200)], 1)
        got, want = card.ingest(events), cpu.ingest(events)
        assert np.array_equal(got.touched_users, want.touched_users)
        np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
        for x, y in zip((card.state.U, card.state.P, card.state.Q),
                        (cpu.state.U, cpu.state.P, cpu.state.Q)):
            assert _gap(x, y) <= TOL
        assert torch.equal(card.seen.cpu(), cpu.seen)
        vals, idx, flags = card.recommend(got.touched_users, return_flags=True)
        fresh = ServingEngine(card.state, index_from_dataset(ds), scfg,
                              seen=card.seen.cpu().numpy().astype(bool), device=dev)
        fv, fi, ff = fresh.recommend(got.touched_users, return_flags=True)
        assert np.array_equal(flags, ff)
        assert np.array_equal(vals[~flags], fv[~ff]) and np.array_equal(idx[~flags], fi[~ff])
        del fresh
    assert card.stats.n_captures == 1 and card.stats.n_refreshes == 4
    assert card.stats.n_touched == cpu.stats.n_touched > 0
