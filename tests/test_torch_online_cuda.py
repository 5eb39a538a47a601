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

The ingest's update plan (rounds of 200 and 512 check-ins: a partial last
batch, then a full step) leaves U, P, Q, the losses and the refreshed
slates of the plain `online_refresh` without a plan, bit for bit, with
one capture over the in-place rounds and ``replay`` 1 on every batch
after it; a reassigned P captures again; with DP on the engine stays on
the plain path (``replay`` 0, no capture) and gives its bits, every batch
marks ``dp`` 1 and launches kernel 8 once, and the ingests count their
released messages.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import dmf, graph
from repro_torch.data import synthetic_poi
from repro_torch.obs import trace as trace_lib
from repro_torch.serving import ServingConfig, ServingEngine, index_from_dataset, online

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
    assert card.stats.n_update_captures == 1
    assert card.stats.n_touched == cpu.stats.n_touched > 0


@pytest.fixture
def tracer():
    saved = trace_lib.get_tracer()
    yield trace_lib.set_tracer(trace_lib.Tracer(enabled=True))
    trace_lib.set_tracer(saved)


def _planned_against_plain(dev, cfg, sizes, tracer, reassign_at=None):
    """Rounds of ``sizes`` check-ins through an engine on the card and
    through `online_refresh` without a plan on a copy of its state, each
    held equal bit for bit (losses, U, P, Q, the refreshed slates); the
    engine and the ``online.update`` spans' ``replay`` args. Before round
    ``reassign_at`` the engine's P is replaced by a copy."""
    ds, nbr, _, state = _world()
    index = index_from_dataset(ds)
    scfg = ServingConfig(microbatch=512, k=10, prune=False)
    eng = ServingEngine(state, index, scfg, train=ds.train, nbr=nbr, dmf_cfg=cfg, device=dev)
    plain = dmf.DMFState(*(x.clone() for x in (eng.state.U, eng.state.P, eng.state.Q)))
    plain_rng = np.random.default_rng(cfg.seed)         # the engine's, as it builds it
    rng = np.random.default_rng(9)
    tracer.clear()
    for r, n in enumerate(sizes):
        if r == reassign_at:
            eng.state.P = eng.state.P.clone()
        events = np.stack([rng.integers(0, ds.n_users, n), rng.integers(0, ds.n_items, n)], 1)
        got = eng.ingest(events)
        _, want = online.online_refresh(plain, eng.nbr, events, cfg, rng=plain_rng)
        assert got.losses == want.losses and len(got.losses) == 4 * -(-4 * n // 256)
        for x, y in zip((eng.state.U, eng.state.P, eng.state.Q), (plain.U, plain.P, plain.Q)):
            assert torch.equal(x, y)
        # the slates of the plain state's users (a fresh engine's
        # popularity slate counts seen bits, not check-ins: flagged rows aside)
        vals, idx, flags = eng.recommend(got.touched_users, return_flags=True)
        fresh = ServingEngine(plain, index, scfg, seen=eng.seen.cpu().numpy().astype(bool),
                              device=dev)
        fv, fi, ff = fresh.recommend(got.touched_users, return_flags=True)
        assert np.array_equal(flags, ff) and (~flags).any()
        assert np.array_equal(vals[~flags], fv[~ff]) and np.array_equal(idx[~flags], fi[~ff])
        del fresh
    replays = [e["args"]["replay"] for e in tracer.events()     # the engine's, not the plain call's
               if e["name"] == "online.update" and e["args"].get("parent") == "engine.ingest"]
    assert len(replays) == sum(4 * -(-4 * n // 256) for n in sizes)
    return eng, replays


def test_planned_rounds_equal_the_plain_refresh_bit_for_bit(dev, tracer):
    cfg = _world()[2]
    eng, replays = _planned_against_plain(dev, cfg, (200, 512, 200, 512), tracer)
    assert replays == [0] + [1] * (len(replays) - 1)
    assert eng.stats.n_update_captures == 1 and eng._update_plan.replay


def test_a_reassigned_factor_captures_the_update_again(dev, tracer):
    cfg = _world()[2]
    eng, replays = _planned_against_plain(dev, cfg, (512, 200, 512), tracer, reassign_at=1)
    first = 4 * 8                                       # round 0's batches
    assert replays == [0] + [1] * (first - 1) + [0] + [1] * (len(replays) - first - 1)
    assert eng.stats.n_update_captures == 2


def test_dp_rounds_stay_on_the_plain_path(dev, tracer):
    cfg = dataclasses.replace(_world()[2], dp_clip=1.0, dp_sigma=0.5)
    eng, replays = _planned_against_plain(dev, cfg, (200, 512), tracer)
    assert replays == [0] * len(replays)
    assert eng.stats.n_update_captures == 0


def test_dp_rounds_mark_their_spans_and_launch_kernel_8_once_a_batch(dev, tracer):
    """With DP on, every ``online.update`` of the engine's ingests has
    ``dp`` 1 and launches kernel 8 once; ``engine.ingest``'s ``n_released``
    is the real rows over the steps and ``EngineStats.n_released`` their
    sum."""
    from repro_torch.kernels import ops
    ds, nbr, cfg, state = _world()
    cfg = dataclasses.replace(cfg, dp_clip=0.25, dp_sigma=1.0, dp_seed=3)
    eng = ServingEngine(state, index_from_dataset(ds), ServingConfig(microbatch=512, k=10),
                        train=ds.train, nbr=nbr, dmf_cfg=cfg, device=dev)
    rng = np.random.default_rng(9)
    tracer.clear()
    before = ops.dp_clip_noise.launches
    for n in (200, 512):
        events = np.stack([rng.integers(0, ds.n_users, n), rng.integers(0, ds.n_items, n)], 1)
        eng.ingest(events)
    evs = tracer.events()
    ups = [e["args"]["dp"] for e in evs if e["name"] == "online.update"]
    assert ups == [1] * (4 * 4 + 4 * 8)
    assert ops.dp_clip_noise.launches - before == len(ups)
    ingests = [(e["args"]["dp"], e["args"]["n_released"]) for e in evs
               if e["name"] == "engine.ingest"]
    assert ingests == [(1, 4 * 4 * 200), (1, 4 * 4 * 512)]
    assert eng.stats.n_released == 4 * 4 * (200 + 512)
