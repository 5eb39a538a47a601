"""The online refresh's spans and counter on one device (the CPU here):
`ServingEngine.ingest` records ``engine.ingest`` with its args, inside it
``online.touched``, an ``online.sample`` a step each followed by its
batches' ``online.update`` (``replay`` 0 on every batch: the engine's
update plan replays a graph only on a card), then ``engine.patch``, in
that order; it adds the touched users to ``EngineStats.n_touched``; the
refresh with the tracer on leaves U, P, Q, the seen bits, the losses and
the slates that it leaves with the tracer off, bit for bit; the
engine's refresh through its plan leaves the losses, U, P and Q of the
plain `online_refresh` without one; and with the DP mechanism on, the
spans say so (``dp`` on ``engine.ingest`` and every ``online.update``,
``n_released`` the real rows over the steps, summed in
``EngineStats.n_released``), 0 with it off, with the bits of the untraced
rounds either way."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import dmf, graph
from repro_torch.data import synthetic_poi
from repro_torch.obs import trace as trace_lib
from repro_torch.serving import ServingConfig, ServingEngine, index_from_dataset, online
from repro_torch.serving.online import OnlineConfig

OCFG = OnlineConfig(batch_cap=64, steps=3, neg_samples=3)


@pytest.fixture(scope="module")
def world():
    ds = synthetic_poi.generate(synthetic_poi.POIDatasetConfig(
        n_users=120, n_items=60, n_ratings=900, n_cities=4, seed=0))
    gcfg = graph.GraphConfig(n_neighbors=2, walk_length=3)
    W = graph.build_adjacency(ds.user_coords, ds.user_city, gcfg)
    nbr = graph.walk_neighbor_table(W, gcfg, device="cpu")
    cfg = dmf.DMFConfig(n_users=ds.n_users, n_items=ds.n_items, dim=6, beta=0.1, seed=11)
    g = torch.Generator().manual_seed(5)
    state = dmf.DMFState(*(0.1 * torch.randn(s, generator=g) for s in
                           ((ds.n_users, 6), (ds.n_users, ds.n_items, 6),
                            (ds.n_users, ds.n_items, 6))))
    return ds, nbr, cfg, state


@pytest.fixture
def tracer():
    saved = trace_lib.get_tracer()
    yield trace_lib.set_tracer(trace_lib.Tracer(enabled=True))
    trace_lib.set_tracer(saved)


def _engine(world):
    ds, nbr, cfg, state = world
    return ServingEngine(state, index_from_dataset(ds), ServingConfig(microbatch=32, k=5,
                                                                      prune=False),
                         train=ds.train, nbr=nbr, dmf_cfg=cfg, device="cpu")


def _rounds(eng, ds):
    """Two rounds of 40 check-ins (160 rows a step: batches of 64, 64, 32),
    each refreshing its touched users; the reports and the slates."""
    rng = np.random.default_rng(3)
    out = []
    for _ in range(2):
        events = np.stack([rng.integers(0, ds.n_users, 40), rng.integers(0, ds.n_items, 40)], 1)
        report = eng.ingest(events, OCFG)
        out.append((report, eng.recommend(report.touched_users)))
    return out


def test_ingest_spans_in_order_with_their_args(world, tracer):
    ds = world[0]
    eng = _engine(world)
    rounds = _rounds(eng, ds)
    evs = tracer.events()
    names = [e["name"] for e in evs if e["name"].startswith(("online.", "engine.ingest",
                                                             "engine.patch"))]
    one = (["online.touched"]
           + [n for s in range(3) for n in ["online.sample"] + ["online.update"] * 3]
           + ["engine.patch", "engine.ingest"])
    assert names == one * 2
    ingests = [e["args"] for e in evs if e["name"] == "engine.ingest"]
    for r, (args, (report, _)) in enumerate(zip(ingests, rounds)):
        assert args == {"depth": 0, "round": r, "n_events": 40, "n_rows": 160, "n_batches": 9,
                        "n_affected": len(report.affected_users),
                        "n_touched": len(report.touched_users), "dp": 0, "n_released": 0}
    samples = [e["args"] for e in evs if e["name"] == "online.sample"]
    assert samples[:3] == [{"depth": 1, "parent": "engine.ingest", "step": s, "rows": 160,
                            "batches": 3} for s in range(3)]
    updates = [(e["args"]["step"], e["args"]["batch"], e["args"]["replay"], e["args"]["dp"])
               for e in evs if e["name"] == "online.update"]
    assert updates == [(s, b, 0, 0) for s in range(3) for b in range(3)] * 2
    patch = [e["args"] for e in evs if e["name"] == "engine.patch"]
    assert patch == [{"depth": 1, "parent": "engine.ingest", "round": r} for r in range(2)]
    assert eng.stats.n_touched == sum(len(rep.touched_users) for rep, _ in rounds)
    assert eng.stats.n_refreshes == 2 and eng.stats.n_events == 80 and eng.stats.n_released == 0


def test_tracing_leaves_the_refresh_bit_for_bit(world, tracer):
    ds = world[0]
    on = _engine(world)
    got = _rounds(on, ds)
    assert tracer.events()
    trace_lib.set_tracer(trace_lib.Tracer(enabled=False))
    off = _engine(world)
    want = _rounds(off, ds)
    assert not trace_lib.get_tracer().events()
    for x, y in zip((on.state.U, on.state.P, on.state.Q, on.seen),
                    (off.state.U, off.state.P, off.state.Q, off.seen)):
        assert torch.equal(x, y)
    for (rg, sg), (rw, sw) in zip(got, want):
        assert rg.losses == rw.losses
        assert np.array_equal(rg.touched_users, rw.touched_users)
        assert all(np.array_equal(a, b) for a, b in zip(sg, sw))
    assert on.stats.n_touched == off.stats.n_touched


def test_the_plan_leaves_the_plain_refresh_bit_for_bit(world):
    """Rounds of 40 and 64 check-ins (a partial last batch, then four full
    batches a step) through the engine's plan against `online_refresh`
    without one on a copy of the state, from generators in the same state."""
    ds, nbr, cfg, _ = world
    eng = _engine(world)
    plain = dmf.DMFState(*(x.clone() for x in (eng.state.U, eng.state.P, eng.state.Q)))
    plain_rng = np.random.default_rng(cfg.seed)         # the engine's, as it builds it
    rng = np.random.default_rng(4)
    for n in (40, 64, 40):
        events = np.stack([rng.integers(0, ds.n_users, n), rng.integers(0, ds.n_items, n)], 1)
        got = eng.ingest(events, OCFG)
        _, want = online.online_refresh(plain, nbr, events, cfg, OCFG, plain_rng)
        assert got.losses == want.losses and len(got.losses) == want.n_batches
        assert all(type(x) is float for x in got.losses)
        for x, y in zip((eng.state.U, eng.state.P, eng.state.Q), (plain.U, plain.P, plain.Q)):
            assert torch.equal(x, y)
    assert (eng.stats.n_update_captures, eng._update_plan.captures) == (0, 0)


@pytest.mark.parametrize("dp", [False, True])
def test_dp_args_and_released_count(world, tracer, dp):
    """The mechanism on (σ=1, C=0.25) or off: ``engine.ingest``'s ``dp``
    and ``n_released`` (3 steps × 160 real rows with DP on, else 0), every
    ``online.update``'s ``dp``, ``EngineStats.n_released`` their sum; the
    traced rounds leave the untraced rounds' U, P, Q, losses and slates."""
    ds, nbr, cfg, state = world
    if dp:
        cfg = dataclasses.replace(cfg, dp_sigma=1.0, dp_clip=0.25, dp_seed=7)
    on = _engine((ds, nbr, cfg, state))
    got = _rounds(on, ds)
    evs = tracer.events()
    ingests = [e["args"] for e in evs if e["name"] == "engine.ingest"]
    assert [(a["dp"], a["n_released"]) for a in ingests] == [(int(dp), 3 * 160 * dp)] * 2
    updates = [e["args"]["dp"] for e in evs if e["name"] == "online.update"]
    assert updates == [int(dp)] * 18
    assert on.stats.n_released == 2 * 3 * 160 * dp
    trace_lib.set_tracer(trace_lib.Tracer(enabled=False))
    off = _engine((ds, nbr, cfg, state))
    want = _rounds(off, ds)
    assert not trace_lib.get_tracer().events()
    for x, y in zip((on.state.U, on.state.P, on.state.Q, on.seen),
                    (off.state.U, off.state.P, off.state.Q, off.seen)):
        assert torch.equal(x, y)
    for (rg, sg), (rw, sw) in zip(got, want):
        assert rg.losses == rw.losses
        assert all(np.array_equal(a, b) for a, b in zip(sg, sw))
    assert off.stats.n_released == on.stats.n_released
    if dp:    # the mechanism moved the factors away from the DP-off refresh
        plain = _engine(world)
        _rounds(plain, ds)
        assert not torch.equal(plain.state.P, off.state.P)
