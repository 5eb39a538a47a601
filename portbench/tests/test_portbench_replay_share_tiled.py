"""The reader of the share of tiled dispatches served by the program's
captured dispatch plan: its value by hand on made-up ``tiled.dispatch``
events, None where the counts disagree, the ``replay`` arg is missing (a
program without the plan) or there are no dispatches, and 0 on the
program's own dispatches off a store on the CPU, read from its global
tracer."""
import numpy as np
import pytest

from portbench.manifest import Manifest

REPLAY = Manifest().reader("replay_share.tiled")


def tiled_events(replays):
    """``tiled.dispatch`` events with the given ``replay`` args (None: the
    arg left out), among phase spans' events and the refresh engine's
    dispatch events, which the share skips."""
    evs = []
    for d, r in enumerate(replays):
        evs.append({"name": "tiled.prepare", "ph": "X", "args": {"dispatch": d}})
        evs.append({"name": "engine.serve_microbatch", "ph": "X",
                    "args": {"dispatch": d, "replay": 1}})
        args = {"depth": 0, "mode": "int8", "dispatch": d, "rows": 2048, "n_real": 2048,
                "n_fallback": 3}
        if r is not None:
            args["replay"] = r
        evs.append({"name": "tiled.dispatch", "ph": "X", "args": args})
    return evs


@pytest.mark.parametrize("replays,want", [([1] * 5, 100.0), ([1, 0, 1, 1], 75.0),
                                          ([0, 1], 50.0), ([0, 0, 0], 0.0)])
def test_tiled_replay_share_by_hand(replays, want):
    assert REPLAY.share(tiled_events(replays), len(replays)) == pytest.approx(want)


@pytest.mark.parametrize("replays,n", [([1, 1, 1], 4), ([1, 1], 1), ([1, None, 1], 3),
                                       ([None] * 3, 3), ([], 0), ([1, 1], 0)],
                         ids=["fewer spans", "more spans", "one arg missing",
                              "a program without the plan", "no dispatches",
                              "no dispatches counted"])
def test_tiled_replay_share_none_where_it_cannot_read(replays, n):
    assert REPLAY.share(tiled_events(replays), n) is None


def test_tiled_replay_share_reads_the_programs_global_tracer():
    from repro_torch.obs import trace as trace_lib
    saved = trace_lib.get_tracer()
    try:
        trace_lib.set_tracer(trace_lib.Tracer(enabled=True))
        for d, replay in enumerate([1, 0, 1, 1]):
            with trace_lib.span("tiled.dispatch", mode="int8", dispatch=d, rows=8,
                                replay=replay):
                pass
        ctx = {"dispatches": [(0.0, 1.0, 8, 5)] * 4}
        assert REPLAY.read(ctx, None) == pytest.approx(75.0)
        ctx["dispatches"].append((2.0, 3.0, 5, 2))
        assert REPLAY.read(ctx, None) is None
        assert REPLAY.read({}, None) is None
        assert REPLAY.read({"dispatches": []}, None) is None
    finally:
        trace_lib.set_tracer(saved)


def test_tiled_replay_share_is_zero_on_the_programs_cpu_dispatches():
    """The tiled engine off a store on the CPU has no plan: its dispatches
    read 0, one event for each of them."""
    from repro_torch.obs import trace as trace_lib
    from repro_torch.serving import (ServingConfig, SyntheticFactors, TiledFactorStore,
                                     TiledServingEngine, build_hierarchical_index,
                                     synthetic_world)
    uc, ic, ucoord, icoord = synthetic_world(400, 200, 4, seed=21)
    index = build_hierarchical_index(ic, uc, icoord, ucoord, cell_cap=64).flat
    synth = SyntheticFactors.create(400, 200, 8, seed=22)
    store = TiledFactorStore.synthetic(synth, index, seen_per_user=2, seed=23, device="cpu")
    eng = TiledServingEngine(store, ServingConfig(microbatch=64, k=10), mode="int8")
    saved = trace_lib.get_tracer()
    try:
        trace_lib.set_tracer(trace_lib.Tracer(enabled=True))
        eng.recommend(np.random.default_rng(24).permutation(400))
        ctx = {"dispatches": [(0.0, 1.0, 64, 0)] * eng.stats.n_dispatches}
        assert eng.stats.n_dispatches == 7
        assert REPLAY.read(ctx, None) == 0.0
    finally:
        trace_lib.set_tracer(saved)

