"""The reader of the share of dispatches served by the program's captured
dispatch plan, on hand-made event lists and on the program's global tracer:
its value by hand, and None where the counts disagree or the ``replay`` arg
is missing, as it is in a program without the plan."""
import pytest

from portbench.manifest import Manifest

REPLAY = Manifest().reader("replay_share.refresh")


def replay_events(replays):
    """``engine.serve_microbatch`` events with the given ``replay`` args
    (None: the arg left out, as a program without the plan records), among
    phase spans' events, which the share skips."""
    evs = []
    for d, r in enumerate(replays):
        evs.append({"name": "engine.prepare", "ph": "X", "args": {"dispatch": d}})
        args = {"depth": 0, "dispatch": d, "rows": 2048, "n_real": 2048, "n_fallback": 190}
        if r is not None:
            args["replay"] = r
        evs.append({"name": "engine.serve_microbatch", "ph": "X", "args": args})
    return evs


@pytest.mark.parametrize("replays,want", [([1, 1, 1], 100.0), ([1, 0, 1, 1], 75.0),
                                          ([0, 0], 0.0)])
def test_replay_share_by_hand(replays, want):
    assert REPLAY.share(replay_events(replays), len(replays)) == pytest.approx(want)


def test_replay_share_none_when_the_counts_disagree_or_the_arg_is_missing():
    assert REPLAY.share(replay_events([1, 1, 1]), 4) is None
    assert REPLAY.share(replay_events([1, 1]), 3) is None
    assert REPLAY.share([], 0) is None
    assert REPLAY.share(replay_events([1, None, 1]), 3) is None
    assert REPLAY.share(replay_events([None] * 3), 3) is None     # a program without the plan


def test_replay_share_reads_the_programs_global_tracer():
    from repro_torch.obs import trace as trace_lib
    saved = trace_lib.get_tracer()
    try:
        trace_lib.set_tracer(trace_lib.Tracer(enabled=True))
        for d, replay in enumerate([1, 1, 0, 1]):
            with trace_lib.span("engine.serve_microbatch", dispatch=d, rows=8, replay=replay):
                pass
        ctx = {"dispatches": [(0.0, 1.0, 8, 0)] * 4}
        assert REPLAY.read(ctx, None) == pytest.approx(75.0)
        ctx["dispatches"].append((2.0, 3.0, 5, 0))
        assert REPLAY.read(ctx, None) is None
        assert REPLAY.read({}, None) is None
    finally:
        trace_lib.set_tracer(saved)
