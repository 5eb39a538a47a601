"""The tiled store built from its users' check-ins
(`TiledFactorStore.from_checkins`) against the stores built from a dense
seen mask (`from_state`) and from the same generator (`synthetic`), the
tiled dispatch's spans, and the cold users' popularity slates, on the CPU
at a small size (600 users, 300 POIs, 5 cities, K=8, cell cap 64).
No JAX: the port is compared with itself.

Equal bit for bit: the seen windows, ``item_counts`` and ``cold`` against
`from_state` on the dense mask of the same pairs; the fp32 windows and U
against `synthetic`'s on the same generator.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import dmf
from repro_torch.obs import trace as trace_lib
from repro_torch.serving import (ServingConfig, SyntheticFactors, TiledFactorStore,
                                 TiledServingEngine, build_hierarchical_index, synthetic_world)

I, J, N_CITIES, K = 600, 300, 5, 8
CELL_CAP = 64
MICROBATCH = 64
PHASES = ("tiled.prepare", "tiled.upload", "tiled.launch", "tiled.readback", "tiled.finish")


@pytest.fixture(scope="module")
def world():
    uc, ic, ucoord, icoord = synthetic_world(I, J, N_CITIES, seed=11)
    index = build_hierarchical_index(ic, uc, icoord, ucoord, cell_cap=CELL_CAP).flat
    synth = SyntheticFactors.create(I, J, K, seed=12)
    rng = np.random.default_rng(13)
    size = index.bucket_size[index.user_bucket]
    # two draws a user from the user's own cell (repeats allowed), users 0-29
    # left cold, and ten pairs outside their user's window
    pos = np.floor(rng.random((I, 2)) * size[:, None]).astype(np.int64)
    pairs = np.stack([np.repeat(np.arange(I), 2),
                      index.bucket_items[np.repeat(index.user_bucket, 2), pos.ravel()]], 1)
    pairs = pairs[pairs[:, 0] >= 30]
    outside = []
    for u in rng.choice(np.arange(30, I), 10, replace=False):
        window = index.bucket_items[index.user_bucket[u]]
        outside.append((u, np.setdiff1d(np.arange(J), window)[0]))
    pairs = np.concatenate([pairs, np.asarray(outside), pairs[:40]])   # repeats too
    pairs = pairs[rng.permutation(len(pairs))]
    return index, synth, pairs


def test_checkin_store_equals_from_state_on_the_dense_mask(world):
    index, synth, pairs = world
    st = TiledFactorStore.from_checkins(synth, index, pairs, chunk_rows=97, device="cpu")
    dense = np.zeros((I, J), bool)
    dense[pairs[:, 0], pairs[:, 1]] = True
    rows = synth.dense_rows(np.arange(I), device="cpu")
    ref = TiledFactorStore.from_state(dmf.DMFState(torch.as_tensor(synth.U), rows,
                                                   torch.zeros_like(rows)),
                                      index, dense, chunk_rows=128)
    assert torch.equal(st.seen, ref.seen)
    np.testing.assert_array_equal(st.item_counts, ref.item_counts)
    np.testing.assert_array_equal(st.cold, ref.cold)
    assert st.cold[:30].all() and not st.cold[30:].any()
    assert st.item_counts.sum() == dense.sum() > int(st.seen.sum())   # outside pairs count
    gen = TiledFactorStore.synthetic(synth, index, seen_per_user=0, device="cpu")
    assert torch.equal(st.slab, gen.slab) and torch.equal(st.U, gen.U)
    # padding columns hold item 0's view
    pad = torch.as_tensor(index.bucket_items[index.user_bucket] < 0)
    assert pad.any()
    want = torch.as_tensor(synth.B1[0]) * torch.as_tensor(synth.s_user)[:, None] \
        + torch.as_tensor(synth.B2[0])
    assert torch.equal(st.slab[pad], want[:, None, :].expand(-1, index.cap, -1)[pad])


def test_checkin_store_refuses_pairs_out_of_range(world):
    index, synth, _ = world
    for bad in ([[I, 0]], [[0, J]], [[-1, 3]]):
        with pytest.raises(ValueError):
            TiledFactorStore.from_checkins(synth, index, np.asarray(bad), device="cpu")
    empty = TiledFactorStore.from_checkins(synth, index, np.zeros((0, 2), np.int64),
                                           device="cpu")
    assert empty.cold.all() and not empty.item_counts.any() and not empty.seen.any()


@pytest.mark.parametrize("mode", ["fp32", "int8"])
def test_tiled_dispatch_spans_and_args(world, mode):
    index, synth, pairs = world
    st = TiledFactorStore.from_checkins(synth, index, pairs, device="cpu")
    eng = TiledServingEngine(st, ServingConfig(microbatch=MICROBATCH, k=10), mode=mode)
    ids = np.concatenate([np.arange(I), [-3, I + 2]])
    saved = trace_lib.get_tracer()
    try:
        tracer = trace_lib.set_tracer(trace_lib.Tracer(enabled=True))
        vals, idx, flags = eng.recommend(ids, return_flags=True)
    finally:
        trace_lib.set_tracer(saved)
    evs = tracer.events()
    disp = [e for e in evs if e["name"] == "tiled.dispatch"]
    n_disp = -(-len(ids) // MICROBATCH)
    assert len(disp) == n_disp == eng.stats.n_dispatches
    assert {e["name"] for e in evs} == {"tiled.dispatch", *PHASES}
    assert [e["args"]["dispatch"] for e in disp] == list(range(n_disp))
    assert all(e["args"]["mode"] == mode and e["args"]["rows"] == MICROBATCH for e in disp)
    assert sum(e["args"]["n_real"] for e in disp) == len(ids) == eng.stats.n_requests
    assert sum(e["args"]["n_fallback"] for e in disp) == int(flags.sum()) >= 32
    for d, outer in enumerate(disp):
        inner = [e for e in evs if e["name"] in PHASES and e["args"]["dispatch"] == d]
        assert [e["name"] for e in sorted(inner, key=lambda e: e["ts"])] == list(PHASES)
        for e in inner:
            assert e["args"]["parent"] == "tiled.dispatch"
            assert outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]
    # the spans leave the slates alone
    again = TiledServingEngine(st, ServingConfig(microbatch=MICROBATCH, k=10), mode=mode)
    v2, i2 = again.recommend(ids)
    np.testing.assert_array_equal(idx, i2)
    np.testing.assert_array_equal(vals, v2)


def test_checkin_store_serves_cold_users_the_popularity_slate(world):
    """The users with no check-in are flagged and served the ten POIs with
    the most distinct check-ins; the others get unseen POIs of their own
    window; an empty call returns empty slates."""
    index, synth, pairs = world
    st = TiledFactorStore.from_checkins(synth, index, pairs, device="cpu")
    eng = TiledServingEngine(st, ServingConfig(microbatch=MICROBATCH, k=10), mode="int8")
    ids = np.random.default_rng(14).permutation(I)
    vals, idx, flags = eng.recommend(ids, return_flags=True)
    np.testing.assert_array_equal(flags, ids < 30)
    distinct = np.unique(pairs, axis=0)
    popular = np.bincount(distinct[:, 1], minlength=J)
    assert (popular[idx[flags]] == np.sort(popular)[::-1][:10]).all()
    assert eng.stats.n_fallbacks == 30
    seen = np.zeros((I, J), bool)
    seen[pairs[:, 0], pairs[:, 1]] = True
    for u, row in zip(ids[~flags], idx[~flags]):
        assert np.isin(row, index.bucket_items[index.user_bucket[u]]).all()
        assert not seen[u, row].any() and len(set(row)) == 10
    empty = eng.recommend([], return_flags=True)
    assert [a.shape for a in empty] == [(0, 10), (0, 10), (0,)]


@pytest.mark.parametrize("mode", ["fp32", "int8", "bf16"])
def test_tiled_dispatch_on_the_cpu_is_no_replay(world, mode):
    """No plan serves a dispatch off a store on the CPU: every
    ``tiled.dispatch`` span of two calls carries ``replay`` 0 beside its
    other args, the engine counts no capture and no replay, and the five
    phases stay nested in order inside each dispatch, whose numbers run on
    across the calls."""
    index, synth, pairs = world
    st = TiledFactorStore.from_checkins(synth, index, pairs, device="cpu")
    eng = TiledServingEngine(st, ServingConfig(microbatch=MICROBATCH, k=10), mode=mode)
    calls = [np.arange(I)[::-1], np.concatenate([np.arange(100), [I + 5]])]
    saved = trace_lib.get_tracer()
    try:
        tracer = trace_lib.set_tracer(trace_lib.Tracer(enabled=True))
        for ids in calls:
            eng.recommend(ids)
    finally:
        trace_lib.set_tracer(saved)
    evs = tracer.events()
    disp = [e for e in evs if e["name"] == "tiled.dispatch"]
    n_disp = sum(-(-len(ids) // MICROBATCH) for ids in calls)
    assert len(disp) == n_disp == eng.stats.n_dispatches
    assert [e["args"]["replay"] for e in disp] == [0] * n_disp
    assert all({"mode", "dispatch", "rows", "replay", "n_real", "n_fallback"}
               <= e["args"].keys() for e in disp)
    assert eng.stats.n_captures == 0
    assert [e["args"]["dispatch"] for e in disp] == list(range(n_disp))
    for d, outer in enumerate(disp):
        inner = sorted((e for e in evs if e["name"] in PHASES and e["args"]["dispatch"] == d),
                       key=lambda e: e["ts"])
        assert [e["name"] for e in inner] == list(PHASES)
        for a, b in zip(inner, inner[1:]):
            assert a["ts"] + a["dur"] <= b["ts"]
        assert outer["ts"] <= inner[0]["ts"]
        assert inner[-1]["ts"] + inner[-1]["dur"] <= outer["ts"] + outer["dur"]


@pytest.mark.parametrize("mode", ["fp32", "int8", "bf16"])
def test_tiled_recommend_returns_fresh_arrays_each_call(world, mode):
    """A second call, over other users and with a partial last microbatch,
    leaves the first call's slates as they were: no output shares memory
    with another call's or with the engine."""
    index, synth, pairs = world
    st = TiledFactorStore.from_checkins(synth, index, pairs, device="cpu")
    eng = TiledServingEngine(st, ServingConfig(microbatch=MICROBATCH, k=10), mode=mode)
    first = eng.recommend(np.arange(200))
    kept = [x.copy() for x in first]
    second = eng.recommend(np.arange(I - 1, 100, -1))
    for a, b, c in zip(first, kept, second):
        np.testing.assert_array_equal(a, b)
        assert not np.shares_memory(a, c)
    np.testing.assert_array_equal(second[1][-99:], first[1][101:][::-1])   # users 199..101


@pytest.mark.parametrize("mode", ["fp32", "int8", "bf16"])
def test_tiled_outputs_on_the_cpu_are_never_reused(world, mode):
    """On the CPU every call's outputs are fresh arrays: each
    ``tiled.dispatch`` span of three calls, the first result dropped before
    the third, carries ``out_reused`` 0; two held results share no memory,
    nor do vals and idx of one call."""
    index, synth, pairs = world
    st = TiledFactorStore.from_checkins(synth, index, pairs, device="cpu")
    eng = TiledServingEngine(st, ServingConfig(microbatch=MICROBATCH, k=10), mode=mode)
    ids = np.arange(I)[::-1]
    saved = trace_lib.get_tracer()
    try:
        tracer = trace_lib.set_tracer(trace_lib.Tracer(enabled=True))
        first = eng.recommend(ids)
        second = eng.recommend(ids)
        for a, b in zip(first, second):
            np.testing.assert_array_equal(a, b)
            assert not np.shares_memory(a, b)
        assert not np.shares_memory(*first)
        del first
        eng.recommend(ids)
    finally:
        trace_lib.set_tracer(saved)
    disp = [e["args"] for e in tracer.events() if e["name"] == "tiled.dispatch"]
    assert len(disp) == 3 * -(-I // MICROBATCH) == eng.stats.n_dispatches
    assert [a["out_reused"] for a in disp] == [0] * len(disp)
