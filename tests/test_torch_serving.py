"""The serving slice end to end: the port's `ServingEngine` against the
reference's, on the CPU, on two states carried across from numpy:

* ``numpy`` — U/P/Q drawn with numpy, with whole user rows and item
  columns of P/Q zeroed (exact 0.0 score ties);
* ``fit`` — a short reference `dmf.fit`, carried by `state_from_numpy`.

Both engines get the same data, neighbor table, candidate index and
``dmf_cfg.seed``, so their ingest draws the same negatives. The reference
runs its Pallas kernels in interpret mode (`ServingConfig(interpret=True)`,
`DMFConfig(use_pallas=True)`); the port runs its kernels' plain versions.

Tolerances: fallback flags equal, values within 1e-6 abs + 1e-6 rel
(sums over K in another order); refresh losses within 1e-5 rel and U/P/Q
within 1e-5 abs (the P scatter sums duplicate (receiver, item) pairs in
another order than XLA's). Slate ids equal the reference's jnp oracle
(`repro.kernels.ref`, `lax.top_k` on dense masked scores), the tie
contract (score descending, item id ascending). The reference's Pallas
merge keeps that order only within one 128-item tile: once a better item
from a later tile displaces an exact tie, the displaced tie can lose its
place to a higher id (the dense rows here show it). The port's kernels
follow the contract, so ids are held against the oracle, values against
the reference's kernels.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import dmf as ref_dmf  # noqa: E402
from repro.core import graph as ref_graph  # noqa: E402
from repro.data import synthetic_poi as ref_poi  # noqa: E402
from repro.kernels import ref as ref_kernels  # noqa: E402
from repro.serving import OnlineConfig as RefOnlineConfig  # noqa: E402
from repro.serving import ServingConfig as RefServingConfig  # noqa: E402
from repro.serving import ServingEngine as RefServingEngine  # noqa: E402
from repro.serving import index_from_dataset as ref_index  # noqa: E402
from repro.serving import online as ref_online  # noqa: E402
from repro_torch.core import dmf, graph  # noqa: E402
from repro_torch.serving import (OnlineConfig, ServingConfig, ServingEngine,  # noqa: E402
                                 index_from_dataset, online)

K = 10
MICROBATCH = 32
OCFG = dict(batch_cap=128, steps=2, neg_samples=3)
CFG = dict(dim=K, alpha=0.1, beta=0.1, gamma=0.01, lr=0.1, neg_samples=3, batch_size=128)


@pytest.fixture(scope="module")
def world():
    ds = ref_poi.foursquare_like(reduced=True)
    gcfg = ref_graph.GraphConfig(n_neighbors=2, walk_length=3)
    W = ref_graph.build_adjacency(ds.user_coords, ds.user_city, gcfg)
    ref_nbr = ref_graph.walk_neighbor_table(W, gcfg)
    pgcfg = graph.GraphConfig(n_neighbors=2, walk_length=3)
    nbr = graph.walk_neighbor_table(
        graph.build_adjacency(ds.user_coords, ds.user_city, pgcfg), pgcfg, device="cpu")
    ref_cfg = ref_dmf.DMFConfig(n_users=ds.n_users, n_items=ds.n_items, use_pallas=True, **CFG)
    cfg = dmf.DMFConfig(n_users=ds.n_users, n_items=ds.n_items, **CFG)
    return dict(ds=ds, ref_nbr=ref_nbr, nbr=nbr, ref_cfg=ref_cfg, cfg=cfg,
                ref_index=ref_index(ds), index=index_from_dataset(ds))


def _numpy_state(ds):
    rng = np.random.default_rng(0)
    I, J = ds.n_users, ds.n_items
    U = rng.normal(0, 0.5, (I, K)).astype(np.float32)
    P = rng.normal(0, 0.2, (I, J, K)).astype(np.float32)
    Q = rng.normal(0, 0.2, (I, J, K)).astype(np.float32)
    zero_users = rng.choice(I, I // 8, replace=False)
    P[zero_users] = 0.0
    Q[zero_users] = 0.0
    zero_items = rng.choice(J, J // 4, replace=False)
    P[:, zero_items] = 0.0
    Q[:, zero_items] = 0.0
    return U, P, Q


@pytest.fixture(scope="module", params=["numpy", "fit"])
def states(request, world):
    ds = world["ds"]
    if request.param == "numpy":
        U, P, Q = _numpy_state(ds)
    else:
        cfg = ref_dmf.DMFConfig(n_users=ds.n_users, n_items=ds.n_items, **CFG)
        st = ref_dmf.fit(cfg, ds.train, world["ref_nbr"], epochs=2).state
        U, P, Q = (np.asarray(x) for x in (st.U, st.P, st.Q))
    ref_state = ref_dmf.DMFState(U=jnp.asarray(U), P=jnp.asarray(P), Q=jnp.asarray(Q))
    return ref_state, dmf.state_from_numpy(U, P, Q, device="cpu")


def _engines(world, states, prune):
    ref_state, state = states
    ds = world["ds"]
    ref_eng = RefServingEngine(
        ref_state, world["ref_index"],
        RefServingConfig(microbatch=MICROBATCH, k=10, prune=prune, interpret=True),
        train=ds.train, nbr=world["ref_nbr"], dmf_cfg=world["ref_cfg"])
    eng = ServingEngine(
        state, world["index"], ServingConfig(microbatch=MICROBATCH, k=10, prune=prune),
        train=ds.train, nbr=world["nbr"], dmf_cfg=world["cfg"], device="cpu")
    return ref_eng, eng


def _requests(ds):
    # every user, shuffled, plus unknown ids (fallback) and a ragged tail
    ids = np.random.default_rng(1).permutation(ds.n_users)
    return np.concatenate([ids, [-3, ds.n_users + 5], ids[:19]])


def _oracle_ids(ref_eng, ids, flags):
    """The reference's jnp oracle over the reference engine's own state:
    slate ids of the rows the factor path serves (fallback rows excluded)."""
    rows = np.asarray(ids)[~flags]
    U, V = np.asarray(ref_eng.state.U)[rows], np.asarray(ref_eng.V)
    seen = np.asarray(ref_eng.seen)
    k = ref_eng.cfg.k
    if ref_eng.cfg.prune:
        cand = np.asarray(ref_eng._bucket_items)[np.asarray(ref_eng._user_bucket)[rows]]
        safe = np.maximum(cand, 0)
        _, idx = ref_kernels.serve_topk_window_ref(
            jnp.asarray(U), jnp.asarray(V[rows[:, None], safe]), jnp.asarray(cand),
            jnp.asarray(seen[rows[:, None], safe]), k)
    else:
        _, idx = ref_kernels.masked_topk_finalize(*ref_kernels.topk_scores_peruser_ref(
            jnp.asarray(U), jnp.asarray(V[rows]), jnp.asarray(seen[rows] != 0), k))
    return np.asarray(idx)


def _assert_slates(got, ref_eng, ids):
    expect = ref_eng.recommend(ids, return_flags=True)
    flags = got[2]
    np.testing.assert_array_equal(flags, np.asarray(expect[2]))
    np.testing.assert_array_equal(got[1][flags], np.asarray(expect[1])[flags])
    np.testing.assert_array_equal(got[1][~flags], _oracle_ids(ref_eng, ids, flags))
    np.testing.assert_allclose(got[0], np.asarray(expect[0]), rtol=1e-6, atol=1e-6)


def _assert_states(state, ref_state):
    for a, b in zip((state.U, state.P, state.Q), (ref_state.U, ref_state.P, ref_state.Q)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)


@pytest.mark.parametrize("prune", [True, False], ids=["pruned", "dense"])
def test_recommend_matches_reference(world, states, prune):
    ref_eng, eng = _engines(world, states, prune)
    ids = _requests(world["ds"])
    got = eng.recommend(ids, return_flags=True)
    _assert_slates(got, ref_eng, ids)
    assert got[2].sum() >= 2
    assert eng.stats.n_requests == ref_eng.stats.n_requests
    assert eng.stats.n_dispatches == ref_eng.stats.n_dispatches
    assert eng.stats.n_fallbacks == ref_eng.stats.n_fallbacks


@pytest.mark.parametrize("prune", [True, False], ids=["pruned", "dense"])
def test_ingest_then_recommend_matches_reference(world, states, prune):
    ds = world["ds"]
    ref_eng, eng = _engines(world, states, prune)
    report = eng.ingest(ds.test, OnlineConfig(**OCFG))
    ref_report = ref_eng.ingest(ds.test, RefOnlineConfig(**OCFG))
    np.testing.assert_array_equal(report.affected_users, ref_report.affected_users)
    np.testing.assert_array_equal(report.touched_users, ref_report.touched_users)
    assert (report.n_events, report.n_batches) == (ref_report.n_events, ref_report.n_batches)
    np.testing.assert_allclose(report.losses, ref_report.losses, rtol=1e-5)
    _assert_states(eng.state, ref_eng.state)
    np.testing.assert_array_equal(eng.seen.numpy(), np.asarray(ref_eng.seen))
    ids = _requests(ds)
    _assert_slates(eng.recommend(ids, return_flags=True), ref_eng, ids)
    # the engine copied the caller's state once: ingest left it alone
    _, state = states
    assert not torch.equal(eng.state.U, state.U)


@pytest.mark.parametrize("prune", [True, False], ids=["pruned", "dense"])
def test_recommend_and_serve_stream_equal_serve_microbatch(world, states, prune):
    """`recommend` and `serve_stream` dispatch through the engine's plan,
    as `serve_microbatch` does: over two full microbatches and a partial
    one of known, non-flagged ids the three give the same slates bit for
    bit."""
    _, state = states
    ds = world["ds"]
    eng = ServingEngine(state, world["index"],
                        ServingConfig(microbatch=MICROBATCH, k=10, prune=prune),
                        train=ds.train, device="cpu")
    ids = np.random.default_rng(2).permutation(ds.n_users)
    ids = ids[~eng._flags(ids)][:2 * MICROBATCH + 13]
    assert len(ids) == 2 * MICROBATCH + 13
    parts = [eng.serve_microbatch(ids[s:s + MICROBATCH]) for s in range(0, len(ids), MICROBATCH)]
    want = [np.concatenate([p[j] for p in parts]) for j in (0, 1)]
    streamed = list(eng.serve_stream(ids))
    assert [len(u) for u, _, _ in streamed] == [MICROBATCH, MICROBATCH, 13]
    np.testing.assert_array_equal(np.concatenate([u for u, _, _ in streamed]), ids)
    got = eng.recommend(ids)
    for j in (0, 1):
        np.testing.assert_array_equal(np.concatenate([s[j + 1] for s in streamed]), want[j])
        np.testing.assert_array_equal(got[j], want[j])
    assert (eng.stats.n_dispatches, eng.stats.n_fallbacks, eng.stats.n_captures) == (9, 0, 0)


@pytest.mark.parametrize("prune", [True, False], ids=["pruned", "dense"])
def test_ingest_then_recommend_equals_a_fresh_engine_on_the_ingested_state(world, states,
                                                                            prune):
    """After `ingest` the engine serves its patched state, no stale view:
    `recommend`'s flags and factor slates equal, bit for bit, those of an
    engine built fresh on the ingested state and seen mask (the popularity
    slates may differ: the stream counts every check-in, a fresh engine
    its distinct pairs)."""
    _, state = states
    ds = world["ds"]
    cfg = ServingConfig(microbatch=MICROBATCH, k=10, prune=prune)
    eng = ServingEngine(state, world["index"], cfg, train=ds.train, nbr=world["nbr"],
                        dmf_cfg=world["cfg"], device="cpu")
    ids = _requests(ds)
    before = eng.recommend(ids)
    assert len(eng.ingest(ds.test, OnlineConfig(**OCFG)).touched_users)
    fresh = ServingEngine(eng.state, world["index"], cfg, seen=eng.seen.numpy(), device="cpu")
    got, want = (e.recommend(ids, return_flags=True) for e in (eng, fresh))
    live = ~got[2]
    np.testing.assert_array_equal(got[2], want[2])
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a[live], b[live])
    assert not np.array_equal(before[0][live], got[0][live])


def test_serve_microbatch_matches_reference(world, states):
    ref_eng, eng = _engines(world, states, True)
    ids = _requests(world["ds"])[-MICROBATCH:]
    got = eng.serve_microbatch(ids, return_flags=True)
    expect = ref_eng.serve_microbatch(ids, return_flags=True)
    for a, b in zip(got[:3], expect[:3]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[1], eng.recommend(ids)[1])


@pytest.mark.parametrize("n", [MICROBATCH, 21], ids=["full", "ragged"])
@pytest.mark.parametrize("prune", [True, False], ids=["pruned", "dense"])
def test_serve_microbatch_mask_behind_the_launch_matches_reference(world, states, prune, n):
    """Unknown (-1, >= I), cold and repeated ids in one dispatch: the port
    maps the ids to their serving rows before the launch and computes the
    fallback mask after it, the reference masks first. Flags and
    popularity slates equal, the other slates' ids the oracle's and values
    the reference's; on the CPU the dispatch plan never engages."""
    ref_state, state = states
    ds = world["ds"]
    train = ds.train[ds.train[:, 0] >= 3]             # users 0, 1, 2 are cold
    ref_eng = RefServingEngine(
        ref_state, world["ref_index"],
        RefServingConfig(microbatch=MICROBATCH, k=10, prune=prune, interpret=True), train=train)
    eng = ServingEngine(state, world["index"],
                        ServingConfig(microbatch=MICROBATCH, k=10, prune=prune), train=train,
                        device="cpu")
    ids = np.random.default_rng(n).integers(3, ds.n_users, n)
    ids[:6] = [-1, ds.n_users, 0, 2, ds.n_users + 40, 1]
    ids[-3:] = ids[6]                                 # repeated
    got = eng.serve_microbatch(ids, return_flags=True)
    expect = ref_eng.serve_microbatch(ids, return_flags=True)
    flags = got[2]
    np.testing.assert_array_equal(flags, np.asarray(expect[2]))
    assert flags[:6].all()
    np.testing.assert_array_equal(got[1][flags], np.asarray(expect[1])[flags])
    np.testing.assert_array_equal(got[1][~flags], _oracle_ids(ref_eng, ids, flags))
    np.testing.assert_allclose(got[0], np.asarray(expect[0]), rtol=1e-6, atol=1e-6)
    assert eng.stats.n_fallbacks == ref_eng.stats.n_fallbacks == int(flags.sum())
    assert (eng.stats.n_captures, eng._plan.replay) == (0, False)


@pytest.mark.parametrize("prune", [True, False], ids=["pruned", "dense"])
def test_serve_microbatch_serves_a_user_warmed_by_ingest_on_its_own_row(world, states, prune):
    """Users 0, 1, 2 start cold (served on row 0, overwritten); after an
    ingest of check-ins of users 0 and 1 their serving rows are their own,
    and their slates and flags equal the reference engine's after the same
    ingest."""
    ref_state, state = states
    ds = world["ds"]
    train = ds.train[ds.train[:, 0] >= 3]
    ref_eng = RefServingEngine(
        ref_state, world["ref_index"],
        RefServingConfig(microbatch=MICROBATCH, k=10, prune=prune, interpret=True), train=train,
        nbr=world["ref_nbr"], dmf_cfg=world["ref_cfg"])
    eng = ServingEngine(state, world["index"],
                        ServingConfig(microbatch=MICROBATCH, k=10, prune=prune), train=train,
                        nbr=world["nbr"], dmf_cfg=world["cfg"], device="cpu")
    ids = np.array([0, 1, 2, 7, 0])
    assert eng.serve_microbatch(ids, return_flags=True)[2][:3].all()
    assert eng._serve_row[:3].tolist() == [0, 0, 0]
    events = np.concatenate([ds.test[:40], [[0, 3], [1, 4]]]).astype(ds.test.dtype)
    eng.ingest(events, OnlineConfig(**OCFG))
    ref_eng.ingest(events, RefOnlineConfig(**OCFG))
    assert eng._serve_row[:3].tolist() == [0, 1, 0]
    got = eng.serve_microbatch(ids, return_flags=True)
    expect = ref_eng.serve_microbatch(ids, return_flags=True)
    np.testing.assert_array_equal(got[2], np.asarray(expect[2]))
    assert got[2].tolist() == [False, False, True, False, False]
    np.testing.assert_array_equal(got[1][~got[2]], _oracle_ids(ref_eng, ids, got[2]))
    np.testing.assert_allclose(got[0], np.asarray(expect[0]), rtol=1e-6, atol=1e-6)


def test_serve_microbatch_refuses_unknown_ids_with_the_fallback_off(world, states):
    """With the fallback off an id outside [0, I) raises before any
    dispatch, rather than being served on its clipped row."""
    _, state = states
    ds = world["ds"]
    eng = ServingEngine(state, world["index"],
                        ServingConfig(microbatch=MICROBATCH, k=10, fallback=False),
                        train=ds.train, device="cpu")
    for bad in (-1, ds.n_users):
        with pytest.raises(IndexError):
            eng.serve_microbatch(np.array([3, bad]))
    assert eng.stats.n_dispatches == 0
    vals, idx, _ = eng.serve_microbatch(np.array([3, 4]))
    np.testing.assert_array_equal(idx, eng.recommend([3, 4])[1])


def test_online_refresh_and_test_loss_match_reference(world, states):
    ref_state, state = states
    ds = world["ds"]
    events = ds.test[:100]
    ref_copy = ref_dmf.DMFState(*(jnp.array(x) for x in (ref_state.U, ref_state.P, ref_state.Q)))
    copy = dmf.DMFState(*(x.clone() for x in (state.U, state.P, state.Q)))
    ref_out, ref_report = ref_online.online_refresh(
        ref_copy, world["ref_nbr"], events, world["ref_cfg"], RefOnlineConfig(steps=3),
        np.random.default_rng(5))
    out, report = online.online_refresh(
        copy, world["nbr"], events, world["cfg"], OnlineConfig(steps=3),
        np.random.default_rng(5))
    assert out.U is copy.U                          # updated in place
    np.testing.assert_allclose(report.losses, ref_report.losses, rtol=1e-5)
    _assert_states(out, ref_out)
    np.testing.assert_allclose(dmf.test_loss(out, ds.test), ref_dmf.test_loss(ref_out, ds.test),
                               rtol=1e-5)
