"""Learner-sharded serving in the port (`ServingEngine` with
``ServingConfig(n_shards=D)``, `serve_wave`, `serve_microbatch`, and the
`Scheduler` and `simulate_lockstep` at D ranks) against the port's own
one-device engine and against the reference's sharded engine, on the
CPU. The port runs at D gloo ranks, each a process started by
`repro_torch.launch.mesh.spawn_ranks` (one spawn per D ∈ {2, 4, 8}
running every case of that D: `_torch_sharded_serving_ranks`); the
reference runs its engines at the same ``n_shards`` on its forced
8-device host mesh (`tests/conftest.py`) in this process meanwhile. Both
serve states carried across from the reference's `fit` (the reference
tests' worlds: 90 users, 70 items, 800 ratings for serving, 6 epochs, 4
before an ingest; 80 users, 50 items, 600 ratings, 4 epochs for
scheduling).

Holds: inside the port, the sharded slates equal the one-device
engine's bit for bit (values and ids), pruned and dense, before and
after `ingest`, fallback flags included, and after an ingest every
rank's full U, P, Q are equal bit for bit. Against the reference
(`tests/test_dmf_sharded.py:229`, `:255`): ids equal, values within its
own rtol 1e-6 / atol 1e-7, the same number of waves, fewer than the
one-device dispatches, and `serve_stream` yields the reference's
positions in its order, ordered and not. Scheduling
(`tests/test_scheduling.py:130`, `:151`) at D=2 ranks: the slates equal
`recommend`'s bit for bit, both shards dispatch for themselves, an empty
shard never stalls, an ingest window falls in the idle gap, and every
rank's report (records, gauges, dispatches per shard, ingest intervals)
is the same, as digests gathered from the ranks show. On a stub engine
with a fixed service time, the port's `simulate_lockstep` and `Scheduler`
at two shards make the reference's decisions exactly.
"""
import concurrent.futures
import json
import types

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import _torch_sharded_serving_ranks as ranks  # noqa: E402
from repro.core import dmf as ref_dmf  # noqa: E402
from repro.core import graph as ref_graph  # noqa: E402
from repro.data import synthetic_poi as ref_poi  # noqa: E402
from repro.scheduling import scheduler as ref_scheduler  # noqa: E402
from repro.scheduling import workload as ref_wl  # noqa: E402
from repro.serving import ServingConfig as RefServingConfig  # noqa: E402
from repro.serving import ServingEngine as RefServingEngine  # noqa: E402
from repro.serving import candidates as ref_candidates  # noqa: E402
from repro.serving import index_from_dataset as ref_index  # noqa: E402
from repro_torch.core import dmf  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.scheduling import Scheduler, SchedulerConfig, simulate_lockstep  # noqa: E402
from repro_torch.scheduling import workload as wl  # noqa: E402
from repro_torch.scheduling.metrics import SERVED  # noqa: E402
from repro_torch.serving import ServingConfig, ServingEngine, index_from_dataset  # noqa: E402
from repro_torch.sharding import dmf as sharded_dmf  # noqa: E402

SHARDS = (2, 4, 8)
RTOL, ATOL = 1e-6, 1e-7          # the reference's own sharded serving tolerance
SPAWN_TIMEOUT_S = 240.0


def ref_world(n_users=90, n_items=70, n_ratings=800):
    ds = ref_poi.generate(ref_poi.POIDatasetConfig(n_users=n_users, n_items=n_items,
                                                   n_ratings=n_ratings, n_cities=4, seed=0))
    gcfg = ref_graph.GraphConfig(n_neighbors=2, walk_length=3)
    W = ref_graph.build_adjacency(ds.user_coords, ds.user_city, gcfg)
    cfg = ref_dmf.DMFConfig(n_users=ds.n_users, n_items=ds.n_items, dim=6, batch_size=64,
                            beta=0.1, gamma=0.01)
    return ds, ref_graph.walk_neighbor_table(W, gcfg), cfg


def ref_states() -> dict:
    """The reference's trained states, as numpy, for both packages."""
    out = {}
    for key, kw, epochs in (("fit6", {}, 6), ("fit4", {}, 4),
                            ("sched", dict(n_users=80, n_items=50, n_ratings=600), 4)):
        ds, nbr, cfg = ref_world(**kw)
        st = ref_dmf.fit(cfg, ds.train, nbr, epochs=epochs).state
        out[key] = tuple(np.asarray(x) for x in (st.U, st.P, st.Q))
    return out


def ref_engine(state, index, D, prune=True, **kw):
    st = ref_dmf.DMFState(*(jnp.asarray(x) for x in state))
    return RefServingEngine(st, index, RefServingConfig(microbatch=ranks.MICROBATCH,
                                                        k=ranks.K_TOP, prune=prune,
                                                        n_shards=D), **kw)


def reference_runs(states) -> dict:
    """The reference's engines on the same states and requests: the
    one-device and the D-shard slates and waves, pruned and dense, the
    D-shard streams, the fallback flags, and ingest then recommend."""
    ds, nbr, cfg = ref_world()
    index = ref_index(ds)
    users = ranks.request_users(ds.n_users)
    out = {}
    for prune in (True, False):
        e1 = ref_engine(states["fit6"], index, 1, prune, train=ds.train)
        out["one", prune] = (*e1.recommend(users), e1.stats.n_dispatches)
        for D in SHARDS:
            e = ref_engine(states["fit6"], index, D, prune, train=ds.train)
            out[D, prune] = (*e.recommend(users), e.stats.n_dispatches)
            if prune:
                for ordered in (False, True):
                    out[D, "stream", ordered] = [
                        (np.asarray(i), np.asarray(v), np.asarray(x))
                        for i, v, x in e.serve_stream(users, ordered=ordered)]
    seen, ix, fb_users = ranks.fallback_inputs(ds, index_from_dataset(ds))
    e = ref_engine(states["fit6"], ref_candidates.CandidateIndex(**ix), 1, seen=seen)
    out["fallback"] = e.recommend(fb_users, return_flags=True)
    ing_users, events = ranks.ingest_inputs(ds)
    for D in (1, 4):
        e = ref_engine(states["fit4"], index, D, train=ds.train, nbr=nbr, dmf_cfg=cfg)
        e.ingest(events)
        out["ingest", D] = e.recommend(ing_users)
    return out


@pytest.fixture(scope="module")
def runs():
    """Every shard count's port runs (one spawn each, in a worker thread)
    and the reference's runs (in this thread, meanwhile)."""
    states = ref_states()

    def spawn_all():
        return {D: mesh.spawn_ranks(ranks.serving_case, D, backend="gloo", device="cpu",
                                    timeout_s=SPAWN_TIMEOUT_S, args=(D, states))
                for D in SHARDS}

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(spawn_all)
        ref = reference_runs(states)
        return dict(port=port.result(), ref=ref)


def assert_close_to_reference(vals, idx, ref_vals, ref_idx) -> None:
    np.testing.assert_array_equal(idx, np.asarray(ref_idx))
    np.testing.assert_allclose(vals, np.asarray(ref_vals), rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------- recommend
@pytest.mark.parametrize("prune", [True, False], ids=["pruned", "dense"])
@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_engine_matches_single_shard(runs, n_shards, prune):
    """`test_dmf_sharded.py:229` at D ranks: one wave a mesh-wide
    microbatch, the one-device slates bit for bit, the reference's within
    its tolerance, its number of waves, fewer than one device's
    dispatches; every wave is two all_gathers and one all_reduce."""
    got = runs["port"][n_shards][f"recommend_{prune}"]
    np.testing.assert_array_equal(got["iD"], got["i1"])
    np.testing.assert_array_equal(got["vD"], got["v1"])
    ref_v, ref_i, ref_waves = runs["ref"][n_shards, prune]
    assert_close_to_reference(got["vD"], got["iD"], ref_v, ref_i)
    assert_close_to_reference(got["v1"], got["i1"], *runs["ref"]["one", prune][:2])
    assert got["nD"] == got["waves"] == ref_waves
    assert got["n1"] == runs["ref"]["one", prune][2]
    assert got["nD"] < got["n1"]
    assert got["n_requests"] == ranks.N_REQUESTS
    assert got["exchange"] == (3 * got["waves"], True)     # on the caller's clocked group


@pytest.mark.parametrize("ordered", [False, True], ids=["queue_order", "ordered"])
@pytest.mark.parametrize("n_shards", SHARDS)
def test_serve_stream_yields_the_reference_positions(runs, n_shards, ordered):
    got = runs["port"][n_shards][f"stream_{ordered}"]
    want = runs["ref"][n_shards, "stream", ordered]
    assert [ids.tolist() for ids, _, _ in got] == [ids.tolist() for ids, _, _ in want]
    for (_, v, i), (_, rv, ri) in zip(got, want):
        assert_close_to_reference(v, i, rv, ri)
    ids = np.concatenate([ids for ids, _, _ in got])
    users = ranks.request_users(90)
    if ordered:
        np.testing.assert_array_equal(ids, users)
    else:
        assert sorted(ids.tolist()) == sorted(users.tolist())


@pytest.mark.parametrize("n_shards", SHARDS)
def test_fallback_users_flagged_alike_at_every_shard_count(runs, n_shards):
    """Unknown ids (below 0 and past the last user), a cold user and a
    user whose bucket is empty get the flagged popularity slate at D ranks
    as on one device and in the reference; the rest equal one device's
    slates bit for bit (unknown ids route to no shard: clamped first)."""
    fb = runs["port"][n_shards]["fallback"]
    for a, b in zip(fb["sharded"], fb["one"]):
        np.testing.assert_array_equal(a, b)
    flags = fb["sharded"][2]
    assert flags[:6].tolist() == [True, True, True, True, True, False]
    assert fb["unclocked"]        # no clock unless the caller's group brings one
    ref_v, ref_i, ref_flags = runs["ref"]["fallback"]
    np.testing.assert_array_equal(flags, np.asarray(ref_flags))
    assert_close_to_reference(fb["sharded"][0], fb["sharded"][1], ref_v, ref_i)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_engine_ingest_stays_in_sync(runs, n_shards):
    """`test_dmf_sharded.py:255`: after the same ingest, the D-rank
    slates equal one device's bit for bit (and, at D=4 as there, the
    reference's D=4 and D=1 slates within tolerance); every rank's full
    U, P, Q are equal bit for bit, and equal to one device's."""
    got = runs["port"][n_shards]["ingest"]
    for a, b in zip(got["sharded"], got["one"]):
        np.testing.assert_array_equal(a, b)
    assert got["states_equal_one"]
    assert len(got["state_digests"]) == n_shards and len(set(got["state_digests"])) == 1
    if n_shards == 4:
        for D in (1, 4):
            assert_close_to_reference(*got["sharded"], *runs["ref"]["ingest", D])


# ------------------------------------------------------------ scheduling
def assert_equal_to_direct(got, direct) -> None:
    vals, idx, flags = direct
    np.testing.assert_array_equal(got["vals"], vals)
    np.testing.assert_array_equal(got["idx"], idx)
    assert got["flags"] == flags.tolist()


def assert_every_rank_alike(got, n_ranks=2) -> None:
    assert len(got["digests"]) == n_ranks and len(set(got["digests"])) == 1


def test_scheduler_sharded_bit_identical_and_independent_dispatch(runs):
    """`test_scheduling.py:130` at two ranks: everything served, both
    shards dispatched for themselves (one broadcast a dispatch), routed as
    `shard_of` says, each slate `recommend`'s bit for bit."""
    got = runs["port"][2]["scheduling"]["independent"]
    assert len(got["users"]) == got["n_records"] == 48
    assert all(n > 0 for n in got["n_dispatches_per_shard"])
    assert got["broadcasts"] == sum(got["n_dispatches_per_shard"]) + 1   # and the warm-up's
    assert got["packet_reused"] and got["packet_device"] == "cpu"        # gloo: a host packet
    assert "one shard's users" in got["two_shards_raise"]
    assert got["shards"] == got["shard_of"]
    assert_equal_to_direct(got, got["direct"])
    assert_every_rank_alike(got)


def test_empty_shard_queue_never_stalls_dispatch(runs):
    """`test_scheduling.py:151` at two ranks: all traffic on shard 0."""
    got = runs["port"][2]["scheduling"]["empty_shard"]
    assert len(got["users"]) == 24
    assert got["n_dispatches_per_shard"][0] > 0
    assert got["n_dispatches_per_shard"][1] == 0
    assert_every_rank_alike(got)


def test_lockstep_waves_at_two_ranks_equal_recommend(runs):
    got = runs["port"][2]["scheduling"]["lockstep"]
    assert len(got["users"]) == 48
    assert_equal_to_direct(got, got["direct"])
    comp = got["completions"]
    for d in (0, 1):            # each shard's queue is FIFO (not the two together)
        mine = [c for c, s in zip(comp, got["shards"]) if s == d]
        assert all(a <= b for a, b in zip(mine, mine[1:]))
    assert len(set(comp)) == got["waves"] >= max(got["n_dispatches_per_shard"])
    assert_every_rank_alike(got)


def test_ingest_window_falls_alike_on_every_rank(runs):
    """One ingest window between two bursts at two ranks: it runs in the
    idle gap at the same virtual seconds on both ranks (the largest rank's
    measurement), the slates before and after it equal the matching
    snapshot's, and both ranks' states equal an engine's after the same
    ingest, bit for bit."""
    got = runs["port"][2]["scheduling"]["ingest"]
    (t0, t1), = got["ingest_intervals"]
    assert 0.005 <= t0 and t1 <= 60.0
    epochs = np.asarray(got["ingest_epochs"])
    assert (epochs == 0).sum() == 12 and (epochs == 1).sum() == 12
    for e, key in ((0, "direct_pre"), (1, "direct_post")):
        vals, idx, flags = got[key]
        np.testing.assert_array_equal(got["vals"][epochs == e], vals)
        np.testing.assert_array_equal(got["idx"][epochs == e], idx)
    assert got["state_equal_ingested"]
    assert len(set(got["state_digests"])) == 1
    assert_every_rank_alike(got)


# ------------------------------------------- decisions on a two-shard stub
class ShardedStub:
    """The engine surface both packages' schedulers read at two shards:
    ``cfg``, ``_n_users``, ``_rows``, the fallback state, ``stats``,
    `serve_microbatch` (the per-shard dispatch) and `serve_wave`, each
    with a fixed service time and slates
    computed from the ids (ids outside [0, n_users) flagged)."""

    def __init__(self, microbatch: int, n_users: int = 40, dt: float = 0.004, k: int = 3):
        self.cfg = types.SimpleNamespace(microbatch=microbatch, n_shards=2, k=k, fallback=True)
        self._n_users, self._rows = n_users, -(-n_users // 2)
        self.dt = dt
        self.batches = []
        self._pop_vals = np.full(k, -1.0, np.float32)
        self._pop_items = np.full(k, -1, np.int32)
        self.stats = types.SimpleNamespace(n_requests=0, n_fallbacks=0)

    def _fallback_mask(self, users):
        users = np.asarray(users)
        return (users < 0) | (users >= self._n_users)

    def _slates(self, users):
        safe = np.asarray(users, np.int64)[:, None] + np.arange(self.cfg.k)
        return (1.0 / (1.0 + safe)).astype(np.float32), (safe * 7 % 50).astype(np.int32)

    def serve_microbatch(self, user_ids, return_flags: bool = False):
        u = np.asarray(user_ids, np.int64)
        assert 0 < len(u) <= self.cfg.microbatch
        self.batches.append(u.tolist())
        flags = self._fallback_mask(u)
        vals, idx = self._slates(np.where(flags, 0, u))
        vals[flags], idx[flags] = self._pop_vals, self._pop_items
        return (vals, idx, flags, self.dt) if return_flags else (vals, idx, self.dt)

    def serve_wave(self, uids_local):
        uids_local = np.asarray(uids_local, np.int64)
        self.batches.append(uids_local.tolist())
        rows = uids_local + self._rows * np.arange(2)[:, None]
        vals, idx = self._slates(rows.reshape(-1))
        k = self.cfg.k
        return vals.reshape(2, -1, k), idx.reshape(2, -1, k), self.dt


STUB_SCENARIOS = {
    "deadline": (dict(gen=dict(n_requests=80, rate_rps=2500.0, slo_ms=12.0, seed=3)), {}, 4),
    "none": (dict(gen=dict(n_requests=60, rate_rps=4000.0, slo_ms=5.0, seed=8)),
             dict(admission="none"), 8),
    "priority": (dict(gen=dict(n_requests=60, rate_rps=3000.0, slo_ms=30.0, priority_levels=3,
                               seed=9)), dict(max_wait_ms=1.0), 4),
    "overflow": (dict(gen=dict(n_requests=120, rate_rps=20000.0, slo_ms=0, users="powerlaw",
                               seed=2)), dict(queue_cap=16), 4),
    "fallback": (dict(replay=(np.linspace(0, 0.001, 7), [7, 43, -2, 0, 31, 40, 39], 0)), {}, 8),
}


def _stub_decisions(rep):
    recs = [(r.rid, r.user, r.shard, r.priority, r.status, r.dispatch_start, r.completion,
             r.fallback, None if r.vals is None else (r.vals.tolist(), r.idx.tolist()))
            for r in rep.records]
    gauges = [(g.t, g.shard, g.depth, g.oldest_age, g.batch_occupancy) for g in rep.gauges]
    return json.dumps(recs), gauges, rep.n_dispatches_per_shard


@pytest.mark.parametrize("name", sorted(STUB_SCENARIOS))
def test_two_shard_decisions_equal_the_reference(name):
    """`simulate_lockstep` (waves through `serve_wave`) and `Scheduler`
    (independent per-shard dispatch) at two shards on one stub engine:
    statuses, shards, dispatch starts, completions, fallback flags,
    slates, gauges, dispatches per shard and the batches the engine saw
    are the reference's exactly."""
    w, skw, R = STUB_SCENARIOS[name]
    got, want = [], []
    for out, wmod, port in ((got, wl, True), (want, ref_wl, False)):
        if "gen" in w:
            reqs = wmod.generate(wmod.WorkloadConfig(**w["gen"]), 40)
        else:
            t, u, slo = w["replay"]
            reqs = wmod.replay(t, u, slo_ms=slo)
        for run in ("scheduler", "lockstep"):
            eng = ShardedStub(R)
            if port:
                rep = (Scheduler(eng, SchedulerConfig(**skw)).run(reqs) if run == "scheduler"
                       else simulate_lockstep(eng, reqs))
            else:
                rep = (ref_scheduler.Scheduler(eng, ref_scheduler.SchedulerConfig(**skw)).run(
                    reqs) if run == "scheduler" else ref_scheduler.simulate_lockstep(eng, reqs))
            out.append((_stub_decisions(rep), eng.batches, eng.stats.n_fallbacks))
    assert got == want
    recs = json.loads(got[1][0][0])
    assert {r[2] for r in recs} == {0, 1}                 # both shards had traffic
    if name == "fallback":
        assert [r[7] for r in recs] == [False, True, True, False, False, True, False]
        assert all(r[4] == SERVED for r in recs)


# ---------------------------------------------------------- failure paths
def test_sharded_engine_outside_a_process_group_raises():
    ds, _ = ranks.world()
    st = dmf.init_state(ranks.config(ds), device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        ServingEngine(st, index_from_dataset(ds), ServingConfig(n_shards=2), train=ds.train,
                      device="cpu")
    with pytest.raises(ValueError, match="n_shards"):
        ServingConfig(n_shards=0)
    two = sharded_dmf.LearnerGroup(rank=0, size=2, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="the group has 2 ranks"):
        ServingEngine(st, index_from_dataset(ds), ServingConfig(n_shards=1), train=ds.train,
                      group=two, device="cpu")
