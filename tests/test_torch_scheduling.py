"""The port's scheduling subsystem (`repro_torch.scheduling`: workload
generators, request metrics, the continuous-batching scheduler and the
lockstep baseline) on the CPU, and against the reference's
(`repro.scheduling`).

* Workloads: `generate`, `replay`, `to_json`/`from_json` and the CLI's
  file equal the reference's bit for bit (the same numpy draws in the same
  order), for poisson and on/off × uniform and power-law users.
* Decisions: one stub engine class (``cfg.microbatch``, ``cfg.n_shards =
  1``, ``_n_users``, a `serve_microbatch` with a fixed service time and
  slates computed from the ids) drives both packages' `Scheduler` and
  `simulate_lockstep`. Statuses, dispatch starts, completions, fallback
  flags, slates, queue gauges, dispatch counts and `summary()` are equal
  exactly under deadline, queue-only and no admission, priorities, expiry,
  queue overflow and fallback users. The stub has no ingest windows: the
  reference's refresh warm-up needs a real engine.
* Real engines on a state carried across from the reference's `fit`:
  each package's scheduled and lockstep slates equal its own direct
  `recommend` of the same users bit for bit; the port's values are within
  1e-6 abs + rel of the reference's and its ids equal the reference's jnp
  oracle (the reference's Pallas merge may reorder exact ties across
  tiles: ROADMAP §C1). An ingest window interleaved into an idle gap leaves
  the slates before and after it bit for bit those of a no-ingest engine
  and of an engine after the same ingest.

The world is the reference scheduling tests' (80 users, 50 items, 600
ratings, K=6, B=64, 4 epochs); engines at microbatch 8, k=5. The
reference's sharded scheduling tests wait for learner sharding.
"""
import json
import types

import numpy as np
import pytest

from repro_torch.core import dmf, graph, metrics
from repro_torch.data import synthetic_poi
from repro_torch.scheduling import (Scheduler, SchedulerConfig, WorkloadConfig, generate,
                                    simulate_lockstep, summarize)
from repro_torch.scheduling import workload as wl
from repro_torch.scheduling.metrics import (EXPIRED, REJECTED_DEADLINE, REJECTED_QUEUE_FULL,
                                            SERVED, RequestRecord)
from repro_torch.serving import ServingConfig, ServingEngine, index_from_dataset

MICROBATCH, K_TOP = 8, 5


@pytest.fixture(scope="module")
def ref():
    """The reference's scheduling modules; skips where JAX is missing."""
    pytest.importorskip("jax")
    from repro.scheduling import metrics as ref_metrics
    from repro.scheduling import scheduler as ref_scheduler
    from repro.scheduling import workload as ref_wl
    return types.SimpleNamespace(wl=ref_wl, scheduler=ref_scheduler, metrics=ref_metrics)


# ------------------------------------------------------------------ workload
WORKLOADS = [dict(process=p, users=u) for p in ("poisson", "onoff") for u in ("uniform",
                                                                               "powerlaw")]


def _fields(reqs):
    return [(r.rid, r.user, r.arrival, r.deadline, r.priority) for r in reqs]


@pytest.mark.parametrize("kw", WORKLOADS, ids=lambda kw: f"{kw['process']}-{kw['users']}")
def test_generate_and_json_equal_the_reference_bit_for_bit(ref, kw):
    for slo, levels, seed in ((50.0, 1, 0), (0.0, 3, 11)):
        args = dict(n_requests=700, rate_rps=3000.0, duty_cycle=0.25, zipf_s=1.1, slo_ms=slo,
                    priority_levels=levels, seed=seed, **kw)
        got = generate(WorkloadConfig(**args), 97)
        want = ref.wl.generate(ref.wl.WorkloadConfig(**args), 97)
        assert _fields(got) == _fields(want)
        assert json.dumps(wl.to_json(got)) == json.dumps(ref.wl.to_json(want))
        assert _fields(wl.from_json(wl.to_json(got))) == _fields(
            ref.wl.from_json(ref.wl.to_json(want)))


def test_replay_and_cli_equal_the_reference(ref, tmp_path):
    rng = np.random.default_rng(4)
    t = np.sort(rng.uniform(3.0, 9.0, 50))
    users, pr = rng.integers(-2, 90, 50), rng.integers(0, 3, 50)
    for slo in (20.0, 0.0, float("inf")):
        assert _fields(wl.replay(t, users, slo, pr)) == _fields(ref.wl.replay(t, users, slo, pr))
    argv = ["--n", "64", "--n-users", "9", "--process", "onoff", "--burst-factor", "4",
            "--duty-cycle", "0.25", "--users", "powerlaw", "--priority-levels", "2",
            "--seed", "5"]
    wl.main(argv + ["-o", str(tmp_path / "port.json")])
    ref.wl.main(argv + ["-o", str(tmp_path / "ref.json")])
    assert (tmp_path / "port.json").read_text() == (tmp_path / "ref.json").read_text()


def test_poisson_arrivals_rate_and_determinism():
    cfg = WorkloadConfig(n_requests=4000, rate_rps=1000.0, seed=5)
    reqs = generate(cfg, n_users=64)
    t = np.asarray([r.arrival for r in reqs])
    assert t[0] == 0.0 and (np.diff(t) >= 0).all()
    assert 0.9 * cfg.rate_rps < (len(t) - 1) / (t[-1] - t[0]) < 1.1 * cfg.rate_rps
    assert _fields(generate(cfg, n_users=64)) == _fields(reqs)
    other = generate(WorkloadConfig(n_requests=4000, rate_rps=1000.0, seed=6), n_users=64)
    assert [r.arrival for r in other] != [r.arrival for r in reqs]
    assert all(r.deadline == pytest.approx(r.arrival + 0.05) for r in reqs)


def test_onoff_keeps_the_mean_rate_but_bursts_and_refuses_bad_configs():
    tp = np.asarray([r.arrival for r in generate(
        WorkloadConfig(n_requests=6000, rate_rps=1000.0, seed=1), 8)])
    tb = np.asarray([r.arrival for r in generate(WorkloadConfig(
        n_requests=6000, rate_rps=1000.0, process="onoff", burst_factor=4.0, duty_cycle=0.25,
        seed=1), 8)])
    assert 850.0 < (len(tb) - 1) / (tb[-1] - tb[0]) < 1150.0
    cv = lambda t: np.diff(t).std() / np.diff(t).mean()  # noqa: E731
    assert cv(tb) > cv(tp) * 1.2
    for bad in (dict(process="onoff", burst_factor=8.0, duty_cycle=0.5),
                dict(process="gamma"), dict(users="zipf"), dict(process="onoff", duty_cycle=1.0)):
        with pytest.raises(ValueError):
            WorkloadConfig(**bad)


def test_powerlaw_users_concentrate_on_the_head():
    n_users = 256
    users = np.asarray([r.user for r in generate(
        WorkloadConfig(n_requests=8000, users="powerlaw", zipf_s=1.2, seed=2), n_users)])
    assert users.min() >= 0 and users.max() < n_users
    top = np.sort(np.bincount(users, minlength=n_users))[::-1][: n_users // 10].sum()
    assert top / len(users) > 0.5
    uni = np.asarray([r.user for r in generate(WorkloadConfig(n_requests=8000, seed=2),
                                               n_users)])
    assert np.sort(np.bincount(uni, minlength=n_users))[::-1][: n_users // 10].sum() / len(
        uni) < 0.25


def test_replay_json_roundtrip_and_cli(tmp_path):
    reqs = wl.replay([3.0, 3.5, 4.0], [7, 1, 7], slo_ms=20.0, priorities=[0, 2, 1])
    assert [r.arrival for r in reqs] == [0.0, 0.5, 1.0]
    assert [r.priority for r in reqs] == [0, 2, 1]
    with pytest.raises(ValueError):
        wl.replay([1.0, 0.5], [0, 1])
    best_effort = wl.replay([0.0, 1.0], [2, 3], slo_ms=0)
    assert all(np.isinf(r.deadline) for r in best_effort)
    orig = reqs + best_effort
    # exact on the serialized fields (rids renumbered, an inf deadline null)
    assert [f[1:] for f in _fields(wl.from_json(wl.to_json(orig)))] == [
        f[1:] for f in _fields(orig)]
    out = tmp_path / "trace.json"
    wl.main(["--n", "16", "--n-users", "8", "--process", "onoff", "--burst-factor", "4",
             "--duty-cycle", "0.25", "-o", str(out)])
    assert len(wl.from_json(json.loads(out.read_text()))) == 16


# ------------------------------------------------- decisions on a stub engine
class StubEngine:
    """The engine surface the schedulers read: ``cfg.microbatch``,
    ``cfg.n_shards`` (1), ``_n_users`` and `serve_microbatch`, with a
    fixed service time and slates computed from the ids (ids outside
    [0, n_users) flagged)."""

    def __init__(self, microbatch: int, n_users: int = 40, dt: float = 0.004, k: int = 3):
        self.cfg = types.SimpleNamespace(microbatch=microbatch, n_shards=1, k=k)
        self._n_users = n_users
        self.dt = dt
        self.batches = []

    def serve_microbatch(self, user_ids, return_flags: bool = False):
        u = np.asarray(user_ids, np.int64)
        assert 0 < len(u) <= self.cfg.microbatch
        self.batches.append(u.tolist())
        flags = (u < 0) | (u >= self._n_users)
        safe = np.where(flags, 0, u)[:, None] + np.arange(self.cfg.k)
        vals = (1.0 / (1.0 + safe)).astype(np.float32)
        idx = (safe * 7 % 50).astype(np.int32)
        vals[flags], idx[flags] = -1.0, -1
        return (vals, idx, flags, self.dt) if return_flags else (vals, idx, self.dt)


def _scenario(name):
    """(requests kwargs for `generate` or a replay, SchedulerConfig kwargs,
    microbatch)."""
    if name == "deadline":
        return dict(gen=dict(n_requests=80, rate_rps=2500.0, slo_ms=12.0, seed=3)), {}, 4
    if name == "queue_only":
        return dict(replay=(np.zeros(50), np.arange(50) % 40, 0)), dict(
            queue_cap=12, admission="queue_only"), 4
    if name == "none":
        return dict(gen=dict(n_requests=60, rate_rps=4000.0, slo_ms=5.0, seed=8)), dict(
            admission="none"), 8
    if name == "priority":
        return dict(gen=dict(n_requests=60, rate_rps=3000.0, slo_ms=30.0, priority_levels=3,
                             seed=9)), dict(max_wait_ms=1.0), 4
    if name == "expiry":
        return dict(replay=(np.linspace(0, 0.001, 6), np.arange(6), 1e-3)), dict(
            max_wait_ms=2.0), 32
    if name == "overflow":
        return dict(gen=dict(n_requests=120, rate_rps=20000.0, slo_ms=0, users="powerlaw",
                             seed=2)), dict(queue_cap=16), 4
    assert name == "fallback"
    return dict(replay=(np.linspace(0, 0.001, 7), [7, 43, -2, 0, 11, 40, 39], 0)), {}, 8


def _requests(w, mod):
    if "gen" in w:
        return mod.generate(mod.WorkloadConfig(**w["gen"]), 40)
    t, u, slo = w["replay"]
    return mod.replay(t, u, slo_ms=slo)


def _decisions(rep, slo):
    recs = [(r.rid, r.user, r.shard, r.priority, r.status, r.dispatch_start, r.completion,
             r.fallback, r.ingest_epoch,
             None if r.vals is None else (r.vals.tolist(), r.idx.tolist()))
            for r in rep.records]
    gauges = [(g.t, g.shard, g.depth, g.oldest_age, g.batch_occupancy) for g in rep.gauges]
    return (json.dumps(recs), gauges, rep.n_dispatches_per_shard,
            json.dumps(rep.summary(slo_ms=slo), sort_keys=True))


SCENARIOS = ("deadline", "queue_only", "none", "priority", "expiry", "overflow", "fallback")


@pytest.mark.parametrize("name", SCENARIOS)
def test_scheduler_and_lockstep_decisions_equal_the_reference(ref, name):
    w, skw, R = _scenario(name)
    slo = w.get("gen", {}).get("slo_ms", 50.0)
    got, want = [], []
    for out, wmod, smod in ((got, wl, None), (want, ref.wl, ref.scheduler)):
        reqs = _requests(w, wmod)
        for run in ("scheduler", "lockstep"):
            eng = StubEngine(R)
            if smod is None:
                rep = (Scheduler(eng, SchedulerConfig(**skw)).run(reqs) if run == "scheduler"
                       else simulate_lockstep(eng, reqs))
            else:
                rep = (smod.Scheduler(eng, smod.SchedulerConfig(**skw)).run(reqs)
                       if run == "scheduler" else smod.simulate_lockstep(eng, reqs))
            out.append((_decisions(rep, slo), eng.batches))
    assert got == want
    statuses = json.loads(got[0][0][0])
    kinds = {rec[4] for rec in statuses}
    expect = {"deadline": {SERVED, REJECTED_DEADLINE}, "queue_only": {REJECTED_QUEUE_FULL},
              "expiry": {EXPIRED}, "overflow": {REJECTED_QUEUE_FULL}}.get(name, {SERVED})
    assert expect <= kinds, kinds
    if name == "priority":
        served = [rec for rec in statuses if rec[4] == SERVED]
        assert len({rec[3] for rec in served}) == 3
    if name == "fallback":
        assert [rec[7] for rec in statuses] == [False, True, True, False, False, True, False]


def test_priority_dispatches_before_earlier_arrivals():
    eng = StubEngine(8)
    pr = np.asarray([0, 1] * 8)
    reqs = wl.make_requests(np.zeros(16), np.arange(16), slo_ms=0, priorities=pr)
    rep = Scheduler(eng, SchedulerConfig(admission="none")).run(reqs)
    served = {r.rid: r for r in rep.served()}
    hi = [served[r.rid].dispatch_start for r in reqs if r.priority == 1]
    lo = [served[r.rid].dispatch_start for r in reqs if r.priority == 0]
    assert max(hi) <= min(lo)


def test_impossible_slo_expires_everything_without_dispatch():
    eng = StubEngine(32)
    reqs = wl.replay(np.linspace(0, 0.001, 6), np.arange(6), slo_ms=1e-3)
    rep = Scheduler(eng, SchedulerConfig(max_wait_ms=2.0)).run(reqs)
    assert all(r.status == EXPIRED for r in rep.records)
    assert eng.batches == []
    s = rep.summary(slo_ms=1e-3)
    assert s["n_served"] == 0 and s["goodput_rps"] == 0.0
    assert s["expired_frac"] == 1.0 and s["slo_attainment"] == 0.0


def test_burst_beyond_queue_capacity_rejects_the_overflow():
    n, cap = 50, 12
    reqs = wl.replay(np.zeros(n), np.arange(n) % 40, slo_ms=0)
    rep = Scheduler(StubEngine(4), SchedulerConfig(queue_cap=cap, admission="queue_only")).run(
        reqs)
    s = rep.summary()
    assert s["n_rejected_queue_full"] == n - cap and s["n_served"] == cap
    assert s["rejected_frac"] == pytest.approx((n - cap) / n)
    with pytest.raises(ValueError):
        SchedulerConfig(admission="fifo")


# ------------------------------------------------------------------- metrics
def test_summarize_empty_and_slo_accounting():
    assert summarize([], [], slo_ms=50.0)["goodput_rps"] == 0.0
    recs = [
        RequestRecord(rid=0, user=0, shard=0, arrival=0.0, deadline=0.010, status=SERVED,
                      dispatch_start=0.0, completion=0.005),
        RequestRecord(rid=1, user=1, shard=0, arrival=0.0, deadline=0.010, status=SERVED,
                      dispatch_start=0.0, completion=0.020),
        RequestRecord(rid=2, user=2, shard=0, arrival=0.001, deadline=0.011, status=EXPIRED),
    ]
    s = summarize(recs, None, slo_ms=10.0)
    assert s["n_served"] == 2 and s["n_expired"] == 1
    assert s["slo_attainment"] == pytest.approx(1 / 3)
    assert s["goodput_rps"] == pytest.approx(1 / 0.020)
    assert s["p99_slo_met"] is False
    assert s["latency_ms"]["p99_ms"] > 10.0


def test_offered_load_is_the_gap_mle_with_a_degenerate_fallback():
    from repro_torch.scheduling import metrics as sched_metrics
    recs = [RequestRecord(rid=i, user=i, shard=0, arrival=0.5 * i, deadline=float("inf"),
                          status=SERVED, dispatch_start=0.5 * i, completion=0.5 * i + 0.01)
            for i in range(3)]
    assert summarize(recs)["offered_load_rps"] == pytest.approx(2 / 1.0)
    assert "(n_arrivals - 1)" in sched_metrics.__doc__
    one = [RequestRecord(rid=0, user=0, shard=0, arrival=1.0, deadline=2.0, status=SERVED,
                         dispatch_start=1.0, completion=1.05)]
    assert summarize(one)["offered_load_rps"] == pytest.approx(1 / 0.05)
    burst = [RequestRecord(rid=i, user=i, shard=0, arrival=0.0, deadline=1.0, status=SERVED,
                           dispatch_start=0.0, completion=0.25) for i in range(4)]
    assert summarize(burst)["offered_load_rps"] == pytest.approx(4 / 0.25)
    lost = [RequestRecord(rid=0, user=0, shard=0, arrival=0.0, deadline=0.1, status=EXPIRED)]
    assert summarize(lost)["offered_load_rps"] == 0.0


# ------------------------------------------------------------- real engines
@pytest.fixture(scope="module")
def world(ref):
    """The reference's trained state on its small world, carried across;
    the port's neighbour table and config on the same data."""
    from repro.core import dmf as ref_dmf
    from repro.core import graph as ref_graph
    ds = synthetic_poi.generate(synthetic_poi.POIDatasetConfig(
        n_users=80, n_items=50, n_ratings=600, n_cities=4, seed=0))
    kw = dict(n_users=ds.n_users, n_items=ds.n_items, dim=6, beta=0.1, gamma=0.01,
              batch_size=64)
    rg = ref_graph.GraphConfig(n_neighbors=2, walk_length=3)
    ref_nbr = ref_graph.walk_neighbor_table(
        ref_graph.build_adjacency(ds.user_coords, ds.user_city, rg), rg)
    ref_cfg = ref_dmf.DMFConfig(**kw)
    ref_state = ref_dmf.fit(ref_cfg, ds.train, ref_nbr, epochs=4).state
    g = graph.GraphConfig(n_neighbors=2, walk_length=3)
    nbr = graph.walk_neighbor_table(graph.build_adjacency(ds.user_coords, ds.user_city, g), g,
                                    device="cpu")
    state = dmf.state_from_numpy(*(np.asarray(x) for x in (ref_state.U, ref_state.P,
                                                           ref_state.Q)), device="cpu")
    return dict(ds=ds, nbr=nbr, cfg=dmf.DMFConfig(**kw), state=state, ref_nbr=ref_nbr,
                ref_cfg=ref_cfg, ref_state=ref_state)


def _engine(world, **kw):
    return ServingEngine(world["state"], index_from_dataset(world["ds"]),
                         ServingConfig(microbatch=MICROBATCH, k=K_TOP), train=world["ds"].train,
                         nbr=world["nbr"], dmf_cfg=world["cfg"], device="cpu", **kw)


def _ref_engine(world):
    from repro.serving import ServingConfig as RefServingConfig
    from repro.serving import ServingEngine as RefServingEngine
    from repro.serving import index_from_dataset as ref_index
    return RefServingEngine(world["ref_state"], ref_index(world["ds"]),
                            RefServingConfig(microbatch=MICROBATCH, k=K_TOP),
                            train=world["ds"].train, nbr=world["ref_nbr"],
                            dmf_cfg=world["ref_cfg"])


def _oracle_ids(ref_eng, users):
    """The reference's jnp oracle (`lax.top_k` on the masked window
    scores) over the reference engine's own state."""
    import jax.numpy as jnp
    from repro.kernels import ref as ref_kernels
    rows = np.asarray(users)
    cand = np.asarray(ref_eng._bucket_items)[np.asarray(ref_eng._user_bucket)[rows]]
    safe = np.maximum(cand, 0)
    U, V, seen = (np.asarray(x) for x in (ref_eng.state.U, ref_eng.V, ref_eng.seen))
    _, idx = ref_kernels.serve_topk_window_ref(
        jnp.asarray(U[rows]), jnp.asarray(V[rows[:, None], safe]), jnp.asarray(cand),
        jnp.asarray(seen[rows[:, None], safe]), K_TOP)
    return np.asarray(idx)


def _assert_equal_to_recommend(served, vals, idx, flags):
    for j, r in enumerate(served):
        np.testing.assert_array_equal(r.vals, vals[j])
        np.testing.assert_array_equal(r.idx, idx[j])
        assert r.fallback == bool(flags[j])


def test_scheduled_and_lockstep_slates_equal_recommend_and_the_reference(ref, world):
    ds = world["ds"]
    reqs = wl.generate(WorkloadConfig(n_requests=60, rate_rps=500.0, users="powerlaw",
                                      slo_ms=0, seed=3), ds.n_users)
    got = {}
    for pkg, sched, make in (("port", None, lambda: _engine(world)),
                             ("ref", ref.scheduler, lambda: _ref_engine(world))):
        for run in ("scheduler", "lockstep"):
            eng = make()
            rep = ((Scheduler(eng).run(reqs) if run == "scheduler" else simulate_lockstep(
                eng, reqs)) if sched is None else (sched.Scheduler(eng).run(reqs)
                                                   if run == "scheduler"
                                                   else sched.simulate_lockstep(eng, reqs)))
            served = rep.served()
            assert len(served) == len(reqs)          # no SLO: everything is served
            users = [r.user for r in served]
            _assert_equal_to_recommend(served, *make().recommend(users, return_flags=True))
            if run == "lockstep":                    # FIFO: completions in arrival order
                comp = [r.completion for r in served]
                assert all(a <= b for a, b in zip(comp, comp[1:]))
            got[pkg, run] = served
    ref_eng = _ref_engine(world)
    for run in ("scheduler", "lockstep"):
        port, want = got["port", run], got["ref", run]
        assert [r.rid for r in port] == [r.rid for r in want]
        flags = np.asarray([r.fallback for r in port])
        assert flags.tolist() == [r.fallback for r in want]
        np.testing.assert_allclose(np.stack([r.vals for r in port]),
                                   np.stack([r.vals for r in want]), rtol=1e-6, atol=1e-6)
        users = np.asarray([r.user for r in port])
        np.testing.assert_array_equal(np.stack([r.idx for r in port])[~flags],
                                      _oracle_ids(ref_eng, users[~flags]))


def test_fallback_users_flow_through_admission_and_get_flagged(world):
    ds = world["ds"]
    seen = metrics.masks_from_interactions(ds.n_users, ds.n_items, ds.train)
    seen[7] = False                                  # a cold user
    kw = dict(seen=seen, device="cpu")
    eng = ServingEngine(world["state"], index_from_dataset(ds),
                        ServingConfig(microbatch=MICROBATCH, k=K_TOP), **kw)
    users = [7, ds.n_users + 3, -2, 0, 11]
    rep = Scheduler(eng, SchedulerConfig()).run(
        wl.replay(np.linspace(0, 0.001, len(users)), users, slo_ms=0))
    served = rep.served()
    assert [r.status for r in rep.records] == [SERVED] * len(users)
    assert [r.fallback for r in served] == [True, True, True, False, False]
    direct = ServingEngine(world["state"], index_from_dataset(ds),
                           ServingConfig(microbatch=MICROBATCH, k=K_TOP), **kw)
    _assert_equal_to_recommend(served, *direct.recommend(np.asarray(users), return_flags=True))


@pytest.mark.parametrize("dp", [False, True], ids=["dp_off", "dp_on"])
def test_ingest_interleaves_into_the_idle_gap_and_stays_snapshot_exact(world, dp):
    """The refresh runs between two bursts, never behind a queued request,
    and the slates on both sides equal the matching factor snapshot's."""
    import dataclasses
    ds = world["ds"]
    if dp:
        world = dict(world, cfg=dataclasses.replace(world["cfg"], dp_sigma=0.5, dp_clip=0.25,
                                                    dp_seed=2))
    users = np.random.default_rng(9).integers(0, ds.n_users, 24)
    t = np.concatenate([np.linspace(0, 0.005, 12), 60.0 + np.linspace(0, 0.005, 12)])
    events = ds.test[:8].astype(np.int64)
    eng = _engine(world)
    before = [x.clone() for x in (eng.state.U, eng.state.P, eng.state.Q)]
    rep = Scheduler(eng, SchedulerConfig()).run(wl.replay(t, users, slo_ms=0),
                                                ingest_events=[events])
    assert rep.n_ingest_windows == 1 and len(rep.ingest_reports) == 1
    (t0, t1), = rep.ingest_intervals
    assert 0.005 <= t0 and t1 <= 60.0
    served = rep.served()
    pre = [r for r in served if r.ingest_epoch == 0]
    post = [r for r in served if r.ingest_epoch == 1]
    assert len(pre) == 12 and len(post) == 12
    _assert_equal_to_recommend(pre, *_engine(world).recommend([r.user for r in pre],
                                                              return_flags=True))
    ingested = _engine(world)
    ingested.ingest(events)
    _assert_equal_to_recommend(post, *ingested.recommend([r.user for r in post],
                                                         return_flags=True))
    # the warm-up step ran on clones: the only change to the served state
    # is the ingest window's
    for a, b in zip((ingested.state.U, ingested.state.P, ingested.state.Q),
                    (eng.state.U, eng.state.P, eng.state.Q)):
        assert a.equal(b)
    assert not before[0].equal(eng.state.U)
