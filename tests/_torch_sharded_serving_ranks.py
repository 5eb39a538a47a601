"""What each rank runs in the port's sharded serving tests
(`tests/test_torch_sharded_serving.py`).

The ranks are processes started by `repro_torch.launch.mesh.spawn_ranks`,
which imports these functions by name; this module imports only numpy,
torch and `repro_torch`, so a rank starts without JAX. `serving_case`
runs every case of one shard count on the CPU, one thread a rank, on
states the test carries across from the reference's `fit` as numpy
arrays, and returns host data; rank 0's return value reaches the test.
Where the test asks that every rank saw the same thing, each rank hashes
it and rank 0 returns every rank's digest (`digests`).
"""
from __future__ import annotations

import hashlib
import json

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import dmf, graph, metrics
from repro_torch.data import synthetic_poi
from repro_torch.scheduling import Scheduler, WorkloadConfig, generate, simulate_lockstep
from repro_torch.scheduling import workload as wl
from repro_torch.serving import CandidateIndex, ServingConfig, ServingEngine, index_from_dataset
from repro_torch.sharding import dmf as sharded_dmf

MICROBATCH, K_TOP, N_REQUESTS = 16, 5, 150
SCHED_MICROBATCH = 8
N_INGEST_REQUESTS, N_EVENTS = 96, 20


def world(n_users=90, n_items=70, n_ratings=800, seed=0):
    """The reference sharded serving tests' world (`test_dmf_sharded.py`
    `_world(n_users=90, n_items=70, n_ratings=800)`; 80 users, 50 items,
    600 ratings for the scheduling tests)."""
    ds = synthetic_poi.generate(synthetic_poi.POIDatasetConfig(
        n_users=n_users, n_items=n_items, n_ratings=n_ratings, n_cities=4, seed=seed))
    gcfg = graph.GraphConfig(n_neighbors=2, walk_length=3)
    W = graph.build_adjacency(ds.user_coords, ds.user_city, gcfg)
    return ds, graph.walk_neighbor_table(W, gcfg, device="cpu")


def config(ds) -> dmf.DMFConfig:
    return dmf.DMFConfig(n_users=ds.n_users, n_items=ds.n_items, dim=6, batch_size=64,
                         beta=0.1, gamma=0.01)


def request_users(n_users: int) -> np.ndarray:
    return np.random.default_rng(0).integers(0, n_users, N_REQUESTS)


def ingest_inputs(ds) -> tuple[np.ndarray, np.ndarray]:
    """`test_sharded_engine_ingest_stays_in_sync`'s users and events."""
    rng = np.random.default_rng(1)
    users = rng.integers(0, ds.n_users, N_INGEST_REQUESTS)
    events = np.stack([rng.integers(0, ds.n_users, N_EVENTS),
                       rng.integers(0, ds.n_items, N_EVENTS)], 1)
    return users, events


def fallback_inputs(ds, index):
    """A seen mask with a cold user, an index with one emptied bucket, and
    requests of known, unknown, cold and empty-bucket users, as numpy
    (the test builds the reference's index from the same arrays)."""
    seen = metrics.masks_from_interactions(ds.n_users, ds.n_items, ds.train)
    seen[5] = False                                    # a cold user
    items = np.array(index.bucket_items)
    empty = int(index.user_bucket[7])
    items[empty] = -1                                  # user 7's bucket, emptied
    sizes = np.array(index.bucket_size)
    sizes[empty] = 0
    users = np.concatenate([[5, 7, -3, ds.n_users, ds.n_users + 9, 0],
                            np.arange(ds.n_users)])
    return seen, dict(bucket_items=items, bucket_size=sizes,
                      city_size=np.array(index.city_size),
                      user_bucket=np.array(index.user_bucket), n_items=index.n_items), users


def digest(obj) -> bytes:
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()).digest()


def digests(obj) -> list[str]:
    """Every rank's digest of ``obj`` (a collective; rank order)."""
    mine = torch.frombuffer(bytearray(digest(obj)), dtype=torch.uint8)
    out = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(out, mine)
    return [bytes(row.tolist()).hex() for row in out]


def factors(state: dmf.DMFState) -> tuple:
    return state.U, state.P, state.Q


def state_digest(state: dmf.DMFState) -> list:
    return [hashlib.sha256(x.numpy().tobytes()).hexdigest() for x in factors(state)]


def same_state(a: dmf.DMFState, b: dmf.DMFState) -> bool:
    return all(torch.equal(x, y) for x, y in zip(factors(a), factors(b)))


def decisions(rep) -> list:
    """A report as JSON data: records, gauges, dispatches per shard, ingest
    intervals."""
    recs = [(r.rid, r.user, r.shard, r.priority, r.status, r.dispatch_start, r.completion,
             r.fallback, r.ingest_epoch,
             None if r.vals is None else (r.vals.tolist(), r.idx.tolist()))
            for r in rep.records]
    gauges = [(g.t, g.shard, g.depth, g.oldest_age, g.batch_occupancy) for g in rep.gauges]
    return [recs, gauges, list(rep.n_dispatches_per_shard),
            [list(iv) for iv in rep.ingest_intervals]]


def _engine(state, index, D, prune=True, microbatch=MICROBATCH, **kw):
    return ServingEngine(state, index, ServingConfig(microbatch=microbatch, k=K_TOP,
                                                     prune=prune, n_shards=D),
                         device="cpu", **kw)


def _served(rep) -> dict:
    served = rep.served()
    return dict(users=[r.user for r in served], shards=[r.shard for r in served],
                vals=np.stack([r.vals for r in served]) if served else None,
                idx=np.stack([r.idx for r in served]) if served else None,
                flags=[r.fallback for r in served],
                completions=[r.completion for r in served],
                ingest_epochs=[r.ingest_epoch for r in served],
                n_dispatches_per_shard=list(rep.n_dispatches_per_shard),
                ingest_intervals=list(rep.ingest_intervals),
                n_records=len(rep.records), digests=digests(decisions(rep)))


def serving_cases(D: int, states: dict) -> dict:
    """`recommend` pruned and dense, `serve_stream` both orders, fallback
    users and ingest, each at D ranks beside the one-device engine."""
    ds, nbr = world()
    cfg = config(ds)
    index = index_from_dataset(ds)
    st = dmf.state_from_numpy(*states["fit6"], device="cpu")
    users = request_users(ds.n_users)
    out = {}
    for prune in (True, False):
        e1 = _engine(st, index, 1, prune, train=ds.train)
        clocked = sharded_dmf.learner_group(D, "cpu", sharded_dmf.ExchangeClock())
        eD = _engine(st, index, D, prune, train=ds.train, group=clocked)
        v1, i1 = e1.recommend(users)
        vD, iD = eD.recommend(users)
        out[f"recommend_{prune}"] = dict(
            v1=v1, i1=i1, vD=vD, iD=iD, n1=e1.stats.n_dispatches, nD=eD.stats.n_dispatches,
            n_requests=eD.stats.n_requests, waves=len(eD.stats.dispatch_seconds),
            exchange=(eD.exchange.calls, eD.exchange.seconds > 0))
        if prune:
            for ordered in (False, True):
                out[f"stream_{ordered}"] = [
                    (ids, v, i) for ids, v, i in eD.serve_stream(users, ordered=ordered)]
    seen, ix, fb_users = fallback_inputs(ds, index)
    fb_index = CandidateIndex(**ix)
    got = {d: _engine(st, fb_index, d, seen=seen) for d in (1, D)}
    out["fallback"] = dict(one=got[1].recommend(fb_users, return_flags=True),
                           sharded=got[D].recommend(fb_users, return_flags=True),
                           unclocked=got[D].exchange is None)
    st4 = dmf.state_from_numpy(*states["fit4"], device="cpu")
    ing_users, events = ingest_inputs(ds)
    eng = {d: _engine(st4, index, d, train=ds.train, nbr=nbr, dmf_cfg=cfg) for d in (1, D)}
    for e in eng.values():
        e.ingest(events)
    out["ingest"] = dict(
        one=eng[1].recommend(ing_users), sharded=eng[D].recommend(ing_users),
        states_equal_one=same_state(eng[1].state, eng[D].state),
        state_digests=digests(state_digest(eng[D].state)))
    return out


def scheduling_cases(D: int, states: dict) -> dict:
    """`tests/test_scheduling.py:130` and `:151` at D ranks, lockstep
    waves on the same stream, and an ingest window between two bursts."""
    ds, nbr = world(n_users=80, n_items=50, n_ratings=600)
    cfg = config(ds)
    index = index_from_dataset(ds)
    st = dmf.state_from_numpy(*states["sched"], device="cpu")

    def make(d=D):
        return _engine(st, index, d, microbatch=SCHED_MICROBATCH, train=ds.train, nbr=nbr,
                       dmf_cfg=cfg)
    out = {}
    eng = make()
    eng.serve_microbatch(np.arange(SCHED_MICROBATCH))     # warm: keeps virtual times sane
    packet = (eng._packet.device.type, eng._packet.data_ptr())
    reqs = generate(WorkloadConfig(n_requests=48, rate_rps=2000.0, slo_ms=0, seed=4),
                    ds.n_users)
    rep = Scheduler(eng).run(reqs)
    out["independent"] = _served(rep)
    out["independent"]["shard_of"] = [Scheduler(eng).shard_of(u)
                                      for u in out["independent"]["users"]]
    out["independent"]["direct"] = make().recommend(out["independent"]["users"],
                                                    return_flags=True)
    out["independent"]["broadcasts"] = len(eng.broadcast_seconds)
    out["independent"]["packet_reused"] = packet == (eng._packet.device.type,
                                                     eng._packet.data_ptr())
    out["independent"]["packet_device"] = packet[0]
    rows = eng._rows
    try:                     # one dispatch takes one shard's users
        eng.serve_microbatch([0, rows])
        out["independent"]["two_shards_raise"] = None
    except ValueError as e:
        out["independent"]["two_shards_raise"] = str(e)
    idle = make()
    rep = Scheduler(idle).run(wl.replay(np.linspace(0, 0.01, 24), np.arange(24) % rows,
                                        slo_ms=0))
    out["empty_shard"] = _served(rep)
    lock = make()
    rep = simulate_lockstep(lock, reqs)
    out["lockstep"] = _served(rep)
    out["lockstep"]["direct"] = make().recommend(out["lockstep"]["users"], return_flags=True)
    out["lockstep"]["waves"] = lock.stats.n_dispatches
    t = np.concatenate([np.linspace(0, 0.005, 12), 60.0 + np.linspace(0, 0.005, 12)])
    users = np.random.default_rng(9).integers(0, ds.n_users, 24)
    events = ds.test[:8].astype(np.int64)
    inter = make()
    rep = Scheduler(inter).run(wl.replay(t, users, slo_ms=0), ingest_events=[events])
    out["ingest"] = _served(rep)
    ingested = make()
    ingested.ingest(events)
    served = out["ingest"]
    pre = [u for u, e in zip(served["users"], served["ingest_epochs"]) if e == 0]
    post = [u for u, e in zip(served["users"], served["ingest_epochs"]) if e == 1]
    served["direct_pre"] = make().recommend(pre, return_flags=True)
    served["direct_post"] = ingested.recommend(post, return_flags=True)
    served["state_digests"] = digests(state_digest(inter.state))
    served["state_equal_ingested"] = same_state(inter.state, ingested.state)
    return out


def serving_case(rank: int, D: int, states: dict) -> dict:
    """Every case of D ranks; the scheduling cases at D=2."""
    torch.set_num_threads(1)
    out = serving_cases(D, states)
    if D == 2:
        out["scheduling"] = scheduling_cases(D, states)
    return out


def card_case(rank: int, D: int, states: dict) -> dict:
    """On the card: the sharded engine's pruned and dense slates beside
    the one-device engine's."""
    ds, _ = world()
    index = index_from_dataset(ds)
    st = dmf.state_from_numpy(*states["fit6"], device="cuda")
    users = request_users(ds.n_users)
    out = {}
    for prune in (True, False):
        kw = dict(train=ds.train, device="cuda")
        cfg = dict(microbatch=MICROBATCH, k=K_TOP, prune=prune)
        one = ServingEngine(st, index, ServingConfig(**cfg), **kw).recommend(users)
        sharded = ServingEngine(st, index, ServingConfig(n_shards=D, **cfg), **kw)
        out[prune] = dict(one=one, sharded=sharded.recommend(users))
    return out

