"""The port's observability layer (`repro_torch.obs`: the metrics
registry, span tracing with the `torch.profiler` bridge, per-epoch
telemetry) on the CPU, and against the reference's (`repro.obs`) where
both packages run the same calls.

The load-bearing contract: telemetry changes nothing about training.
`fit(telemetry=True)` gives U/P/Q, losses and privacy bit for bit those
of `fit()` in six configurations (plain, DP, churn + DP, an attacked run
under screen + trim, GDMF, LDMF). Against the reference on the same world, seed,
neighbour table and stream: the same event keys; counts (`n_messages`,
`messages_per_shard`, `screen_*`, `n_online`, `ring_occupancy`) and
`dp_eps` exactly equal; the norms within 1e-5 relative and the losses
within 1e-4 relative (the port's scatters sum duplicates in another
order than XLA's, the training slice's bar). Registry snapshots of the
same call sequence, the percentile definition and the publish bridges are
equal exactly; both packages record the same span names and counts for
the same `fit` / `serve_microbatch` / `recommend` / `ingest` / tiled
dispatch calls, beside the port's own phase spans. Spans record under a
torch profiler as its user annotations, on its clock, and a served
microbatch and a training epoch give each phase once, their results bit
for bit those of a run unrecorded.

Every test installs its own registry and tracer in both packages and
restores the process-wide ones after (the suite runs in several workers,
a file each, and a module-level object is shared by every test of one).
The world is the reference robustness tests' (80 users, 50 items, 600
ratings, K=6, B=64).
"""
import json
import types

import numpy as np
import pytest
import torch

from repro_torch.core import dmf, graph
from repro_torch.data import synthetic_poi
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as trace_lib
from repro_torch.obs.telemetry import TELE_KEYS, TELE_W, device_stats_to_dict
from repro_torch.robustness import AttackConfig, ChurnConfig, DefenseConfig
from repro_torch.serving.online import OnlineConfig

EPOCHS = 3
NORM_RTOL, LOSS_RTOL = 1e-5, 1e-4
COUNT_KEYS = ("epoch", "n_messages", "messages_per_shard", "screen_accept", "screen_reject",
              "n_online", "ring_occupancy", "dp_eps")
NORM_KEYS = ("u_update_norm", "q_update_norm", "p_msg_norm", "p_scatter_norm")
DP = dict(dp_sigma=0.3, dp_clip=1.0, dp_seed=3)
CONFIGS = ("plain", "dp", "churn_dp", "screen_trim", "gdmf", "ldmf")
PHASES = ("engine.prepare", "engine.upload", "engine.launch", "engine.readback", "engine.finish")
TRAIN_SPANS = ("dmf.sample", "dmf.upload", "dmf.rounds", "dmf.read")
TILED_PHASES = ("tiled.prepare", "tiled.upload", "tiled.launch", "tiled.readback",
                "tiled.finish")


@pytest.fixture(scope="module")
def ref():
    """The reference's modules; skips where JAX is missing."""
    pytest.importorskip("jax")
    from repro.core import dmf as ref_dmf
    from repro.core import graph as ref_graph
    from repro.obs import metrics as ref_metrics
    from repro.obs import trace as ref_trace
    from repro.obs import telemetry as ref_tele
    from repro.robustness import ChurnConfig as RefChurn
    from repro.robustness.byzantine import AttackConfig as RefAttack
    from repro.robustness.byzantine import DefenseConfig as RefDefense
    return types.SimpleNamespace(dmf=ref_dmf, graph=ref_graph, metrics=ref_metrics,
                                 trace=ref_trace, tele=ref_tele, Churn=RefChurn,
                                 Attack=RefAttack, Defense=RefDefense)


@pytest.fixture
def fresh():
    """A new registry and an enabled tracer in the port (and in the
    reference when it is importable), the process-wide ones restored."""
    mods = [(obs_metrics, trace_lib)]
    try:
        from repro.obs import metrics as ref_metrics
        from repro.obs import trace as ref_trace
        mods.append((ref_metrics, ref_trace))
    except ImportError:
        pass
    saved = [(m.get_registry(), t.get_tracer()) for m, t in mods]
    new = [(m.set_registry(m.MetricsRegistry()), t.set_tracer(t.Tracer(enabled=True)))
           for m, t in mods]
    yield new
    for (m, t), (reg, tr) in zip(mods, saved):
        m.set_registry(reg)
        t.set_tracer(tr)


@pytest.fixture(scope="module")
def world():
    ds = synthetic_poi.generate(synthetic_poi.POIDatasetConfig(
        n_users=80, n_items=50, n_ratings=600, n_cities=4, seed=0))
    gcfg = graph.GraphConfig(n_neighbors=2, walk_length=3)
    W = graph.build_adjacency(ds.user_coords, ds.user_city, gcfg)
    return ds, graph.walk_neighbor_table(W, gcfg, device="cpu")


def _common(ds, dp, mode="dmf"):
    return dict(n_users=ds.n_users, n_items=ds.n_items, dim=6, batch_size=64, beta=0.1,
                gamma=0.01, mode=mode, **(DP if dp else {}))


def _mode(name):
    return name if name in ("gdmf", "ldmf") else "dmf"


def _port_run(ds, name):
    """The port's (DMFConfig, fit kwargs) of one telemetry configuration."""
    kw = dict(epochs=EPOCHS, test=ds.test, device="cpu")
    if name == "churn_dp":
        kw["churn"] = ChurnConfig(dropout=0.2, delay_classes=(0, 1), seed=4)
    if name == "screen_trim":
        kw["attack"] = AttackConfig(family="norm_inflate", frac=0.2, scale=50.0, seed=5)
        kw["defense"] = DefenseConfig(screen=True, norm_cap=2.0, aggregation="trim")
    return dmf.DMFConfig(**_common(ds, name in ("dp", "churn_dp", "screen_trim"),
                                   _mode(name))), kw


def _ref_run(ref, ds, name):
    kw = dict(epochs=EPOCHS, test=ds.test)
    if name == "churn_dp":
        kw["churn"] = ref.Churn(dropout=0.2, delay_classes=(0, 1), seed=4)
    if name == "screen_trim":
        kw["attack"] = ref.Attack(family="norm_inflate", frac=0.2, scale=50.0, seed=5)
        kw["defense"] = ref.Defense(screen=True, norm_cap=2.0, aggregation="trim")
    return ref.dmf.DMFConfig(**_common(ds, name in ("dp", "churn_dp", "screen_trim"),
                                       _mode(name))), kw


def _ref_nbr(ref, ds):
    gcfg = ref.graph.GraphConfig(n_neighbors=2, walk_length=3)
    return ref.graph.walk_neighbor_table(
        ref.graph.build_adjacency(ds.user_coords, ds.user_city, gcfg), gcfg)


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------
def _drive_registry(m):
    """One fixed sequence of registry calls on module ``m``."""
    reg = m.MetricsRegistry()
    c = reg.counter("msgs", help="delivered")
    c.inc(2, shard=0, path="dense")
    c.inc(3, path="dense", shard=0)
    c.inc(shard=1)
    reg.gauge("loss").set(0.5)
    reg.gauge("loss").set(0.25, epoch=3)
    h = reg.histogram("lat")
    h.observe_many([0.01, 0.02, 0.05, 0.3], shard=0)
    h.observe(0.7, shard=1)
    h.reset(shard=1)
    h.observe(0.004, shard=2)
    reg.histogram("empty")
    return reg


def test_registry_snapshots_equal_the_reference(ref):
    assert _drive_registry(obs_metrics).snapshot() == _drive_registry(ref.metrics).snapshot()
    for xs in ([0.010, 0.020, 0.030, 0.050, 0.080, 0.130, 0.210, 0.340], [0.2], []):
        got, want = (m.latency_percentiles(xs, (50, 90, 99)) for m in (obs_metrics, ref.metrics))
        assert json.dumps(got) == json.dumps(want)


class TestRegistry:
    def test_counter_labels_order_insensitive(self):
        reg = obs_metrics.MetricsRegistry()
        c = reg.counter("msgs")
        c.inc(2, shard=0, path="dense")
        c.inc(3, path="dense", shard=0)
        assert c.value(shard=0, path="dense") == 5.0
        assert c.value(path="dense", shard=0) == 5.0
        assert c.value(shard=1, path="dense") == 0.0

    def test_counter_negative_raises(self):
        with pytest.raises(ValueError):
            obs_metrics.MetricsRegistry().counter("c").inc(-1)

    def test_registration_idempotent_kind_clash_raises(self):
        reg = obs_metrics.MetricsRegistry()
        assert reg.gauge("g") is reg.gauge("g")
        with pytest.raises(ValueError):
            reg.counter("g")

    def test_gauge_set_overwrites(self):
        g = obs_metrics.MetricsRegistry().gauge("loss")
        g.set(1.0)
        g.set(0.5)
        assert g.value() == 0.5
        assert np.isnan(g.value(shard=9))

    def test_histogram_snapshot_stats(self):
        reg = obs_metrics.MetricsRegistry()
        reg.histogram("lat").observe_many([0.1, 0.2, 0.3, 0.4], shard=0)
        snap = reg.snapshot()["lat"]
        assert snap["kind"] == "histogram"
        s = snap["values"]["shard=0"]
        assert s["count"] == 4
        assert s["min"] == pytest.approx(0.1)
        assert s["max"] == pytest.approx(0.4)
        assert s["mean"] == pytest.approx(0.25)
        assert s["p50"] == pytest.approx(0.25)

    def test_write_jsonl(self, tmp_path):
        reg = obs_metrics.MetricsRegistry()
        reg.counter("c").inc(7)
        p = tmp_path / "m.jsonl"
        reg.write_jsonl(p, event="e1")
        reg.write_jsonl(p, event="e2")
        lines = [json.loads(ln) for ln in p.read_text().splitlines()]
        assert [ln["event"] for ln in lines] == ["e1", "e2"]
        assert lines[0]["metrics"]["c"]["values"][""] == 7.0


class TestPercentileDedup:
    FIXTURE = [0.010, 0.020, 0.030, 0.050, 0.080, 0.130, 0.210, 0.340]

    def test_three_call_sites_pinned_equal(self):
        from repro_torch.scheduling import metrics as sched_metrics
        from repro_torch.serving.engine import EngineStats

        want = obs_metrics.latency_percentiles(self.FIXTURE)
        assert want["p50_ms"] == pytest.approx(
            float(np.percentile(np.asarray(self.FIXTURE) * 1e3, 50)))
        assert sched_metrics.latency_percentiles(self.FIXTURE) == want
        st = EngineStats(request_seconds=list(self.FIXTURE), dispatch_seconds=list(self.FIXTURE))
        assert st.latency_percentiles() == want
        assert st.dispatch_latency_percentiles() == want
        h = obs_metrics.MetricsRegistry().histogram("h")
        h.observe_many(self.FIXTURE)
        assert h.percentiles() == want

    def test_generator_input_and_empty(self):
        gen = (x for x in self.FIXTURE)
        assert obs_metrics.latency_percentiles(gen) == obs_metrics.latency_percentiles(
            self.FIXTURE)
        empty = obs_metrics.latency_percentiles(())
        assert set(empty) == {"p50_ms", "p95_ms", "p99_ms"}
        assert all(np.isnan(v) for v in empty.values())


# ---------------------------------------------------------------------------
# span tracing and the profiler bridge
# ---------------------------------------------------------------------------
class TestTrace:
    def test_nesting_depth_and_parent(self):
        tr = trace_lib.Tracer(enabled=True)
        with tr.span("outer"):
            with tr.span("inner", item=3):
                pass
        evs = {e["name"]: e for e in tr.events()}
        assert evs["outer"]["args"]["depth"] == 0
        assert "parent" not in evs["outer"]["args"]
        assert evs["inner"]["args"] == {"depth": 1, "parent": "outer", "item": 3}
        assert evs["inner"]["dur"] <= evs["outer"]["dur"]

    def test_chrome_trace_schema_and_json_valid(self, tmp_path):
        tr = trace_lib.Tracer(enabled=True)
        with tr.span("a"):
            pass
        p = tmp_path / "trace.json"
        tr.export_chrome_trace(p)
        doc = json.loads(p.read_text())
        assert doc["displayTimeUnit"] == "ms"
        assert doc["baseTimeNanoseconds"] == tr.base_time_ns
        (x,) = doc["traceEvents"]
        assert x["ph"] == "X"
        for key in ("name", "ph", "ts", "dur", "pid", "tid", "args"):
            assert key in x

    def test_disabled_records_nothing_and_is_null_context(self):
        saved = trace_lib.get_tracer()
        try:
            trace_lib.set_tracer(trace_lib.Tracer())
            tr = trace_lib.Tracer(enabled=False)
            with tr.span("x"):
                pass
            assert tr.events() == []
            assert not trace_lib.get_tracer().enabled
            assert trace_lib.span("anything") is trace_lib._NULL
        finally:
            trace_lib.set_tracer(saved)

    def test_configure_global(self):
        saved = trace_lib.get_tracer()
        try:
            trace_lib.set_tracer(trace_lib.Tracer())
            tracer = trace_lib.configure_tracing(True)
            with trace_lib.span("global-span"):
                pass
            assert any(e["name"] == "global-span" for e in tracer.events())
            trace_lib.configure_tracing(False)
            assert trace_lib.span("off") is trace_lib._NULL
        finally:
            trace_lib.set_tracer(saved)

    def test_torch_profiler_writes_a_trace_only_when_enabled(self, tmp_path):
        off = trace_lib.Tracer(enabled=False)
        with off.torch_profiler(tmp_path / "off", device="cpu") as prof:
            assert prof is None
        assert not (tmp_path / "off").exists() and off.profiler_traces == []
        on = trace_lib.Tracer(enabled=True)
        with on.torch_profiler(tmp_path / "on", device="cpu") as prof:
            torch.ones(64, 64).sum()
        assert prof is not None
        (path,) = on.profiler_traces
        assert path.parent == tmp_path / "on"
        doc = json.loads(path.read_text())
        assert any(e.get("ph") == "X" for e in doc["traceEvents"])

    def test_span_off_without_a_profiler_is_the_shared_null_context(self, fresh):
        (_, tracer), *_ = fresh
        tracer.enabled = False
        assert trace_lib.span("off", n=1) is trace_lib._NULL
        assert tracer.span("off") is trace_lib._NULL
        with trace_lib.span("off"):
            pass
        assert tracer.events() == []

    def test_global_tracer_records_args_under_a_profiler_and_nothing_without(self, fresh):
        (_, tracer), *_ = fresh
        tracer.enabled = False
        with trace_lib.span("before", n=1):
            pass
        with torch.profiler.profile():
            with trace_lib.span("outer", n=2) as sp:
                with trace_lib.span("inner", k=3):
                    pass
                sp.args["late"] = 4
        assert trace_lib.span("after") is trace_lib._NULL
        with trace_lib.span("after", n=5):
            pass
        evs = {e["name"]: e["args"] for e in tracer.events()}
        assert evs == {"inner": {"depth": 1, "parent": "outer", "k": 3},
                       "outer": {"depth": 0, "n": 2, "late": 4}}

    def test_span_under_a_profiler_is_a_user_annotation_nested_in_its_parent(self, fresh):
        with torch.profiler.profile() as prof:
            with trace_lib.span("outer"):
                with trace_lib.span("inner"):
                    torch.ones(8).sum()
        doc = _profiler_doc(prof)
        ann = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in doc["traceEvents"]
               if e.get("cat") == "user_annotation"}
        assert set(ann) == {"outer", "inner"}
        (a, b), (c, d) = ann["outer"], ann["inner"]
        assert a <= c <= d <= b
        ops = [e for e in doc["traceEvents"] if e.get("cat") == "cpu_op"
               and e["name"] == "aten::sum"]
        assert ops and all(c <= e["ts"] <= e["ts"] + e["dur"] <= d for e in ops)

    def test_span_starts_on_the_profilers_clock(self, fresh):
        """Both files' absolute time (``baseTimeNanoseconds`` plus ``ts``)
        put a span's start within 50 µs. The profiler's first annotation
        of a session pays its thread's set-up inside the enter, so one
        span opens first."""
        (_, tracer), *_ = fresh
        with torch.profiler.profile() as prof:
            with trace_lib.span("warm"):
                pass
            for i in range(3):
                with trace_lib.span("timed", i=i):
                    torch.ones(8).sum()
        doc = _profiler_doc(prof)
        theirs = sorted(e["ts"] for e in doc["traceEvents"]
                        if e.get("cat") == "user_annotation" and e["name"] == "timed")
        ours = sorted(e["ts"] for e in tracer.events() if e["name"] == "timed")
        assert len(theirs) == len(ours) == 3
        base_gap_ns = tracer.base_time_ns - doc["baseTimeNanoseconds"]
        for t, o in zip(theirs, ours):
            assert abs(base_gap_ns + (o - t) * 1e3) <= 50e3, (base_gap_ns, o, t)

    def test_spans_from_many_threads_are_all_recorded(self):
        """Threads record into one tracer without a lock (a list append
        each): every span lands, nested under its own thread's parent."""
        import sys
        import threading
        tr = trace_lib.Tracer(enabled=True)
        n_threads, n_spans = 16, 200

        def work(t):
            for i in range(n_spans):
                with tr.span("outer", t=t):
                    with tr.span("inner", t=t, i=i):
                        pass
        saved = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
            assert not any(th.is_alive() for th in threads)
        finally:
            sys.setswitchinterval(saved)
        evs = tr.events()
        assert len(evs) == 2 * n_threads * n_spans
        inner = [e for e in evs if e["name"] == "inner"]
        assert all(e["args"]["depth"] == 1 and e["args"]["parent"] == "outer" for e in inner)
        assert len({(e["args"]["t"], e["args"]["i"]) for e in inner}) == n_threads * n_spans

    def test_device_memory_snapshot_without_a_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert trace_lib.device_memory_snapshot() == [
            {"device": "cpu", "platform": "cpu", "memory_stats": {}}]


def _profiler_doc(prof) -> dict:
    """A finished profile's Chrome trace, through a temporary file."""
    import os
    import tempfile
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.unlink(path)


def _annotations(doc, names) -> dict:
    """The trace's user annotations of ``names``: {name: [(start, end)]}."""
    out = {name: [] for name in names}
    for e in doc["traceEvents"]:
        if e.get("cat") == "user_annotation" and e["name"] in out:
            out[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    return out


@pytest.mark.parametrize("prune", [False, True])
def test_serve_microbatch_phases_under_a_profiler(world, fresh, prune):
    """One dispatch with cold users, an unknown id and padding: under a
    profiler exactly one span of each phase, in order, disjoint and inside
    `engine.serve_microbatch`, whose args count the batch; the slates bit
    for bit those of the same call unrecorded."""
    from repro_torch.serving import ServingConfig, ServingEngine, index_from_dataset
    ds, nbr = world
    (_, tracer), *_ = fresh
    tracer.enabled = False
    cfg = dmf.DMFConfig(**_common(ds, False))
    state = dmf.init_state(cfg, np.random.default_rng(1), device="cpu")
    train = ds.train[ds.train[:, 0] >= 3]             # users 0, 1, 2 are cold
    eng = ServingEngine(state, index_from_dataset(ds),
                        ServingConfig(microbatch=16, k=5, prune=prune), train=train, device="cpu")
    ids = np.array([0, 5, 1, ds.n_users + 7, 9, 2, 40, 63, 11, 4])     # 10 of 16 rows
    off = eng.serve_microbatch(ids, return_flags=True)
    with torch.profiler.profile() as prof:
        on = eng.serve_microbatch(ids, return_flags=True)
    for a, b in zip(off[:3], on[:3]):
        np.testing.assert_array_equal(a, b)
    n_fallback = int(on[2].sum())
    assert n_fallback >= 4                    # the three cold users and the unknown id
    (parent,) = [e for e in tracer.events() if e["name"] == "engine.serve_microbatch"]
    assert parent["args"] == {"depth": 0, "dispatch": 1, "rows": 16, "replay": 0,
                              "n_real": len(ids), "n_fallback": n_fallback}
    ours = [e for e in tracer.events() if e["name"] in PHASES]
    assert sorted(e["name"] for e in ours) == sorted(PHASES)
    assert all(e["args"] == {"depth": 1, "parent": "engine.serve_microbatch", "dispatch": 1}
               for e in ours)
    ann = _annotations(_profiler_doc(prof), ("engine.serve_microbatch",) + PHASES)
    assert all(len(v) == 1 for v in ann.values()), ann
    (lo, hi), *phases = [ann[name][0] for name in ("engine.serve_microbatch",) + PHASES]
    assert lo <= phases[0][0] and phases[-1][1] <= hi
    assert all(a[1] <= b[0] for a, b in zip(phases, phases[1:]))      # in order, disjoint


@pytest.mark.parametrize("prune", [False, True])
def test_serve_microbatch_phases_each_dispatch_under_a_profiler(world, fresh, prune):
    """Three dispatches in a row (a full one, a ragged one, one of unknown
    ids alone): each holds every phase once, in order, inside its own
    `engine.serve_microbatch`, whose ``replay`` is 0 on the CPU."""
    from repro_torch.serving import ServingConfig, ServingEngine, index_from_dataset
    ds, nbr = world
    (_, tracer), *_ = fresh
    tracer.enabled = False
    cfg = dmf.DMFConfig(**_common(ds, False))
    state = dmf.init_state(cfg, np.random.default_rng(2), device="cpu")
    eng = ServingEngine(state, index_from_dataset(ds),
                        ServingConfig(microbatch=8, k=5, prune=prune), train=ds.train,
                        device="cpu")
    batches = [np.arange(8), np.array([5, 5, 9]), np.array([-4, ds.n_users])]
    with torch.profiler.profile() as prof:
        for b in batches:
            eng.serve_microbatch(b)
    parents = [e for e in tracer.events() if e["name"] == "engine.serve_microbatch"]
    assert [(e["args"]["dispatch"], e["args"]["replay"], e["args"]["n_real"])
            for e in parents] == [(d, 0, len(b)) for d, b in enumerate(batches)]
    assert parents[-1]["args"]["n_fallback"] == 2
    assert eng.stats.n_captures == 0
    ann = _annotations(_profiler_doc(prof), ("engine.serve_microbatch",) + PHASES)
    assert all(len(v) == len(batches) for v in ann.values()), ann
    for d, (lo, hi) in enumerate(sorted(ann["engine.serve_microbatch"])):
        phases = [sorted(ann[name])[d] for name in PHASES]
        assert lo <= phases[0][0] and phases[-1][1] <= hi
        assert all(a[1] <= b[0] for a, b in zip(phases, phases[1:]))


def test_train_epoch_spans_under_a_profiler(world, fresh):
    """`fit` under a profiler: each of `train_epoch`'s four spans once an
    epoch, in order inside its `fit.epoch`; U, P, Q bit for bit a run
    unrecorded."""
    ds, nbr = world
    (_, tracer), *_ = fresh
    tracer.enabled = False
    cfg, kw = _port_run(ds, "dp")
    kw = dict(kw, epochs=2)
    off = dmf.fit(cfg, ds.train, nbr, **kw)
    assert tracer.events() == []
    with torch.profiler.profile() as prof:
        on = dmf.fit(cfg, ds.train, nbr, **kw)
    for n in "UPQ":
        assert torch.equal(getattr(on.state, n), getattr(off.state, n)), n
    assert on.train_losses == off.train_losses
    assert _span_counts(tracer) == {"fit.epoch": 2, **{name: 2 for name in TRAIN_SPANS}}
    ann = _annotations(_profiler_doc(prof), ("fit.epoch",) + TRAIN_SPANS)
    for t, (lo, hi) in enumerate(ann["fit.epoch"]):
        spans = [ann[name][t] for name in TRAIN_SPANS]
        assert lo <= spans[0][0] and spans[-1][1] <= hi
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


# ---------------------------------------------------------------------------
# publish() bridges
# ---------------------------------------------------------------------------
def _records(RequestRecord, SERVED, EXPIRED):
    recs = [RequestRecord(rid=i, user=i, shard=0, arrival=0.01 * i, deadline=0.01 * i + 0.1,
                          status=SERVED, dispatch_start=0.01 * i, completion=0.05 * (i + 1))
            for i in range(4)]
    recs.append(RequestRecord(rid=4, user=4, shard=0, arrival=0.05, deadline=0.06,
                              status=EXPIRED))
    return recs


class TestPublish:
    def test_engine_stats_publish(self):
        from repro_torch.serving.engine import EngineStats
        reg = obs_metrics.MetricsRegistry()
        st = EngineStats(n_requests=10, n_dispatches=2, dispatch_seconds=[0.1, 0.2],
                         request_seconds=[0.1] * 10)
        st.publish(registry=reg)
        assert reg.gauge("serving_n_requests").value() == 10
        assert reg.histogram("serving_dispatch_seconds").values() == [0.1, 0.2]
        st.publish(registry=reg)          # re-publish replaces, not re-accumulates
        assert reg.histogram("serving_request_seconds").values() == [0.1] * 10

    def test_scheduler_report_publish(self):
        from repro_torch.scheduling.metrics import SERVED, RequestRecord
        from repro_torch.scheduling.scheduler import SchedulerReport
        reg = obs_metrics.MetricsRegistry()
        recs = [RequestRecord(rid=i, user=i, shard=0, arrival=0.0, deadline=1.0, status=SERVED,
                              completion=0.05 * (i + 1)) for i in range(4)]
        rep = SchedulerReport(records=recs, gauges=[], n_dispatches_per_shard=[4],
                              ingest_intervals=[], ingest_reports=[])
        s = rep.publish(registry=reg)
        assert s["n_served"] == 4
        assert reg.gauge("scheduler_n_served").value() == 4.0
        assert reg.gauge("scheduler_slo_attainment").value() == 1.0
        assert len(reg.histogram("scheduler_request_seconds").values()) == 4

    def test_publish_snapshots_equal_the_reference(self, ref):
        from repro.scheduling import metrics as ref_sched
        from repro.scheduling.scheduler import SchedulerReport as RefReport
        from repro.serving.engine import EngineStats as RefStats
        from repro_torch.scheduling import metrics as sched
        from repro_torch.scheduling.scheduler import SchedulerReport
        from repro_torch.serving.engine import EngineStats
        snaps = []
        for m, Stats, Report, sm in ((obs_metrics, EngineStats, SchedulerReport, sched),
                                     (ref.metrics, RefStats, RefReport, ref_sched)):
            reg = m.MetricsRegistry()
            Stats(n_requests=7, n_dispatches=3, n_refreshes=1, n_events=12, n_fallbacks=2,
                  dispatch_seconds=[0.003, 0.001, 0.002],
                  request_seconds=[0.004, 0.003, 0.005] * 2 + [0.02]).publish(reg, prefix="s")
            gauges = [sm.QueueGauge(t=0.0, shard=0, depth=3, oldest_age=0.002,
                                    batch_occupancy=0.5)]
            rep = Report(_records(sm.RequestRecord, sm.SERVED, sm.EXPIRED), gauges, [4],
                         [(0.3, 0.4)], [None])
            s = rep.publish(reg, slo_ms=50.0)
            snaps.append((reg.snapshot(), json.dumps(s, sort_keys=True)))
        assert snaps[0] == snaps[1]


def _span_counts(tracer) -> dict:
    out: dict[str, int] = {}
    for ev in tracer.events():
        out[ev["name"]] = out.get(ev["name"], 0) + 1
    return out


def test_span_names_and_counts_equal_the_reference(ref, world, fresh):
    """The same calls through both packages record the reference's spans
    alike: `fit.epoch` per epoch, `engine.dispatch` per `recommend`
    microbatch, `engine.serve_microbatch`, `engine.ingest` and
    `tiled.dispatch`. The port adds its own inside them: `train_epoch`'s
    four phases per epoch, `serve_microbatch`'s five, the tiled
    dispatch's five and the ingest's (`online.touched`, `online.sample` a
    step, `online.update` a batch, `engine.patch`)."""
    from repro.serving import ServingConfig as RefServingConfig
    from repro.serving import ServingEngine as RefServingEngine
    from repro.serving import index_from_dataset as ref_index
    from repro.serving import store as ref_store
    from repro_torch.serving import (ServingConfig, ServingEngine, TiledFactorStore,
                                     TiledServingEngine, index_from_dataset)
    ds, nbr = world
    (_, tracer), (_, ref_tracer) = fresh
    cfg, kw = _port_run(ds, "plain")
    ref_cfg, ref_kw = _ref_run(ref, ds, "plain")
    st = dmf.fit(cfg, ds.train, nbr, **kw).state
    ref_st = ref.dmf.fit(ref_cfg, ds.train, _ref_nbr(ref, ds), **ref_kw).state
    ids = np.arange(0, ds.n_users, 3)
    seen = np.zeros((ds.n_users, ds.n_items), bool)
    seen[ds.train[:, 0], ds.train[:, 1]] = True
    eng = ServingEngine(st, index_from_dataset(ds), ServingConfig(microbatch=8, k=5),
                        train=ds.train, nbr=nbr, dmf_cfg=cfg, device="cpu")
    ref_eng = RefServingEngine(ref_st, ref_index(ds), RefServingConfig(microbatch=8, k=5),
                               train=ds.train, nbr=_ref_nbr(ref, ds), dmf_cfg=ref_cfg)
    for e in (eng, ref_eng):
        e.recommend(ids)
        e.serve_microbatch(ids[:5])
        e.ingest(ds.test[:10])
    TiledServingEngine(TiledFactorStore.from_state(st, index_from_dataset(ds), seen),
                       ServingConfig(microbatch=8, k=5)).recommend(ids)
    ref_store.TiledServingEngine(
        ref_store.TiledFactorStore.from_state(ref_st, ref_index(ds), seen),
        RefServingConfig(microbatch=8, k=5)).recommend(ids)
    got, want = _span_counts(tracer), _span_counts(ref_tracer)
    assert {name: c for name, c in got.items() if name in want} == want
    n_disp = -(-len(ids) // 8)
    steps = OnlineConfig().steps        # 40 rows a step: one batch of 256
    assert got == {"fit.epoch": EPOCHS, "engine.dispatch": n_disp,
                   "engine.serve_microbatch": 1, "engine.ingest": 1, "tiled.dispatch": n_disp,
                   **{name: EPOCHS for name in TRAIN_SPANS}, **{name: 1 for name in PHASES},
                   **{name: n_disp for name in TILED_PHASES},
                   "online.touched": 1, "online.sample": steps, "online.update": steps,
                   "engine.patch": 1}
    by_name = {e["name"]: e["args"] for e in tracer.events()}
    assert by_name["tiled.dispatch"]["mode"] == "fp32"
    assert by_name["engine.dispatch"]["prune"] is True
    assert by_name["engine.ingest"]["n_events"] == 10


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", CONFIGS)
def test_telemetry_leaves_training_bit_for_bit(world, fresh, name):
    ds, nbr = world
    cfg, kw = _port_run(ds, name)
    off = dmf.fit(cfg, ds.train, nbr, **kw)
    on = dmf.fit(cfg, ds.train, nbr, telemetry=True, **kw)
    for n in "UPQ":
        assert torch.equal(getattr(on.state, n), getattr(off.state, n)), n
    assert on.train_losses == off.train_losses and on.test_losses == off.test_losses
    assert on.privacy == off.privacy
    assert off.telemetry is None and len(on.telemetry) == EPOCHS


@pytest.mark.parametrize("name", CONFIGS)
def test_telemetry_events_match_the_reference(ref, world, fresh, name):
    ds, nbr = world
    cfg, kw = _port_run(ds, name)
    ref_cfg, ref_kw = _ref_run(ref, ds, name)
    got = dmf.fit(cfg, ds.train, nbr, telemetry=True, **kw).telemetry
    want = ref.dmf.fit(ref_cfg, ds.train, _ref_nbr(ref, ds), telemetry=True, **ref_kw).telemetry
    assert len(got) == len(want) == EPOCHS
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in COUNT_KEYS:
            assert a.get(k) == b.get(k), k
        for k in NORM_KEYS:
            np.testing.assert_allclose(a[k], b[k], rtol=NORM_RTOL, err_msg=k)
        for k in ("train_loss", "test_loss"):
            np.testing.assert_allclose(a[k], b[k], rtol=LOSS_RTOL, err_msg=k)
    assert ("screen_accept" in got[0]) == (name == "screen_trim")
    assert ("dp_eps" in got[0]) == (name in ("dp", "churn_dp", "screen_trim"))
    assert ("n_online" in got[0]) == (name in ("churn_dp", "screen_trim"))
    if name == "screen_trim":
        assert all(ev["screen_reject"] > 0 for ev in got)
    if name == "ldmf":             # purely local: nothing released or scattered
        assert all(ev["n_messages"] == 0 and ev["p_msg_norm"] == 0.0 for ev in got)
    if name == "gdmf":             # no personal factors
        assert all(ev["q_update_norm"] == 0.0 for ev in got)


def test_telemetry_stream_registry_mirror_and_refusals(world, fresh, tmp_path):
    ds, nbr = world
    (reg, _), *_ = fresh
    cfg, kw = _port_run(ds, "churn_dp")
    out = tmp_path / "tele.jsonl"
    res = dmf.fit(cfg, ds.train, nbr, telemetry_out=out, **kw)
    lines = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert lines == res.telemetry
    eps = [ev["dp_eps"] for ev in res.telemetry]
    for t, ev in enumerate(res.telemetry):
        assert ev["epoch"] == t and ev["wall_s"] > 0
        assert 0 < ev["n_online"] <= ds.n_users and ev["ring_occupancy"] >= 0
        assert ev["n_messages"] == ev["messages_per_shard"][0]
        assert "screen_accept" not in ev and "screen_reject" not in ev
    assert eps == sorted(eps) and eps[0] > 0
    assert reg.counter("train_epochs_total").value() == EPOCHS
    assert reg.counter("train_messages_total").value() == sum(
        ev["n_messages"] for ev in res.telemetry)
    assert reg.gauge("train_dp_eps").value() == eps[-1]
    assert len(reg.histogram("train_epoch_seconds").values()) == EPOCHS
    with pytest.raises(ValueError, match="dense_reference"):
        dmf.fit(dmf.DMFConfig(**_common(ds, False)), ds.train,
                np.eye(ds.n_users, dtype=np.float32), epochs=1, dense_reference=True,
                telemetry=True, device="cpu")


def test_device_stats_to_dict_equals_the_reference(ref):
    rng = np.random.default_rng(0)
    one = np.concatenate([rng.random(4), [17.0, 11.0, 6.0]])
    for block in (one, np.stack([one, 2 * one])):
        assert device_stats_to_dict(block) == ref.tele.device_stats_to_dict(block)
    assert TELE_KEYS == ref.tele.TELE_KEYS and TELE_W == ref.tele.TELE_W == 7
    with pytest.raises(ValueError):
        device_stats_to_dict(np.zeros(TELE_W + 1))


def test_telemetry_epoch_reads_the_device_once(world, monkeypatch):
    """A telemetry epoch copies its losses and reduction sum to the host in
    one read: no per-batch `.item()` or `.cpu()`."""
    ds, nbr = world
    cfg = dmf.DMFConfig(**_common(ds, True))
    assert len(ds.train) * (1 + cfg.neg_samples) // cfg.batch_size > 1
    reads = []
    for meth in ("cpu", "item", "tolist", "__float__"):
        orig = getattr(torch.Tensor, meth)

        def counted(self, *a, _orig=orig, _m=meth, **k):
            reads.append(_m)
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, meth, counted)
    state = dmf.init_state(cfg, device="cpu")
    out = dmf.train_epoch(state, nbr, ds.train, cfg, np.random.default_rng(0), device="cpu",
                          tele=True)
    assert reads == ["cpu"]
    assert len(out) == 3 and out[2].shape == (TELE_W,)


# ---------------------------------------------------------------------------
# the CLI's flags
# ---------------------------------------------------------------------------
def test_cli_writes_telemetry_trace_and_metrics(tmp_path, capsys):
    """``--telemetry-out/--trace-out/--metrics-out`` write one JSONL event
    per epoch, a Chrome trace with a ``fit.epoch`` span and `train_epoch`'s
    four phase spans per epoch and one metrics line, and print the
    reference's three report lines; every other line is what the run
    without the flags prints."""
    from repro_torch.launch import dmf_train
    saved = obs_metrics.get_registry(), trace_lib.get_tracer()
    argv = ["--epochs", "3", "--dp-sigma", "1", "--dp-clip", "0.5", "--device", "cpu"]
    paths = {f: tmp_path / f"{f}.json" for f in ("telemetry", "trace", "metrics")}
    try:
        obs_metrics.set_registry(obs_metrics.MetricsRegistry())
        trace_lib.set_tracer(trace_lib.Tracer())
        plain_ev = dmf_train.main(argv)
        plain = capsys.readouterr().out.splitlines()
        assert not trace_lib.get_tracer().enabled
        ev = dmf_train.main(argv + ["--telemetry-out", str(paths["telemetry"]),
                                    "--trace-out", str(paths["trace"]),
                                    "--metrics-out", str(paths["metrics"])])
        out = capsys.readouterr().out.splitlines()
    finally:
        obs_metrics.set_registry(saved[0])
        trace_lib.set_tracer(saved[1])
    assert ev == plain_ev
    new = [ln for ln in out if ln not in plain]
    assert [ln.split()[0] for ln in new] == ["telemetry", "trace", "metrics"]
    assert [ln for ln in out if ln not in new] == plain
    events = [json.loads(ln) for ln in paths["telemetry"].read_text().splitlines()]
    assert [e["epoch"] for e in events] == [0, 1, 2]
    last = json.loads(new[0][len("telemetry "):])
    assert last == {k: events[-1][k] for k in ("epoch", "train_loss", "n_messages")}
    spans = [e for e in json.loads(paths["trace"].read_text())["traceEvents"]
             if e["name"] == "fit.epoch"]
    assert [e["args"]["epoch"] for e in spans] == [0, 1, 2]
    names = [e["name"] for e in json.loads(paths["trace"].read_text())["traceEvents"]]
    assert sorted(names) == sorted(["fit.epoch", *TRAIN_SPANS] * 3)
    assert new[1] == f"trace written to {paths['trace']} (15 events)"
    (line,) = paths["metrics"].read_text().splitlines()
    snap = json.loads(line)
    assert snap["event"] == "dmf_train_final"
    assert snap["metrics"]["train_epochs_total"]["values"][""] == 3.0
