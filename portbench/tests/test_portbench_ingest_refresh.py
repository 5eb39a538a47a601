"""The online check-in cell (``foursquare.ingest_refresh``) on the CPU at a
small size (300 users, 200 POIs, 8 cities, rounds of 96 check-ins: two
update batches a step, the second padded),
through the program's plain-kernel path: its runs traced and untraced,
the engine's rounds against the reference's replay, the draw, the
control and the faults that set its limits, and the cell's per-layer
readers on a trace of real rounds with device events put in."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import compare, control_online
from portbench.counts import dmf_step, least_seconds, peaks_for, topk_rows, train_epoch
from portbench.devtrace import Trace
from portbench.loops import ingest_refresh as loop
from portbench.loops.refresh import served_factors
from portbench.manifest import ROOT, Manifest
from portbench.reference import dmf as ref_dmf
from portbench.reference import online as ref_online
from portbench.runner import run_cell

CELL = "foursquare.ingest_refresh"
MAN = Manifest()
CONFIG = {"dataset": {"n_users": 300, "n_items": 200, "n_ratings": 2500, "n_cities": 8}}
TRAFFIC = {"microbatch": 64, "events_per_round": 96, "trace_rounds": 2}
SEED = 2 ** 31 + 53
H100 = "NVIDIA H100 80GB HBM3"
LAYER = {"host_ms_per_round.ingest", "sample_ms_per_round.ingest", "update_ms_per_round.ingest",
         "launches_per_round.ingest", "online_step_roofline", "mfu.ingest",
         "touched_share.ingest"}


@pytest.fixture(scope="module")
def config():
    return MAN.config(CELL, CONFIG)


@pytest.fixture(scope="module")
def bench(config):
    # the traced rounds right after the checked ones
    traffic = MAN.traffic(CELL, {**TRAFFIC, "trace_after_share": 0.0})
    b = loop.Bench(config, traffic, SEED, torch.device("cpu"))
    b.run_window(0.2, True)
    b.judge()
    return b


@pytest.mark.parametrize("trace", [0, 1])
def test_small_cpu_run_is_correct(trace):
    result, lines = run_cell(CELL, SEED, 0.3, bool(trace), device="cpu", config_overrides=CONFIG,
                             traffic_overrides=TRAFFIC)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    checks = result["checks"]
    assert set(checks) == {"factor_gap", "untouched_moved", "stale_slates", "score_gap",
                           "rank_gap", "bad_slates", "failed"}
    assert checks["factor_gap"]["value"] < checks["factor_gap"]["limit"] / 5
    assert checks["score_gap"]["value"] <= 1e-6
    if trace:    # no device events on the CPU: the trace readers find nothing
        assert result["metrics"] == {}
    else:
        assert set(result["metrics"]) == {"slates_per_s", "refresh_p95_ms", "setup_s"}
    assert len(lines) == 7


def test_cell_names_its_eight_layer_metrics():
    assert {m["name"] for m in MAN.per_layer(CELL)} == LAYER | {"idle_share.refresh"}
    cfg, traffic = MAN.config(CELL), MAN.traffic(CELL)
    assert cfg["assumed"]["round_events"] == traffic["events_per_round"]
    assert cfg["online"] == {"batch_cap": 256, "steps": 4, "neg_samples": 3}
    assert cfg["dataset"] == MAN.config("foursquare.refresh")["dataset"]


def test_engine_rounds_against_the_reference(config):
    """`ServingEngine.ingest` then `recommend(touched)` a round, on seeded
    random factors: after each round the factors equal the reference's
    replay at every changed entry within float32 rounding, every other
    entry keeps its bits, the touched users are the users the replay
    changed, and the slates are the true top-k of the post-round
    factors."""
    traffic = MAN.traffic(CELL, TRAFFIC)
    b = loop.Bench(config, traffic, SEED, torch.device("cpu"))
    ds = b.ds
    table = ref_dmf.neighbor_table(ds.user_coords, ds.user_city, config["graph"], "cpu")
    initial = served_factors(SEED, ds.n_users, ds.n_items, 10, config["served_scale"], "cpu")
    rep = ref_online.replay(*initial, table, dict(config["model"]), config["online"],
                            loop.engine_seed(SEED))
    rep.round(b.rounds[0])                       # the warm-up round
    for _ in range(3):
        events = b._draw()
        report, vals, idx = b._round(events)
        changed = rep.round(events)
        st = b.engine.state
        gap, moved = loop.factor_readings((st.U, st.P, st.Q), rep, initial)
        assert gap < 2e-6 and moved == 0
        assert np.array_equal(report.touched_users, changed)
        assert np.array_equal(report.affected_users, np.unique(events[:, 0]))
        seen = np.concatenate([ds.train, *b.rounds])
        s = compare.judge_slates((changed, vals, idx), st.U, st.P, st.Q, seen, b.k)
        assert s["score_gap"] <= 1e-6 and s["rank_gap"] <= 1e-6 and s["bad_slates"] == 0
    assert b.engine.stats.n_refreshes == 4 and b.engine.stats.n_touched > 0


def test_draw_is_seeded_and_home_city(bench):
    ds = bench.ds
    d = loop.Draw(ds, 4000)
    a, b = d.round(SEED, 3), d.round(SEED, 3)
    assert np.array_equal(a, b) and not np.array_equal(a, d.round(SEED, 4))
    assert (ds.item_city[a[:, 1]] == ds.user_city[a[:, 0]]).all()
    # senders in proportion to their train check-ins + 1, among the users
    # whose city holds a POI
    got = np.bincount(a[:, 0], minlength=ds.n_users)
    want = (np.bincount(ds.train[:, 0], minlength=ds.n_users) + 1) * (d.size[ds.user_city] > 0)
    assert np.corrcoef(got, want)[0, 1] > 0.8


def test_tf32_replay_fails_factor_gap(config):
    limits = MAN.limits(CELL)
    traffic = MAN.traffic(CELL, TRAFFIC)
    r = control_online.tf32_control(config, traffic, SEED, torch.device("cpu"))
    assert r["factor_gap"] > 30 * limits["factor_gap"]


def test_tf32_rounded_program_factors_fail_factor_gap(bench):
    limits = MAN.limits(CELL)
    kept = [c["factors"] for c in bench.checked]
    try:
        for c in bench.checked:
            c["factors"] = tuple(ref_dmf._tf32(x) for x in c["factors"])
        r = bench.judge()
    finally:
        for c, f in zip(bench.checked, kept):
            c["factors"] = f
    assert r["factor_gap"] > 10 * limits["factor_gap"]
    assert bench.judge()["factor_gap"] < limits["factor_gap"] / 5


@pytest.mark.parametrize("fault,check", [("receiver_unscattered", "factor_gap"),
                                         ("receiver_unrefreshed", "stale_slates"),
                                         ("entry_moved", "untouched_moved")])
def test_planted_fault_fails_its_check(fault, check):
    limits = MAN.limits(CELL)
    r = _faulty(fault)
    assert r[check] > limits[check]
    ok, _ = compare.verdict(r, limits)
    assert not ok


def _faulty(fault):
    with control_online.planted(fault):
        result, _ = run_cell(CELL, SEED, 0.1, False, device="cpu", config_overrides=CONFIG,
                             traffic_overrides=TRAFFIC)
    return {name: c["value"] for name, c in result["checks"].items()}


def test_faults_leave_the_program_as_it_was():
    from repro_torch.core import dmf
    from repro_torch.serving import online
    before = (dmf._sparse_batch_update, online.touched_from_events, online.online_refresh)
    for fault in control_online.FAULTS:
        with control_online.planted(fault):
            pass
    assert before == (dmf._sparse_batch_update, online.touched_from_events,
                      online.online_refresh)


def _with_device_events(bench):
    """The bench's traced CPU rounds (their real spans) with one kernel 3
    launch and one scatter kernel inside each ``online.update`` span, and
    one kernel 2 launch inside each refresh, each a quarter of its span
    long. Returns (trace, kernel 3 µs, busy µs inside the ingests, busy
    µs)."""
    evs = []
    for name, spans in bench.trace.annotations.items():
        evs += [{"ph": "X", "cat": "user_annotation", "name": name, "ts": a, "dur": b - a}
                for a, b in spans]
    k3 = busy_in = 0.0
    for a, b in bench.trace.spans("online.update"):
        q = (b - a) / 4
        evs.append({"ph": "X", "cat": "kernel", "ts": a, "dur": q,
                    "name": "void (anonymous namespace)::dmf_fused_step_kernel<false>(...)"})
        evs.append({"ph": "X", "cat": "kernel", "ts": a + 2 * q, "dur": q,
                    "name": "void at::native::indexing_backward_kernel<float>(...)"})
        k3 += q
        busy_in += 2 * q
    refresh = 0.0
    for a, b in bench.trace.spans("portbench.refresh"):
        evs.append({"ph": "X", "cat": "kernel", "ts": a, "dur": (b - a) / 4,
                    "name": "void (anonymous namespace)::topk_rows_kernel<16, 10, true, float>"})
        refresh += (b - a) / 4
    return Trace({"traceEvents": evs}), k3, busy_in, busy_in + refresh


def test_layer_readers_on_traced_rounds(bench, monkeypatch):
    n = TRAFFIC["trace_rounds"]
    assert len(bench.traced) == n and bench.layer_context() == {}    # no device events
    trace, k3_us, busy_in, busy = _with_device_events(bench)
    monkeypatch.setattr(bench, "trace", trace)
    ctx = bench.layer_context()
    assert len(ctx["rounds"]) == len(ctx["ingests"]) == n
    assert ctx["batches"] == [[256, 128] * 4] * n
    assert [len(s) for s in ctx["senders"]] == [96 * 4 * 4] * n
    peaks = peaks_for(H100)
    got = {m["name"]: MAN.reader(m["name"]).read(ctx, peaks) for m in MAN.per_layer(CELL)}
    assert all(v is not None for v in got.values()), got
    ingests, rounds = ctx["ingests"], ctx["rounds"]
    wall_in = sum(e - s for s, e in ingests)
    assert got["host_ms_per_round.ingest"] == pytest.approx((wall_in - busy_in) / 1e3 / n)
    assert got["launches_per_round.ingest"] == 2 * 8
    upd = trace.spans("online.update")
    assert got["update_ms_per_round.ingest"] == pytest.approx(
        (sum(b - a for a, b in upd) - busy_in) / 1e3 / n)
    smp = trace.spans("online.sample")
    assert len(smp) == 4 * n
    assert got["sample_ms_per_round.ingest"] == pytest.approx(sum(b - a for a, b in smp) / 1e3 / n)
    least3 = 4 * n * sum(least_seconds(*dmf_step.count(rows, 10), peaks) for rows in (256, 128))
    assert got["online_step_roofline"] == pytest.approx(100 * least3 / (k3_us / 1e6))
    least = sum(least_seconds(*train_epoch.count(s, ctx["fanout"], 10), peaks)
                + least_seconds(*topk_rows.count(t, 200, 10, 10, seen), peaks)
                for s, t, seen in zip(ctx["senders"], ctx["touched"], ctx["seen_touched"]))
    wall = sum(e - s for s, e in rounds)
    assert got["mfu.ingest"] == pytest.approx(100 * least / (wall / 1e6))
    a, b = ctx["window"]
    assert got["idle_share.refresh"] == pytest.approx(100 * (1 - busy / (b - a)))
    touched, n_rounds = bench.counter
    assert n_rounds == len(bench.rounds) - 1
    assert got["touched_share.ingest"] == pytest.approx(100 * touched / (n_rounds * 300))
    # the seen entries of each traced round's refreshed users, by hand
    r0, users = bench.traced[0]
    seen = np.zeros((300, 200), bool)
    for ev in (bench.ds.train, *bench.rounds[:r0 + 1]):
        seen[ev[:, 0], ev[:, 1]] = True
    assert ctx["seen_touched"][0] == seen[users].sum()


def test_readers_without_the_programs_spans_or_counter(bench, monkeypatch):
    """As on a program without the ingest's spans and ``n_touched``: the
    readers of the benchmark's own spans and of the device still read;
    those of the program's spans and counter read None."""
    trace, _, _, _ = _with_device_events(bench)
    evs = [{"ph": "X", "cat": cat, "name": name, "ts": a, "dur": b - a}
           for a, b, name, cat in trace.device]
    for name, spans in trace.annotations.items():
        if not name.startswith("online."):
            evs += [{"ph": "X", "cat": "user_annotation", "name": name, "ts": a, "dur": b - a}
                    for a, b in spans]
    monkeypatch.setattr(bench, "trace", Trace({"traceEvents": evs}))
    monkeypatch.setattr(bench, "counter", None)
    ctx = bench.layer_context()
    read = {m["name"]: MAN.reader(m["name"]).read(ctx, peaks_for(H100))
            for m in MAN.per_layer(CELL)}
    assert {n for n, v in read.items() if v is None} == {
        "sample_ms_per_round.ingest", "update_ms_per_round.ingest", "touched_share.ingest"}


def test_the_online_reference_loads_nothing_of_the_program():
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT), str(ROOT / "src")])}
    code = ("import sys, json, portbench.reference.online, portbench.control_online, "
            "portbench.loops.ingest_refresh\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not names & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
