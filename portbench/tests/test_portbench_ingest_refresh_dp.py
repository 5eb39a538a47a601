"""The private online cell (``foursquare.ingest_refresh_dp``) on the CPU at
a small size (300 users, 200 POIs, 8 cities, rounds of 96 check-ins: two
update batches a step, the second padded), through the program's
plain-kernel path: its runs traced and untraced, the engine's DP rounds
against the float64 replay of the mechanism, the replay's noise stream
against its spec's hash words, the released-message count, the clip's
reach, the control and the planted faults that set its limits, and the
readers on a trace of real rounds with device events put in."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import compare, control_online_dp
from portbench.counts import dmf_step, dp_clip_noise, least_seconds, peaks_for
from portbench.devtrace import Trace
from portbench.loops import ingest_refresh_dp as loop
from portbench.loops.ingest_refresh import engine_seed, factor_readings
from portbench.loops.refresh import served_factors
from portbench.manifest import ROOT, Manifest
from portbench.reference import dmf as ref_dmf
from portbench.reference import online_dp as ref_online_dp
from portbench.runner import run_cell

CELL = "foursquare.ingest_refresh_dp"
MAN = Manifest()
CONFIG = {"dataset": {"n_users": 300, "n_items": 200, "n_ratings": 2500, "n_cities": 8}}
TRAFFIC = {"microbatch": 64, "events_per_round": 96, "trace_rounds": 2}
SEED = 2 ** 31 + 53
H100 = "NVIDIA H100 80GB HBM3"
LAYER = {"host_ms_per_round.ingest", "sample_ms_per_round.ingest", "update_ms_per_round.ingest",
         "launches_per_round.ingest", "online_step_roofline", "mfu.ingest",
         "touched_share.ingest", "idle_share.refresh", "dp_noise_roofline"}

# (seed, rid, column, h1, h2) of the stream's spec (lowbias32 words of the
# counter (rid mod 2^23)·512 + 2k and +1 under the row's key), worked out
# apart from both packages
SPEC_WORDS = [(0, 0, 0, 3405691463, 4185281524),
              (7, 255, 9, 2815036064, 3553295644),
              (1234567, 8388608, 3, 3863194829, 162557832),
              (2147483647, 2147483647, 255, 4085301112, 257243981)]
# (dp_seed, draw, round's seed): (dp_seed·0x9E3779B9 + draw) mod 2^32 & 0x7FFFFFFF
SPEC_FOLDS = [(0, 0, 0), (5, 1, 387276958), (3000000000, 2147483645, 1728179709),
              (123456789012, 987654, 206724730)]


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


def test_cell_names_its_metrics_and_differs_from_the_online_cell_in_dp_alone():
    assert {m["name"] for m in MAN.per_layer(CELL)} == LAYER
    assert {m["name"] for m in MAN.end_to_end(CELL)} == {"slates_per_s", "refresh_p95_ms",
                                                         "setup_s"}
    cfg, online = MAN.config(CELL), MAN.config("foursquare.ingest_refresh")
    assert cfg["dp"] == {"sigma": 1.0, "clip": 0.25}
    assert MAN.cell(CELL)["chips"] == 1 and MAN.configs[cfg["name"]]["reduced"] == []
    for key in ("dataset", "model", "graph", "served_scale", "online", "precision"):
        assert cfg[key] == online[key]
    assert {k: v for k, v in MAN.traffic(CELL).items() if k not in ("loop", "why")} == \
        {k: v for k, v in MAN.traffic("foursquare.ingest_refresh").items()
         if k not in ("loop", "why")}
    assert cfg["assumed"]["round_events"] == MAN.traffic(CELL)["events_per_round"]


def test_the_dp_loop_refuses_dp_off():
    cfg = MAN.config("foursquare.ingest_refresh", CONFIG)
    with pytest.raises(ValueError, match="DP on"):
        loop.Bench(cfg, MAN.traffic(CELL, TRAFFIC), SEED, torch.device("cpu"))


@pytest.mark.parametrize("seed,rid,col,h1,h2", SPEC_WORDS)
def test_the_reference_stream_equals_the_spec_words(seed, rid, col, h1, h2):
    got1, got2 = ref_online_dp.stream_words(seed, np.array([rid]), col + 1)
    assert (int(got1[0, col]), int(got2[0, col])) == (h1, h2)
    z = ref_online_dp.stream(seed, np.array([rid]), col + 1)[0, col]
    u1, u2 = ((h1 >> 8) + 1) * 2.0 ** -24, (h2 >> 8) * 2.0 ** -24
    assert z == np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)


@pytest.mark.parametrize("dp_seed,draw,want", SPEC_FOLDS)
def test_the_reference_folds_the_mechanism_seed_as_specified(dp_seed, draw, want):
    assert ref_online_dp.mechanism_seed(dp_seed, draw) == want


def test_engine_rounds_against_the_reference(config):
    """`ServingEngine.ingest` then `recommend(touched)` a round with the
    mechanism on: after each round the factors equal the float64 DP replay
    at every changed entry within float32 rounding, every other entry
    keeps its bits, the touched users are the users the replay changed,
    the slates are the true top-k, and ``EngineStats.n_released`` is the
    replay's count of released messages."""
    traffic = MAN.traffic(CELL, TRAFFIC)
    b = loop.Bench(config, traffic, SEED, torch.device("cpu"))
    ds = b.ds
    table = ref_dmf.neighbor_table(ds.user_coords, ds.user_city, config["graph"], "cpu")
    initial = served_factors(SEED, ds.n_users, ds.n_items, 10, config["served_scale"], "cpu")
    rep = ref_online_dp.replay(*initial, table, dict(config["model"]), config["online"],
                               engine_seed(SEED), config["dp"], loop.dp_seed(SEED))
    rep.round(b.rounds[0])                       # the warm-up round
    for _ in range(3):
        events = b._draw()
        report, vals, idx = b._round(events)
        changed = rep.round(events)
        st = b.engine.state
        gap, moved = factor_readings((st.U, st.P, st.Q), rep, initial)
        assert gap < 2e-6 and moved == 0
        assert np.array_equal(report.touched_users, changed)
        seen = np.concatenate([ds.train, *b.rounds])
        s = compare.judge_slates((changed, vals, idx), st.U, st.P, st.Q, seen, b.k)
        assert s["score_gap"] <= 1e-6 and s["rank_gap"] <= 1e-6 and s["bad_slates"] == 0
    assert rep.n_released == 4 * 4 * 96 * 4                  # rounds × steps × real rows
    assert b.engine.stats.n_released == rep.n_released
    assert len(set(rep.seeds)) == 4                          # a fresh seed every round


def test_the_clip_binds_on_a_share_of_the_messages(bench):
    """The no-clip fault is a real one: some released messages exceed C
    (the positives' ~|u|), most do not (the negatives', conf 1/3)."""
    released, clipped = bench.replayed
    share = 100.0 * clipped / released
    assert 10.0 < share < 60.0, share


def test_tf32_replay_fails_factor_gap(config):
    limits = MAN.limits(CELL)
    traffic = MAN.traffic(CELL, TRAFFIC)
    r = control_online_dp.tf32_control(config, traffic, SEED, torch.device("cpu"))
    assert r["factor_gap"] > 30 * limits["factor_gap"]


def _faulty(fault):
    with control_online_dp.planted(fault):
        result, _ = run_cell(CELL, SEED, 0.1, False, device="cpu", config_overrides=CONFIG,
                             traffic_overrides=TRAFFIC)
    return {name: c["value"] for name, c in result["checks"].items()}


@pytest.mark.parametrize("fault,check", [("noise_left_out", "factor_gap"),
                                         ("clip_left_out", "factor_gap"),
                                         ("seed_reused", "factor_gap"),
                                         ("seed_unfolded", "factor_gap"),
                                         ("noise_on_padded", "untouched_moved")])
def test_planted_fault_fails_its_check(fault, check):
    limits = MAN.limits(CELL)
    r = _faulty(fault)
    assert r[check] > limits[check]
    ok, _ = compare.verdict(r, limits)
    assert not ok


def test_faults_leave_the_program_as_it_was():
    from repro_torch.core import dmf
    from repro_torch.kernels import ops
    from repro_torch.privacy import mechanism
    names = lambda: (mechanism.noise_std, mechanism.epoch_noise_seed, ops.dp_clip_noise,  # noqa: E731
                     dmf._dp_message)
    before = names()
    for fault in control_online_dp.FAULTS:
        with control_online_dp.planted(fault):
            assert names() != before
    assert names() == before


def test_the_window_records_finite_factors(bench):
    st = bench.engine.state
    assert np.isfinite(bench.factor_max) and bench.factor_max > 0
    assert bench.factor_max == max(float(x.abs().max()) for x in (st.U, st.P, st.Q))
    assert bench.judge()["factor_max"] == bench.factor_max


def test_counts_of_one_kernel_8_launch():
    assert dp_clip_noise.count(256, 10) == (21504.0, 256 * 653.0)


def _with_device_events(bench, k8_per_batch=1):
    """The bench's traced CPU rounds (their real spans) with one kernel 3
    launch and ``k8_per_batch`` kernel 8 launches inside each
    ``online.update`` span, each an eighth of its span long. Returns
    (trace, kernel 3 µs, kernel 8 µs)."""
    evs = []
    for name, spans in bench.trace.annotations.items():
        evs += [{"ph": "X", "cat": "user_annotation", "name": name, "ts": a, "dur": b - a}
                for a, b in spans]
    k3 = k8 = 0.0
    for a, b in bench.trace.spans("online.update"):
        q = (b - a) / 8
        evs.append({"ph": "X", "cat": "kernel", "ts": a, "dur": q,
                    "name": "void (anonymous namespace)::dmf_fused_step_kernel<false>(...)"})
        k3 += q
        for i in range(k8_per_batch):
            evs.append({"ph": "X", "cat": "kernel", "ts": a + (2 + i) * q, "dur": q,
                        "name": "(anonymous namespace)::dp_clip_noise_kernel(float const*, "
                                "int const*, float*, int, int, int, unsigned int, float, float)"})
            k8 += q
    return Trace({"traceEvents": evs}), k3, k8


def test_layer_readers_on_traced_rounds(bench, monkeypatch):
    n = TRAFFIC["trace_rounds"]
    assert len(bench.traced) == n and bench.layer_context() == {}    # no device events
    trace, k3_us, k8_us = _with_device_events(bench)
    monkeypatch.setattr(bench, "trace", trace)
    ctx = bench.layer_context()
    assert ctx["batches"] == [[256, 128] * 4] * n
    assert ctx["dp_batches"] == [[1] * 8] * n
    peaks = peaks_for(H100)
    got = {m["name"]: MAN.reader(m["name"]).read(ctx, peaks) for m in MAN.per_layer(CELL)}
    assert all(v is not None for v in got.values()), got
    least8 = 4 * n * sum(least_seconds(*dp_clip_noise.count(rows, 10), peaks)
                         for rows in (256, 128))
    assert got["dp_noise_roofline"] == pytest.approx(100 * least8 / (k8_us / 1e6))
    least3 = 4 * n * sum(least_seconds(*dmf_step.count(rows, 10), peaks) for rows in (256, 128))
    assert got["online_step_roofline"] == pytest.approx(100 * least3 / (k3_us / 1e6))
    assert got["launches_per_round.ingest"] == 2 * 8


def test_dp_noise_roofline_needs_one_launch_a_dp_batch(bench, monkeypatch):
    trace, _, _ = _with_device_events(bench, k8_per_batch=2)
    monkeypatch.setattr(bench, "trace", trace)
    read = MAN.reader("dp_noise_roofline").read
    assert read(bench.layer_context(), peaks_for(H100)) is None
    trace, _, _ = _with_device_events(bench)
    monkeypatch.setattr(bench, "trace", trace)
    ctx = bench.layer_context()
    ctx["dp_batches"] = [[0] * 8] * len(ctx["batches"])      # no batch ran the mechanism
    assert read(ctx, peaks_for(H100)) is None


def test_readers_without_the_programs_dp_arg(bench, monkeypatch):
    """As on a program whose ``online.update`` spans carry no ``dp`` arg:
    the new reader reads None, the online cell's readers still read."""
    trace, _, _ = _with_device_events(bench)
    monkeypatch.setattr(bench, "trace", trace)
    monkeypatch.setattr(bench, "updates", [{k: v for k, v in a.items() if k != "dp"}
                                           for a in bench.updates])
    ctx = bench.layer_context()
    assert ctx["dp_batches"] is None
    read = {m["name"]: MAN.reader(m["name"]).read(ctx, peaks_for(H100))
            for m in MAN.per_layer(CELL)}
    assert {n for n, v in read.items() if v is None} == {"dp_noise_roofline"}


def test_the_dp_reference_loads_nothing_of_the_program():
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT), str(ROOT / "src")])}
    code = ("import sys, json, portbench.reference.online_dp, portbench.control_online_dp, "
            "portbench.loops.ingest_refresh_dp, portbench.counts.dp_clip_noise\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not names & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
