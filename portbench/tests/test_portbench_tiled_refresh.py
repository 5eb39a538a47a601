"""The tiled int8 refresh cell (``million.refresh_int8``) on the CPU at a
small size (3,000 users, 2,000 POIs, 16 cities, cells of 128), through the
program's plain-kernel path: its runs traced and untraced, the reference
against the program's own index and codes, the controls and the fault
that set its limits, kernel 6's count by hand, and the cell's per-layer
readers on a trace of a real pass with device events put in."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import control_tiled
from portbench.counts import least_seconds, peaks_for, tiled_quant
from portbench.devtrace import Trace
from portbench.loops import tiled_refresh
from portbench.manifest import ROOT, Manifest
from portbench.reference import tiled as ref
from portbench.runner import run_cell

CELL = "million.refresh_int8"
MAN = Manifest()
CONFIG = {"world": {"n_users": 3000, "n_items": 2000, "n_cities": 16}}
TRAFFIC = {"microbatch": 256, "orders": 2}
SEED = 2 ** 31 + 41
H100 = "NVIDIA H100 80GB HBM3"
PHASES = ("prepare", "upload", "launch", "readback", "finish")


@pytest.fixture(scope="module")
def config():
    return MAN.config(CELL, CONFIG)


@pytest.fixture(scope="module")
def bench(config):
    # the traced pass first, however slow the pass is here
    traffic = MAN.traffic(CELL, {**TRAFFIC, "trace_after_share": 0.0})
    b = tiled_refresh.Bench(config, traffic, SEED, torch.device("cpu"))
    b.run_window(0.3, True)
    return b


@pytest.mark.parametrize("trace", [0, 1])
def test_small_cpu_run_is_correct(trace):
    result, lines = run_cell(CELL, SEED, 0.5, bool(trace), device="cpu", config_overrides=CONFIG,
                             traffic_overrides=TRAFFIC)
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0 and result["attempted"] % 3000 == 0
    assert set(result["checks"]) == {"score_gap", "rank_gap", "bad_slates", "failed"}
    assert result["checks"]["score_gap"]["value"] <= 1e-6         # 10x under the limit
    want = {m["name"] for m in (MAN.per_layer(CELL) if trace else MAN.end_to_end(CELL))}
    if trace:    # no device events on the CPU: the trace readers find nothing
        assert result["metrics"] == {}
    else:
        assert set(result["metrics"]) == want == {"slates_per_s", "refresh_p95_ms", "setup_s"}
    assert len(lines) == 4


def test_cell_names_its_nine_layer_metrics():
    assert {m["name"] for m in MAN.per_layer(CELL)} == {
        "tiled_quant_roofline", "host_ms_per_dispatch.tiled", "idle_share.refresh", "mfu.tiled",
        *(f"{p}_ms_per_dispatch.tiled" for p in PHASES)}


def test_reference_cells_windows_and_codes_equal_the_programs(bench, config):
    """The reference's split, window width, int8 scales and codes equal the
    program's index and store bit for bit, on factors where POI 0's view
    is the largest in most windows, so that most padded windows' scales
    come from their padding."""
    from repro_torch.serving.store import SyntheticFactors, TiledFactorStore
    sv = config["serving"]
    cell_i, cell_u = bench.split
    flat = bench.engine.store.index
    # each user's cell holds the POIs of the user's bucket
    for u in range(0, bench.engine.store.n_users, 7):
        items = flat.bucket_items[flat.user_bucket[u]]
        assert set(items[items >= 0]) == set(np.flatnonzero(cell_i == cell_u[u]))
    f = dict(bench.factors)
    f["B1"] = f["B1"].copy()
    f["B1"][0] *= 50.0
    store = TiledFactorStore.from_checkins(
        SyntheticFactors(B1=f["B1"], B2=f["B2"], s_user=f["s"], U=f["U"]), flat, bench.checkins,
        device="cpu")
    store.quantize_int8()
    r = ref.Reference(bench.world, f, bench.checkins, cell_cap=sv["cell_cap"],
                      pad_to=sv["pad_to"], k=sv["k"], device="cpu", block=700)
    assert r.cap == store.cap == 128
    padded = np.flatnonzero(flat.bucket_size[flat.user_bucket] < 128)
    assert len(padded) > 100
    for a in range(0, r.I, 700):
        items, _, _, _, w = r._block(a, min(a + 700, r.I), "int8")
        users = torch.arange(a, min(a + 700, r.I))
        # the program's window in ascending POI order, padding dropped
        cand = torch.as_tensor(flat.bucket_items[flat.user_bucket[users.numpy()]]).long()
        got = store.q_codes[users].float() * store.q_scale[users][:, None, None]
        for row in range(len(users)):
            keep = cand[row] >= 0
            n = int(keep.sum())
            assert torch.equal(items[row, :n], cand[row][keep])
            assert torch.equal(w[row, :n], got[row][keep])
    # the padding (POI 0's view) sets the scale of most padded users here
    pad = torch.as_tensor(flat.bucket_items[flat.user_bucket[padded]] < 0)[..., None]
    win = store.slab[padded].abs()
    from_padding = win.masked_fill(~pad, 0).amax((1, 2)) > win.masked_fill(pad, 0).amax((1, 2))
    assert int(from_padding.sum()) > 0.9 * len(padded)


@pytest.mark.parametrize("precision", control_tiled.WINDOWS)
def test_unquantized_and_bf16_windows_read_above_the_limits(config, precision):
    limits = MAN.limits(CELL)
    r = control_tiled.window_control(config, SEED, precision, torch.device("cpu"))
    assert r["score_gap"] > 10 * limits["score_gap"]
    assert r["bad_slates"] == 0


def test_padding_widening_counts_the_users_whose_padding_sets_the_scale(config):
    r = control_tiled._inputs(config, SEED, torch.device("cpu"))
    got = control_tiled.padding_widening(r)
    assert got["of"] == 3000 and 0 <= got["users"] < 3000 and got["widest"] >= 0
    r.B1[0] *= 50.0           # POI 0's view now the widest in most padded windows
    wide = control_tiled.padding_widening(r)
    assert wide["users"] > max(got["users"], 1000) and wide["widest"] > 1


def test_a_code_moved_by_one_reads_above_the_score_limit():
    limits = MAN.limits(CELL)
    rows = list(control_tiled.readings([SEED], [], [SEED], 0.2, "cpu", config_overrides=CONFIG,
                                       traffic_overrides=TRAFFIC))
    (_, _, sound), (what, _, fault) = rows
    assert what == "code_moved"
    assert sound["score_gap"] < limits["score_gap"] / 10
    assert fault["score_gap"] > limits["score_gap"]


def test_the_judge_counts_bad_slates(bench):
    """Slates with an id outside the cell, a repeat, a seen POI or a live
    slot dead each count once; so does a popularity slate altered."""
    r = bench.reference()
    vals, ids = r.serve("int8")
    assert r.judge([(vals, ids)]) == {"score_gap": r.judge([(vals, ids)])["score_gap"],
                                      "rank_gap": 0.0, "bad_slates": 0.0}
    cell_i, cell_u = bench.split
    warm = np.flatnonzero(~r.fallback & (bench.live >= 2))
    bad_ids = ids.copy()
    u = warm[:4]
    bad_ids[u[0], 0] = np.flatnonzero(cell_i != cell_u[u[0]])[0]     # outside the cell
    bad_ids[u[1], 1] = bad_ids[u[1], 0]                              # repeated
    seen_j = bench.checkins[bench.checkins[:, 0] == u[2], 1][0]
    bad_ids[u[2], 0] = seen_j                                        # seen
    bad_ids[u[3], 0] = -1                                            # live slot dead
    assert r.judge([(vals, bad_ids)])["bad_slates"] == 4.0
    # users 0-9 without check-ins get the popularity slate
    sv = bench.config["serving"]
    cold = ref.Reference(bench.world, bench.factors, bench.checkins[bench.checkins[:, 0] >= 10],
                         cell_cap=sv["cell_cap"], pad_to=sv["pad_to"], k=sv["k"], device="cpu")
    vals, ids = cold.serve("int8")
    assert cold.fallback[:10].all() and not cold.fallback[10:].any()
    assert (ids[:10] == cold.pop_ids).all() and cold.judge([(vals, ids)])["bad_slates"] == 0
    vals[3, 2] *= 0.5
    assert cold.judge([(vals, ids)])["bad_slates"] == 1.0


def test_count_by_hand():
    # 2,048 users, K=8, k=10: id 8 + bucket 8 + U 32 + scale 4 + slate 80 =
    # 132 B a user; their cells' 122,880 real columns at codes 8 + seen 1 B;
    # distinct cells of 30,000 POIs in all at 4 B an id
    nbytes, ops = tiled_quant.count(2048, 122_880, 30_000, 100_000, 8, 10)
    assert nbytes == 2048 * 132 + 122_880 * 9 + 30_000 * 4 == 1_496_256
    assert ops == 100_000 * 17
    # bytes bind: the least time is the bytes over the bandwidth
    assert least_seconds(nbytes, ops, peaks_for(H100)) == nbytes / 3.35e12


@pytest.mark.parametrize("users, cells", [([128, 128, 128], [128, 128, 128]),
                                          ([64, 64, 17], [64, 64, 17]),
                                          ([1, 128, 60, 60], [1, 128, 60])])
def test_count_over_real_columns(users, cells):
    # the cell size of each user and of each distinct cell (the last two
    # users share one): 132 B a user, 9 B a real column of the user's cell,
    # 4 B a POI id of each distinct cell; full cells count what the kernel
    # reads, padding included (1,284 B a user, 512 B a cell of 128)
    nbytes, _ = tiled_quant.count(len(users), sum(users), sum(cells), 0, 8, 10)
    assert nbytes == 132 * len(users) + 9 * sum(users) + 4 * sum(cells)
    if set(users) == {128}:
        assert nbytes == len(users) * 1284 + len(cells) * 512


def _with_device_events(bench):
    """The bench's traced CPU pass (its real spans) with one kernel 6
    launch inside each dispatch's launch phase and a copy inside its
    readback, each half its phase long. Returns (trace, kernel µs, busy
    µs)."""
    evs = []
    for name, spans in bench.trace.annotations.items():
        evs += [{"ph": "X", "cat": "user_annotation", "name": name, "ts": a, "dur": b - a}
                for a, b in spans]
    kernel = busy = 0.0
    for (a, b), (c, d) in zip(bench.trace.spans("tiled.launch"),
                              bench.trace.spans("tiled.readback")):
        evs.append({"ph": "X", "cat": "kernel", "ts": a, "dur": (b - a) / 2,
                    "name": "void serve_topk_kernel<16, 8, (anonymous namespace)::"
                            "TiledQuant<signed char> >(float const*, ...)"})
        evs.append({"ph": "X", "cat": "gpu_memcpy", "ts": c, "dur": (d - c) / 2,
                    "name": "Memcpy DtoH (Device -> Pageable)"})
        kernel += (b - a) / 2
        busy += (b - a) / 2 + (d - c) / 2
    return Trace({"traceEvents": evs}), kernel, busy


def test_layer_readers_on_a_traced_pass(bench, monkeypatch):
    n_disp = -(-3000 // 256)
    assert len(bench.profiled) == 1 and len(bench.trace.spans("tiled.dispatch")) == n_disp
    assert bench.layer_context() == {}              # no device events on the CPU
    # the count's columns are the real POIs of the reference's cells
    cell_i, cell_u = bench.split
    size = np.bincount(cell_i)
    order = bench.profiled[0]
    counts = bench.dispatch_counts(order)
    assert sum(c[1] for c in counts) == size[cell_u].sum() < 3000 * 128
    assert counts[0][2] == size[np.unique(cell_u[order[:256]])].sum()
    assert sum(c[3] for c in counts) == bench.live.sum() < size[cell_u].sum()
    trace, kernel_us, busy_us = _with_device_events(bench)
    monkeypatch.setattr(bench, "trace", trace)
    ctx = bench.layer_context()
    assert len(ctx["dispatches"]) == len(ctx["dispatch_counts"]) == n_disp
    assert sum(n for _, _, n, _ in ctx["dispatches"]) == 3000
    peaks = peaks_for(H100)
    got = {m["name"]: MAN.reader(m["name"]).read(ctx, peaks) for m in MAN.per_layer(CELL)}
    assert all(v is not None for v in got.values()), got
    least = sum(least_seconds(b, o, peaks) for b, o in ctx["dispatch_counts"])
    assert got["tiled_quant_roofline"] == pytest.approx(100 * least / (kernel_us / 1e6))
    (a, b), = ctx["passes"]
    assert got["mfu.tiled"] == pytest.approx(100 * least / ((b - a) / 1e6))
    assert got["idle_share.refresh"] == pytest.approx(100 * (1 - busy_us / (b - a)))
    host = sum((e - s) for s, e, _, _ in ctx["dispatches"]) - busy_us
    assert got["host_ms_per_dispatch.tiled"] == pytest.approx(host / 1e3 / n_disp)
    phases = sum(got[f"{p}_ms_per_dispatch.tiled"] for p in PHASES)
    assert 0 < phases < got["host_ms_per_dispatch.tiled"]
    # without the program's dispatch spans only the pass-wide readers read
    bare = Trace({"traceEvents": [e for e in _raw(bench.trace) if not
                                  e["name"].startswith("tiled.")]})
    monkeypatch.setattr(bench, "trace", bare)
    ctx = bench.layer_context()
    assert "dispatches" not in ctx
    read = {m["name"]: MAN.reader(m["name"]).read(ctx, peaks) for m in MAN.per_layer(CELL)}
    assert {n for n, v in read.items() if v is not None} == {
        "tiled_quant_roofline", "idle_share.refresh", "mfu.tiled"}


def _raw(tr: Trace) -> list[dict]:
    evs = [{"ph": "X", "cat": cat, "name": name, "ts": a, "dur": b - a}
           for a, b, name, cat in tr.device]
    for name, spans in tr.annotations.items():
        evs += [{"ph": "X", "cat": "user_annotation", "name": name, "ts": a, "dur": b - a}
                for a, b in spans]
    return evs


def test_the_tiled_reference_loads_nothing_of_the_program():
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT), str(ROOT / "src")])}
    code = ("import sys, json, portbench.reference.tiled, portbench.data.synthetic_world, "
            "portbench.counts.tiled_quant, portbench.control_tiled\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not names & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
