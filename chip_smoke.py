#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (`src/repro_torch`) runs on
the GPU: builds its CUDA kernels, holds each against its plain PyTorch
version on the card, drives the serving slice at full Foursquare scale and
times each kernel beside its bound.

    python3 chip_smoke.py            # needs one CUDA card, no arguments

Phases (any failure raises and exits non-zero; nothing is caught):

1. Build the kernels from ``src/repro_torch/kernels/csrc`` (nvcc, sm_90a).
2. Hold each kernel against its plain version on the same CUDA tensors,
   at the slice's shapes, on seeded inputs with exact ties, -1 padding,
   all-seen rows and rows with fewer candidates than k. Values agree
   within 1e-5; an index may differ only where the plain version scores
   the two items within that tolerance.
3. The serving path at the paper's primary configuration, full Table-1
   scale (`dmf_foursquare` on `foursquare_like(reduced=False, seed=0)`):
   ingest the train check-ins (kernel 3), recommend pruned (kernel 1) and
   dense (kernel 2), ingest the test check-ins, recommend again; 256
   served slates of each kind are held against the plain versions, and
   every kernel's launch count must have gone up.
4. Time each kernel, its plain version and one library call on the main
   path's own inputs; print the ``{"kernels": [...]}`` line.

The last line is ``{"ok": true, "device": {...}}``. Imports nothing of
JAX or of the JAX package.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 0
TOL = 1e-5
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12      # H100 SXM data sheet, fp32 outside the tensor cores
MICROBATCH, K_TOP = 64, 10
N_PRUNED, N_DENSE, N_CHECK = 4096, 1024, 256


def log(*parts) -> None:
    print(*parts, flush=True)


# --------------------------------------------------------------------- inputs
def window_inputs(rng, R, Cw, J, K, dev):
    """Seeded serve-window inputs with exact ties and padding."""
    U = rng.normal(0, 1, (R, K)).astype(np.float32)
    U[1] = 0.0
    Vw = rng.normal(0, 1, (R, Cw, K)).astype(np.float32)
    Vw[2, ::3] = 0.0
    Vw[3, 10:40] = Vw[3, 5]
    n_valid = rng.integers(Cw // 2, Cw + 1, R)
    n_valid[4], n_valid[5] = 3, 0
    cand = np.full((R, Cw), -1, np.int32)
    for r in range(R):
        cand[r, : n_valid[r]] = np.sort(rng.choice(J, n_valid[r], replace=False))
    seen = (rng.random((R, Cw)) < 0.05).astype(np.int8)
    seen[6], seen[4] = 1, 0
    return tuple(torch.as_tensor(x, device=dev) for x in (U, Vw, cand, seen))


def dense_inputs(rng, R, J, K, dev):
    U = rng.normal(0, 1, (R, K)).astype(np.float32)
    U[0] = 0.0
    V = rng.normal(0, 1, (R, J, K)).astype(np.float32)
    V[2, 50:] = 0.0
    V[3, 100:200] = V[3, 7]
    mask = (rng.random((R, J)) < 0.01).astype(np.int8)
    mask[4] = 1
    mask[5] = 1
    mask[5, [11, 2000, J - 1]] = 0
    return tuple(torch.as_tensor(x, device=dev) for x in (U, V, mask))


def step_inputs(rng, B, K, dev):
    u, p, q = (rng.normal(0, 0.5, (B, K)).astype(np.float32) for _ in range(3))
    p[:7] = 0.0
    r = (rng.random(B) < 0.25).astype(np.float32)
    conf = np.where(r > 0, 1.0, 1.0 / 3).astype(np.float32)
    return tuple(torch.as_tensor(x, device=dev) for x in (u, p, q, r, conf))


# ------------------------------------------------------------------ holding
def window_scores(U, Vw, cand, seen):
    """Plain masked scores of each window position, on the host."""
    from repro_torch.kernels import ref
    s = (U[:, None, :] * Vw).sum(-1).masked_fill((cand < 0) | (seen != 0), ref.NEG_INF)
    return s.cpu().numpy(), cand.cpu().numpy()


def hold_topk(name, got, plain, score_of) -> float:
    """Hold a kernel's top-k against the plain version's: values within
    TOL, dead slots identical, and an index may differ only where the plain
    scores of the two items are within TOL. Returns the max value error."""
    gv, gi = (np.asarray(x.cpu() if torch.is_tensor(x) else x) for x in got)
    pv, pi = (np.asarray(x.cpu() if torch.is_tensor(x) else x) for x in plain)
    assert gv.shape == pv.shape and gi.shape == pi.shape, (name, gv.shape, pv.shape)
    assert np.isfinite(gv).all(), f"{name}: non-finite values"
    np.testing.assert_array_equal(gi < 0, pi < 0, err_msg=f"{name}: dead slots differ")
    err = float(np.abs(gv - pv).max()) if gv.size else 0.0
    assert err <= TOL, f"{name}: max |value diff| {err} > {TOL}"
    for r, s in np.argwhere(gi != pi):
        chosen = score_of(r, int(gi[r, s]))
        assert abs(chosen - float(pv[r, s])) <= TOL, (
            f"{name}: row {r} slot {s} holds item {gi[r, s]} scoring {chosen}, "
            f"plain holds {pi[r, s]} at {pv[r, s]}")
    for row in gi:
        live = row[row >= 0]
        assert len(np.unique(live)) == len(live), f"{name}: repeated item in {row}"
    return err


def hold_window(name, got, U, Vw, cand, seen, k) -> float:
    from repro_torch.kernels import ref
    plain = ref.serve_topk_window_ref(U, Vw, cand, seen, k)
    scores, ids = window_scores(U, Vw, cand, seen)

    def score_of(r, item):
        pos = np.flatnonzero(ids[r] == item)
        assert len(pos) == 1, f"{name}: row {r} returned item {item} not in its window"
        return float(scores[r, pos[0]])
    return hold_topk(name, got, plain, score_of)


def hold_dense(name, got, U, V, mask, k) -> float:
    from repro_torch.kernels import ref
    plain = ref.topk_scores_peruser_ref(U, V, mask, k)
    scores = (U[:, None, :] * V).sum(-1).masked_fill(mask != 0, ref.NEG_INF).cpu().numpy()
    return hold_topk(name, got, plain, lambda r, item: float(scores[r, item]))


def hold_step(got, plain) -> float:
    err = max(float((a - b).abs().max()) for a, b in zip(got[:3], plain[:3]))
    assert err <= TOL, f"dmf_fused_step: max |delta diff| {err} > {TOL}"
    loss_rel = abs(float(got[3]) - float(plain[3])) / max(abs(float(plain[3])), 1e-30)
    assert loss_rel <= TOL, f"dmf_fused_step: loss rel diff {loss_rel} > {TOL}"
    return err


def check_kernels(dev, J: int) -> dict[str, float]:
    """Phase 2: each kernel against its plain version at the slice shapes."""
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(SEED)
    errs = {}
    U, Vw, cand, seen = window_inputs(rng, MICROBATCH, 384, J, 10, dev)
    errs["serve_topk_window"] = max(
        hold_window(f"serve_topk_window k={k}", ops.serve_topk_window(U, Vw, cand, seen, k),
                    U, Vw, cand, seen, k) for k in (1, K_TOP, 16))
    sync(dev)
    U, V, mask = dense_inputs(rng, MICROBATCH, J, 10, dev)
    errs["recommend_topk_peruser"] = max(
        hold_dense(f"recommend_topk_peruser k={k}", ops.recommend_topk_peruser(U, V, mask, k),
                   U, V, mask, k) for k in (1, K_TOP, 16))
    sync(dev)
    hp = dict(theta=0.1, alpha=0.1, beta=0.1, gamma=0.01)
    errs["dmf_fused_step"] = max(
        hold_step(ops.dmf_fused_step(*x, **hp), ref.dmf_fused_step_ref(*x, *hp.values()))
        for x in (step_inputs(rng, B, 10, dev) for B in (256, 100, 1)))
    sync(dev)
    return errs


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------- main path
def build_world(ds, dev):
    from repro_torch.configs import dmf_foursquare as fsq
    from repro_torch.core import graph
    from repro_torch.serving import index_from_dataset
    W = graph.build_adjacency(ds.user_coords, ds.user_city, fsq.GRAPH)
    nbr = graph.walk_neighbor_table(W, fsq.GRAPH, device=dev)
    return nbr, index_from_dataset(ds), fsq.dmf_config(ds.n_users, ds.n_items)


def drive_main_path(ds, nbr, index, cfg, dev) -> dict:
    """Phase 3 through the entry points a user calls. Returns what the
    checks and the report need."""
    from repro_torch.core import dmf, metrics
    from repro_torch.serving import OnlineConfig, ServingConfig, ServingEngine
    rng = np.random.default_rng(SEED)
    out = {}
    state = dmf.init_state(cfg, device=dev)
    eng = ServingEngine(state, index, ServingConfig(microbatch=MICROBATCH, k=K_TOP),
                        train=ds.train, nbr=nbr, dmf_cfg=cfg, device=dev)
    del state
    if dev.type == "cuda":
        out["resident_gb"] = torch.cuda.memory_allocated(dev) / 1e9
    t0 = time.perf_counter()
    warm = eng.ingest(ds.train, OnlineConfig())
    sync(dev)
    out["warm_ingest_s"] = time.perf_counter() - t0
    out["warm_batches"] = warm.n_batches
    assert np.isfinite(warm.losses).all(), "non-finite refresh loss"
    out["warm_loss_first_last"] = (warm.losses[0], warm.losses[-1])
    out["test_loss"] = dmf.test_loss(eng.state, ds.test)

    test_users = np.unique(ds.test[:, 0])
    _, rec, _ = eng.recommend(test_users, return_flags=True)
    test_mask = metrics.masks_from_interactions(ds.n_users, ds.n_items, ds.test)[test_users]
    out["P@10"], out["R@10"] = metrics.precision_recall_from_topk(rec, test_mask, K_TOP)

    def serve_round(tag, pruned_ids, dense_ids):
        eng.stats.reset()
        res = eng.recommend(pruned_ids, return_flags=True)
        out[f"{tag}_pruned"] = (pruned_ids, *res)
        out[f"{tag}_pruned_rps"] = eng.requests_per_sec
        out[f"{tag}_pruned_dispatch"] = eng.stats.dispatch_latency_percentiles()
        dense = ServingEngine(eng.state, index,
                              ServingConfig(microbatch=MICROBATCH, k=K_TOP, prune=False),
                              seen=eng.seen.cpu().numpy(), device=dev)
        res = dense.recommend(dense_ids, return_flags=True)
        out[f"{tag}_dense"] = (dense_ids, *res)
        out[f"{tag}_dense_rps"] = dense.requests_per_sec
        out[f"{tag}_dense_dispatch"] = dense.stats.dispatch_latency_percentiles()
        return dense

    pruned_ids = rng.integers(0, ds.n_users, N_PRUNED)
    dense_ids = rng.integers(0, ds.n_users, N_DENSE)
    serve_round("before", pruned_ids, dense_ids)
    report = eng.ingest(ds.test, OnlineConfig())
    assert np.isfinite(report.losses).all(), "non-finite refresh loss"
    out["test_ingest"] = (report.n_events, report.n_batches, len(report.touched_users))
    dense = serve_round("after", pruned_ids, dense_ids)
    out["engine"], out["dense_engine"], out["test_events"] = eng, dense, ds.test
    if dev.type == "cuda":
        out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


def check_slates(run, dev) -> dict[str, float]:
    """Hold N_CHECK served slates of each kind (fallback rows excluded)
    against the plain versions on the engine's own state."""
    errs = {}
    for kind, eng in (("pruned", run["engine"]), ("dense", run["dense_engine"])):
        ids, vals, idx, flags = run[f"after_{kind}"]
        assert vals.shape == (len(ids), K_TOP) and np.isfinite(vals).all()
        assert ((idx >= -1) & (idx < eng.index.n_items)).all()
        keep = np.flatnonzero(~flags)[:N_CHECK]
        assert len(keep) == N_CHECK, f"only {len(keep)} unflagged {kind} rows"
        uids = torch.as_tensor(ids[keep], device=dev)
        got = (vals[keep], idx[keep])
        st = eng.state
        if kind == "pruned":
            cand = eng._bucket_items[eng._user_bucket[uids]]
            safe = cand.clamp_min(0).long()
            rows = uids[:, None]
            errs[kind] = hold_window("served pruned slates", got, st.U[uids], eng.V[rows, safe],
                                     cand, eng.seen[rows, safe], K_TOP)
        else:
            errs[kind] = hold_dense("served dense slates", got, st.U[uids], eng.V[uids],
                                    eng.seen[uids], K_TOP)
    return errs


def serving_summary(run) -> dict:
    """The end-to-end numbers of phase 3, unrounded."""
    out = {f"{tag}_ingest_{kind}": {
        "requests_per_s": run[f"{tag}_{kind}_rps"],
        "dispatch_p50_ms": run[f"{tag}_{kind}_dispatch"]["p50_ms"],
        "dispatch_p99_ms": run[f"{tag}_{kind}_dispatch"]["p99_ms"],
        "requests": len(run[f"{tag}_{kind}"][0]),
        "fallbacks": int(run[f"{tag}_{kind}"][3].sum())}
        for tag in ("before", "after") for kind in ("pruned", "dense")}
    out.update({key: run[key] for key in (
        "warm_ingest_s", "warm_batches", "warm_loss_first_last", "test_ingest",
        "resident_gb", "peak_gb", "test_loss", "P@10", "R@10")})
    return out


# ------------------------------------------------------------------- timing
def device_ms(fn, n: int) -> float:
    """Device milliseconds per call, back to back: the stream is held by a
    sleep kernel while the host queues all n calls, so host launch gaps do
    not count."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4e9 * host_s) + 2_000_000)   # ≥ 2x the enqueue time at ≤2 GHz
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def call_ms(fn, n: int) -> float:
    """Milliseconds per call as a caller sees it, launch overhead included."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def time_kernels(run, launches, errs) -> list[dict]:
    """Phase 4 on one microbatch of the main path's own inputs."""
    from repro_torch.core import dmf
    from repro_torch.kernels import ops, ref
    eng = run["engine"]
    st, dev = eng.state, eng.device
    uids = torch.as_tensor(run["after_pruned"][0][:MICROBATCH], device=dev)
    rows = uids[:, None]
    cand = eng._bucket_items[eng._user_bucket[uids]]
    safe = cand.clamp_min(0).long()
    u, vw, seen_w = st.U[uids], eng.V[rows, safe], eng.seen[rows, safe]
    v_rows, mask = eng.V[uids], eng.seen[uids]
    # one refresh batch of the main path: test check-ins + their negatives
    ui, vj, r, conf = dmf.sample_with_negatives(
        run["test_events"], eng.index.n_items, 3, np.random.default_rng(SEED + 1))
    ui, vj = (torch.as_tensor(x[:256], device=dev) for x in (ui, vj))
    sx = (st.U[ui], st.P[ui, vj], st.Q[ui, vj],
          torch.as_tensor(r[:256], device=dev), torch.as_tensor(conf[:256], device=dev))
    cfg = eng.dmf_cfg
    hp = dict(theta=cfg.lr, alpha=cfg.alpha, beta=cfg.beta, gamma=cfg.gamma)
    K = u.shape[1]

    def einsum_topk_window():
        s = torch.einsum("rk,rck->rc", u, vw).masked_fill((cand < 0) | (seen_w != 0), ref.NEG_INF)
        return torch.topk(s, K_TOP, dim=1)

    def einsum_topk_dense():
        s = torch.einsum("rk,rjk->rj", u, v_rows).masked_fill(mask != 0, ref.NEG_INF)
        return torch.topk(s, K_TOP, dim=1)

    live_w = int(((cand >= 0) & (seen_w == 0)).sum())
    live_d = int((mask == 0).sum())
    out_b = MICROBATCH * K_TOP * 8
    specs = [
        ("serve_topk_window", "serve_topk.cu", "src/repro/kernels/serve_topk.py:122",
         lambda: ops.serve_topk_window(u, vw, cand, seen_w, K_TOP),
         lambda: ref.serve_topk_window_ref(u, vw, cand, seen_w, K_TOP), einsum_topk_window,
         u.nbytes + cand.nbytes + seen_w.nbytes + live_w * K * 4 + out_b, 2 * live_w * K),
        ("recommend_topk_peruser", "topk_scores.cu", "src/repro/kernels/topk_scores.py:68",
         lambda: ops.recommend_topk_peruser(u, v_rows, mask, K_TOP),
         lambda: ref.topk_scores_peruser_ref(u, v_rows, mask, K_TOP), einsum_topk_dense,
         u.nbytes + mask.nbytes + live_d * K * 4 + out_b, 2 * live_d * K),
        ("dmf_fused_step", "dmf_update.cu", "src/repro/kernels/dmf_update.py:61",
         lambda: ops.dmf_fused_step(*sx, **hp),
         lambda: ref.dmf_fused_step_ref(*sx, *hp.values()), None,
         sum(x.nbytes for x in sx) + 3 * sx[0].nbytes + 4, 256 * (12 * K + 5)),
    ]
    rows_out = []
    for name, src, replaces, kern, plain, lib, nbytes, flops in specs:
        if name == "serve_topk_window":
            errs[name] = max(errs[name], hold_window(name, kern(), u, vw, cand, seen_w, K_TOP))
        elif name == "recommend_topk_peruser":
            errs[name] = max(errs[name], hold_dense(name, kern(), u, v_rows, mask, K_TOP))
        else:
            errs[name] = max(errs[name], hold_step(kern(), plain()))
        bound_ms, bound_by = bound(nbytes, flops)
        rows_out.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}", "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": (ms := device_ms(kern, 200)), "kernel_ms": ms, "call_ms": call_ms(kern, 200),
            "plain_ms": device_ms(plain, 30),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": device_ms(lib, 30) if lib is not None else None,
            "bytes": int(nbytes), "flops": int(flops),
        })
    return rows_out


# --------------------------------------------------------------------- main
def gpu_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import device as device_lib
    from repro_torch.data import synthetic_poi
    from repro_torch.kernels import build, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = device_lib.resolve("cuda")
    t_start = time.perf_counter()
    log("torch", torch.__version__, "cuda", torch.version.cuda, "python", sys.version.split()[0])
    log(gpu_line())

    t0 = time.perf_counter()
    build.load()
    log(f"phase 1 build: {time.perf_counter() - t0} s (source hash {build.source_hash()})")
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log("  ptxas", line.strip())

    t0 = time.perf_counter()
    J = 3197
    errs = check_kernels(dev, J)
    log(f"phase 2 kernels vs plain: {json.dumps(errs)} ({time.perf_counter() - t0} s)")

    t0 = time.perf_counter()
    ds = synthetic_poi.foursquare_like(reduced=False, seed=SEED)
    nbr, index, cfg = build_world(ds, dev)
    log(f"phase 3 data: users={ds.n_users} items={ds.n_items} train={len(ds.train)} "
        f"test={len(ds.test)} buckets={index.n_buckets} cap={index.cap} S={nbr.idx.shape[1]} "
        f"({time.perf_counter() - t0} s host)")
    assert ds.n_items == J

    for kern in ops.KERNELS:
        kern.launches = 0
    t0 = time.perf_counter()
    run = drive_main_path(ds, nbr, index, cfg, dev)
    launches = {kern.__name__: kern.launches for kern in ops.KERNELS}
    log(f"phase 3 main path: {time.perf_counter() - t0} s, launches {json.dumps(launches)}")
    for name, n in launches.items():
        assert n > 0, f"kernel {name} was not launched on the main path"
    slate_errs = check_slates(run, dev)
    log(f"phase 3 served slates vs plain: {json.dumps(slate_errs)}")
    log("serving", json.dumps(serving_summary(run)))
    t0 = time.perf_counter()
    errs["serve_topk_window"] = max(errs["serve_topk_window"], slate_errs["pruned"])
    errs["recommend_topk_peruser"] = max(errs["recommend_topk_peruser"], slate_errs["dense"])
    rows = time_kernels(run, launches, errs)
    log(f"phase 4 timing: {time.perf_counter() - t0} s; total {time.perf_counter() - t_start} s")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
