"""Serving example: the decentralized POI serving engine end to end —
port of `examples/poi_serving.py`.

Train DMF (Alg. 1), build the city-bucketed candidate index (paper Fig. 2:
check-ins concentrate in the home city), then drive a request stream
through the batched `ServingEngine`: each request scores only its
home-city bucket with the learner's own factors (u_i, p^i + q^i), one
launch of the serve kernel a microbatch. Finally stream a few held-out
check-ins through the online refresh and watch the served factors track
them without retraining.

    PYTHONPATH=src python -m repro_torch.examples.poi_serving --requests 256 --k 10
    PYTHONPATH=src python -m repro_torch.examples.poi_serving --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import dmf, graph, metrics
from repro_torch.data import synthetic_poi
from repro_torch.kernels import ref
from repro_torch.serving import OnlineConfig, ServingConfig, ServingEngine, index_from_dataset

# the engine's kernel sums each score's K products in another order than
# the plain version does on the card; on the CPU both are the plain version
CARD_TOL = 1e-5


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--microbatch", type=int, default=64)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = device_lib.resolve(args.device)

    ds = synthetic_poi.foursquare_like(reduced=True)
    gcfg = graph.GraphConfig(n_neighbors=2, walk_length=3)
    W = graph.build_adjacency(ds.user_coords, ds.user_city, gcfg)
    nbr = graph.walk_neighbor_table(W, gcfg, device=dev)
    cfg = dmf.DMFConfig(n_users=ds.n_users, n_items=ds.n_items, dim=10,
                        beta=0.1, gamma=0.01)
    print("training DMF ...")
    res = dmf.fit(cfg, ds.train, nbr, epochs=args.epochs, device=dev)

    index = index_from_dataset(ds)
    print(f"candidate index: {index.n_buckets} city buckets, cap={index.cap} "
          f"(J={ds.n_items}), {index.n_truncated_buckets} truncated")

    engine = ServingEngine(
        res.state, index,
        ServingConfig(microbatch=args.microbatch, k=args.k),
        train=ds.train, nbr=nbr, dmf_cfg=cfg, device=dev,
    )
    rng = np.random.default_rng(0)
    users = rng.integers(0, ds.n_users, args.requests)
    engine.recommend(users[: args.microbatch])        # warm: the first launches
    engine.stats.reset()

    vals, recs, flags = engine.recommend(users, return_flags=True)
    lat = engine.stats.latency_percentiles()
    print(f"{args.requests} requests in {engine.stats.n_dispatches} "
          f"microbatch dispatches: {engine.requests_per_sec:.0f} req/s, "
          f"p50={lat['p50_ms']:.1f} ms/batch")

    test_mask = metrics.masks_from_interactions(ds.n_users, ds.n_items, ds.test)
    filled = recs >= 0
    hits = (np.take_along_axis(test_mask[users], np.maximum(recs, 0), 1)
            & filled).sum()
    print(f"P@{args.k} over requests: {hits / recs.size:.4f}")
    print("sample recommendation for user", int(users[0]), ":", recs[0][:5])

    # engine == dense-oracle spot check (the serve kernel vs the plain
    # dense top-k of `kernels/ref.py`). Cold users (no train check-ins) get
    # the flagged popularity slate instead of factor scores — compare the
    # factor path on the rest.
    sub = torch.as_tensor(users[:16], device=dev)
    st = res.state
    v_ref, i_ref = ref.serve_topk_ref(
        st.U[sub], st.P[sub] + st.Q[sub],
        torch.as_tensor(index.bucket_items[index.user_bucket[users[:16]]], device=dev),
        engine.seen[sub], args.k)
    v_ref, i_ref = v_ref.cpu().numpy(), i_ref.cpu().numpy()
    warm = ~flags[:16]
    assert warm.any(), "all spot-check users were cold"
    assert (recs[:16][warm] == i_ref[warm]).all(), "engine != dense oracle"
    tol = 0.0 if dev.type == "cpu" else CARD_TOL
    assert np.abs(vals[:16][warm] - v_ref[warm]).max() <= tol, "engine values != oracle"
    print(f"engine == dense oracle on {int(warm.sum())}/16 factor-scored "
          f"requests (indices and values): OK; "
          f"{int(flags.sum())}/{args.requests} requests served the flagged "
          f"popularity fallback")

    # online refresh: stream held-out check-ins, served loss tracks them
    events = ds.test[: min(64, len(ds.test))]
    before = dmf.test_loss(engine.state, events)
    report = engine.ingest(events, OnlineConfig(steps=3))
    after = dmf.test_loss(engine.state, events)
    print(f"online refresh: {report.n_events} check-ins, "
          f"{len(report.affected_users)} users affected, "
          f"{len(report.touched_users)} factor rows touched; "
          f"loss on streamed events {before:.4f} -> {after:.4f}")
    assert after < before, "online refresh failed to track streamed events"
    return {"P@k": hits / recs.size, "spot_checked": int(warm.sum()),
            "fallbacks": int(flags.sum()), "loss_before": before, "loss_after": after}


if __name__ == "__main__":
    main()
