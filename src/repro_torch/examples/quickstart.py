"""Quickstart: decentralized POI recommendation with DMF — port of
`examples/quickstart.py`.

Builds a synthetic city-world, the geographic user graph (Eq. 2), the
random-walk propagation matrix (Eqs. 3-4), trains DMF (Alg. 1) and prints
P@k/R@k against centralized MF.

    PYTHONPATH=src python -m repro_torch.examples.quickstart               # on the card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
import argparse

from repro_torch import device as device_lib
from repro_torch.core import baselines, dmf, graph
from repro_torch.data import synthetic_poi


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = device_lib.resolve(args.device)

    # 1. data — users/POIs clustered into cities, geographic coordinates
    ds = synthetic_poi.foursquare_like(reduced=True)
    print(f"users={ds.n_users} POIs={ds.n_items} "
          f"train={len(ds.train)} test={len(ds.test)}")

    # 2. the user adjacency graph from geography (same city, N nearest),
    #    exported as the compact D-hop neighbor table each learner ships to
    gcfg = graph.GraphConfig(n_neighbors=2, walk_length=3)
    W = graph.build_adjacency(ds.user_coords, ds.user_city, gcfg)
    nbr = graph.walk_neighbor_table(W, gcfg, device=dev)   # includes line-11 self term
    print(f"max gradient fan-out 1+|N^D(i)| = {nbr.idx.shape[1]}")

    # 3. decentralized training (Alg. 1, sparse minibatch steps)
    cfg = dmf.DMFConfig(
        n_users=ds.n_users, n_items=ds.n_items, dim=10,
        alpha=0.1, beta=0.1, gamma=0.01, lr=0.1, neg_samples=3,
    )
    res = dmf.fit(cfg, ds.train, nbr, epochs=60, test=ds.test, device=dev)
    print(f"train loss {res.train_losses[0]:.4f} -> {res.train_losses[-1]:.4f}")

    # 4. evaluate — and compare with centralized MF
    ev = dmf.evaluate(res.state, ds.train, ds.test, ds.n_users, ds.n_items, device=dev)
    print("DMF:", {k: round(v, 4) for k, v in ev.items()})
    mfc = baselines.MFConfig(n_users=ds.n_users, n_items=ds.n_items, dim=10)
    st, _ = baselines.fit_mf(mfc, ds.train, epochs=60, device=dev)
    ev_mf = baselines.evaluate_mf(st, ds.train, ds.test, ds.n_users, ds.n_items, device=dev)
    print("MF :", {k: round(v, 4) for k, v in ev_mf.items()})
    assert ev["R@10"] > ev_mf["R@10"], "DMF should beat centralized MF"
    print("OK — decentralized beats centralized on locality-structured data")
    return {"DMF": ev, "MF": ev_mf}


if __name__ == "__main__":
    main()
