"""CLI launcher for the paper's DMF training (Alg. 1) — port of
`src/repro/launch/dmf_train.py` with the flags of the training slice
(dataset, scale, model and graph hyperparameters, the dense oracle, the DP
mechanism, the divergence sentinel, logging, seed) plus ``--device``.

    PYTHONPATH=src python -m repro_torch.launch.dmf_train --epochs 20
    PYTHONPATH=src python -m repro_torch.launch.dmf_train --full --dp-sigma 1.0 --dp-clip 0.5
    PYTHONPATH=src python -m repro_torch.launch.dmf_train --dp-epsilon 2.0 --epochs 40
    PYTHONPATH=src python -m repro_torch.launch.dmf_train --device cpu --epochs 5

Runs on the card unless ``--device cpu`` is given. Prints the dataset and
propagation line, ``epoch N train_loss`` every 10 epochs, a
``privacy {...}`` line when DP noise is on, and the final P@k/R@k JSON.
Churn, Byzantine, checkpoint, telemetry, tracing and sharding flags come
with later slices; argparse rejects them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging

import numpy as np

from repro_torch import device as device_lib
from repro_torch.core import dmf, graph
from repro_torch.data import synthetic_poi
from repro_torch.privacy import sigma_for_epsilon


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dmf_train")
    ap.add_argument("--dataset", default="foursquare", choices=["foursquare", "alipay"])
    ap.add_argument("--full", action="store_true", help="Table-1-scale data")
    ap.add_argument("--dim", type=int, default=10)
    ap.add_argument("--epochs", type=int, default=80)
    ap.add_argument("--mode", default="dmf", choices=["dmf", "gdmf", "ldmf"])
    ap.add_argument("--alpha", type=float, default=0.1)
    ap.add_argument("--beta", type=float, default=0.1)
    ap.add_argument("--gamma", type=float, default=0.01)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--neg-samples", type=int, default=3)
    ap.add_argument("--n-neighbors", type=int, default=2)
    ap.add_argument("--walk-length", type=int, default=3)
    ap.add_argument("--paper-literal", action="store_true",
                    help="keep Alg.1's literal |N^d(i)| neighbor weighting")
    ap.add_argument("--dense-reference", action="store_true",
                    help="dense per-batch oracle path (equivalence oracle)")
    ap.add_argument("--dp-clip", type=float, default=float("inf"),
                    help="C: L2 clip per outgoing gradient message "
                         "(inf = off; --dp-sigma/--dp-epsilon need it finite)")
    ap.add_argument("--dp-sigma", type=float, default=0.0,
                    help="σ: Gaussian noise multiplier relative to the clip (0 = off)")
    ap.add_argument("--dp-epsilon", type=float, default=0.0,
                    help="target ε(δ): solve for the σ meeting it over this run's "
                         "epochs/batching (overrides --dp-sigma; defaults "
                         "--dp-clip to 1.0 if unset)")
    ap.add_argument("--dp-delta", type=float, default=1e-5)
    ap.add_argument("--dp-seed", type=int, default=0,
                    help="DP mechanism base seed (per-epoch noise streams are folded from it)")
    ap.add_argument("--on-nonfinite", default="warn", choices=["warn", "raise", "halt"],
                    help="divergence sentinel: warn and continue, raise "
                         "DivergenceError, or halt returning the last finite state")
    ap.add_argument("--log-every", type=int, default=0,
                    help="log train/test loss (and ε so far) every N epochs via "
                         "the `repro_torch.dmf` logger (0 = off)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=device_lib.DEFAULT_DEVICE,
                    help="cuda (default; raises without a card) or cpu")
    return ap


def _solve_sigma(args, ds) -> tuple[float, float]:
    """ε-target mode: the noise multiplier meeting ε(δ) over this run's
    batching, at the busiest learner's rate and its expected rows per
    participating batch (the accountant's semantics). Returns (clip, σ)."""
    dp_clip = args.dp_clip if np.isfinite(args.dp_clip) else 1.0
    m1 = 1 + args.neg_samples
    B = next(f.default for f in dataclasses.fields(dmf.DMFConfig) if f.name == "batch_size")
    nb = max(len(ds.train) * m1 // B, 1)
    rows = np.bincount(ds.train[:, 0], minlength=ds.n_users) * m1
    q_max = float(1.0 - (1.0 - 1.0 / nb) ** rows.max())
    kbar = max(1.0, float(rows.max()) / max(nb * q_max, 1e-9))
    dp_sigma = sigma_for_epsilon(args.dp_epsilon, q=q_max, steps=args.epochs * nb,
                                 delta=args.dp_delta, rows_per_step=kbar)
    print(f"dp target eps={args.dp_epsilon} delta={args.dp_delta}: "
          f"solved sigma={dp_sigma:.4f} (clip={dp_clip}, q_max={q_max:.4f}, "
          f"steps={args.epochs * nb}, rows_per_step={kbar:.2f})")
    return dp_clip, dp_sigma


def main(argv: list[str] | None = None) -> dict[str, float]:
    """Parse ``argv`` (default: the command line), train, evaluate, print
    the report and return the P@k/R@k dict."""
    args = _parser().parse_args(argv)
    dev = device_lib.resolve(args.device)
    if args.log_every > 0:
        logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    maker = (synthetic_poi.foursquare_like if args.dataset == "foursquare"
             else synthetic_poi.alipay_like)
    ds = maker(reduced=not args.full, seed=args.seed)
    gcfg = graph.GraphConfig(n_neighbors=args.n_neighbors, walk_length=args.walk_length,
                             paper_literal=args.paper_literal)
    W = graph.build_adjacency(ds.user_coords, ds.user_city, gcfg)
    if args.dense_reference:
        prop = graph.walk_propagation_matrix(W, gcfg)
    else:
        prop = graph.walk_neighbor_table(W, gcfg, device=dev)

    dp_clip, dp_sigma = args.dp_clip, args.dp_sigma
    if args.dp_epsilon > 0:
        dp_clip, dp_sigma = _solve_sigma(args, ds)
    cfg = dmf.DMFConfig(
        n_users=ds.n_users, n_items=ds.n_items, dim=args.dim, mode=args.mode,
        alpha=args.alpha, beta=args.beta, gamma=args.gamma, lr=args.lr,
        neg_samples=args.neg_samples, seed=args.seed,
        dp_clip=dp_clip, dp_sigma=dp_sigma, dp_seed=args.dp_seed,
    )
    comm = graph.communication_bytes(W, D=args.walk_length, K=args.dim,
                                     n_ratings=len(ds.train))
    fanout = "dense" if args.dense_reference else f"S={int(prop.idx.shape[1])}"
    print(f"dataset={args.dataset} users={ds.n_users} items={ds.n_items} "
          f"train={len(ds.train)} comm/epoch={comm/1e6:.2f} MB "
          f"propagation={fanout} shards=1")

    def cb(t, state, loss):
        if t % 10 == 0:
            print(f"epoch {t:4d} train_loss {loss:.5f}")

    res = dmf.fit(cfg, ds.train, prop, epochs=args.epochs, test=ds.test, callback=cb,
                  dense_reference=args.dense_reference, dp_delta=args.dp_delta,
                  on_nonfinite=args.on_nonfinite, log_every=args.log_every, device=dev)
    if res.diverged_at is not None:
        print(f"training halted: diverged at epoch {res.diverged_at}")
    ev = dmf.evaluate(res.state, ds.train, ds.test, ds.n_users, ds.n_items, device=dev)
    if res.privacy is not None:
        pv = dict(res.privacy)
        pv.pop("eps_trajectory", None)
        print("privacy " + json.dumps(pv))
    print(json.dumps({k: round(v, 4) for k, v in ev.items()}))
    return ev


if __name__ == "__main__":
    main()
