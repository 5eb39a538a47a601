"""CLI launcher for the paper's DMF training (Alg. 1) — port of
`src/repro/launch/dmf_train.py` with its flags for the dataset, scale,
model and graph hyperparameters, the dense oracle, the DP mechanism,
churn (`--churn-*`), Byzantine attacks and defenses (`--byz-*`,
`--screen`, `--norm-cap`, `--aggregation`, `--trim-frac`), checkpoints
(`--checkpoint-dir`, `--checkpoint-every`, `--resume-from`), the
divergence sentinel, telemetry, tracing and metrics (`--telemetry`,
`--telemetry-out`, `--trace-out`, `--metrics-out`), logging, the seed and
learner sharding (`--n-shards`), plus ``--device`` and ``--dist-backend``.

    PYTHONPATH=src python -m repro_torch.launch.dmf_train --epochs 20
    PYTHONPATH=src python -m repro_torch.launch.dmf_train --full --dp-sigma 1.0 --dp-clip 0.5
    PYTHONPATH=src python -m repro_torch.launch.dmf_train --dp-epsilon 2.0 --epochs 40
    PYTHONPATH=src python -m repro_torch.launch.dmf_train --full --epochs 12 \
        --churn-dropout 0.2 --churn-delay 2 --dp-sigma 0.5 --dp-clip 0.25 \
        --screen --aggregation trim --checkpoint-dir ck --checkpoint-every 4
    PYTHONPATH=src python -m repro_torch.launch.dmf_train --device cpu --epochs 5 \
        --telemetry-out tele.jsonl --trace-out trace.json --metrics-out metrics.jsonl
    PYTHONPATH=src python -m repro_torch.launch.dmf_train --full --n-shards 2 --dist-backend gloo
    torchrun --nproc-per-node 4 -m repro_torch.launch.dmf_train --full --n-shards 4

``--n-shards N`` (N > 1) trains and evaluates learner-sharded over N ranks
of a `torch.distributed` group: under torchrun (``WORLD_SIZE`` set) this
process joins that group, otherwise it spawns N local ranks itself
(`launch.mesh.spawn_ranks`, after building the kernels), as the reference
CLI provisions its devices. ``--dist-backend`` is nccl (one card per rank)
or gloo (CPU ranks, or several ranks on one card); the default is nccl on
cuda and gloo on the CPU, and it is never switched. Rank 0 alone prints.

Runs on the card unless ``--device cpu`` is given. Prints the reference's
lines: ``churn ...`` and ``byzantine ...`` when those are on, the
calibrated τ for ``--screen --norm-cap 0``, the dataset and propagation
line, ``epoch N train_loss`` every 10 epochs, ``training halted`` on a
halted divergence, a ``privacy {...}`` line when DP noise is on, a
``telemetry {...}`` line with the last epoch's event, ``trace written to
...`` and ``metrics snapshot appended to ...`` when those are asked for,
and the final P@k/R@k JSON. ``--use-pallas`` is not ported; argparse
rejects it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import dmf, graph
from repro_torch.data import synthetic_poi
from repro_torch.launch import mesh
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as trace_lib
from repro_torch.privacy import screening_threshold, sigma_for_epsilon
from repro_torch.robustness import AttackConfig, ChurnConfig, DefenseConfig


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
    ap.add_argument("--churn-dropout", type=float, default=0.0,
                    help="per-epoch i.i.d. learner offline probability (offline "
                         "learners are bit-frozen, their messages lost)")
    ap.add_argument("--churn-session-alpha", type=float, default=0.0,
                    help="Pareto tail index of power-law online sessions (0 = none)")
    ap.add_argument("--churn-delay", type=int, default=0,
                    help="max staleness k: learners draw a delay class in 0..k and "
                         "their gradient messages land that many epochs late")
    ap.add_argument("--churn-late-frac", type=float, default=0.0,
                    help="fraction of learners that join mid-run (stateless before)")
    ap.add_argument("--churn-seed", type=int, default=0,
                    help="churn schedule seed (independent of the training rng)")
    ap.add_argument("--byz-family", default="none",
                    help="inject Byzantine senders: none|nan|inf|norm_inflate|sign_flip|shill")
    ap.add_argument("--byz-frac", type=float, default=0.0,
                    help="fraction of learners compromised (seeded draw)")
    ap.add_argument("--byz-scale", type=float, default=10.0,
                    help="attack magnitude: norm-inflation factor λ, or the shill "
                         "direction's norm")
    ap.add_argument("--byz-target-item", type=int, default=0,
                    help="POI the shill family pushes every message toward")
    ap.add_argument("--byz-no-collude", action="store_true",
                    help="independent per-attacker shill directions instead of one "
                         "shared (colluding) direction")
    ap.add_argument("--byz-start-epoch", type=int, default=0,
                    help="sleeper agents: attack only from this epoch on")
    ap.add_argument("--byz-seed", type=int, default=0,
                    help="attack plan seed (independent of the training rng)")
    ap.add_argument("--screen", action="store_true",
                    help="receiver-side screening: drop non-finite incoming messages, "
                         "and over-norm ones if a cap is set (--norm-cap)")
    ap.add_argument("--norm-cap", type=float, default=float("inf"),
                    help="screening L2 cap τ; 0 = calibrate from the DP mechanism so "
                         "honest noised messages pass (needs a finite --dp-clip)")
    ap.add_argument("--aggregation", default="sum", choices=["sum", "trim", "median"],
                    help="per-(receiver, item) combine of incoming messages: plain sum, "
                         "or count-scaled coordinate-wise trimmed mean / median")
    ap.add_argument("--trim-frac", type=float, default=0.2,
                    help="fraction trimmed from EACH tail (aggregation=trim)")
    ap.add_argument("--on-nonfinite", default="warn", choices=["warn", "raise", "halt"],
                    help="divergence sentinel: warn and continue, raise "
                         "DivergenceError, or halt returning the last finite state")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="snapshot the full loop state (factors, rng, delay ring, "
                         "eps ledger) under this directory")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="snapshot every N completed epochs (0 = off)")
    ap.add_argument("--resume-from", default=None,
                    help="a step_<t> dir or checkpoint root: restore and continue, "
                         "bit-identical to the uninterrupted run")
    ap.add_argument("--telemetry", action="store_true",
                    help="per-epoch training telemetry (obs/telemetry.py): loss, update and "
                         "message norms, DP ε, online counts, ring occupancy, screening "
                         "counts; factor trajectories stay bit for bit those of a run "
                         "without it")
    ap.add_argument("--telemetry-out", default=None,
                    help="stream each epoch's telemetry event as one JSON line to this file "
                         "(implies --telemetry)")
    ap.add_argument("--trace-out", default=None,
                    help="enable span tracing and write a Chrome-trace/Perfetto JSON here "
                         "when the run finishes")
    ap.add_argument("--metrics-out", default=None,
                    help="append a final metrics-registry snapshot (JSONL) here when the "
                         "run finishes")
    ap.add_argument("--log-every", type=int, default=0,
                    help="log train/test loss (and ε so far) every N epochs via "
                         "the `repro_torch.dmf` logger (0 = off)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-shards", type=int, default=1,
                    help="learner-group width: >1 trains and evaluates over that many ranks, "
                         "each holding its rows of U/P/Q (spawned here unless under torchrun)")
    ap.add_argument("--dist-backend", default=None, choices=list(mesh.BACKENDS),
                    help="process-group backend for --n-shards > 1: nccl (one card a rank) or "
                         "gloo (CPU ranks, or several ranks on one card); default nccl on "
                         "cuda, gloo on cpu")
    ap.add_argument("--device", default=device_lib.DEFAULT_DEVICE,
                    help="cuda (default; raises without a card) or cpu")
    return ap


SPAWN_TIMEOUT_S = 7 * 24 * 3600.0   # the spawned ranks' join limit: a run's own length


def _solve_sigma(args, ds, say=print) -> tuple[float, float]:
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
    say(f"dp target eps={args.dp_epsilon} delta={args.dp_delta}: "
        f"solved sigma={dp_sigma:.4f} (clip={dp_clip}, q_max={q_max:.4f}, "
        f"steps={args.epochs * nb}, rows_per_step={kbar:.2f})")
    return dp_clip, dp_sigma


def main(argv: list[str] | None = None) -> dict[str, float]:
    """Parse ``argv`` (default: the command line), train, evaluate, print
    the report and return the P@k/R@k dict (rank 0's, when sharded)."""
    ap = _parser()
    args = ap.parse_args(argv)
    if args.n_shards < 1:
        ap.error(f"--n-shards {args.n_shards} must be >= 1")
    dev = device_lib.resolve(args.device)
    if args.n_shards == 1:
        return _run(args, dev)
    backend = args.dist_backend or ("nccl" if dev.type == "cuda" else "gloo")
    if "WORLD_SIZE" in os.environ:             # torchrun started this rank
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        torch.distributed.init_process_group(backend)
        try:
            return _run(args, device_lib.resolve(dev.type), torch.distributed.get_rank())
        finally:
            torch.distributed.destroy_process_group()
    mesh.check_backend(backend, args.n_shards, dev.type)
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.load()                           # once, before any rank starts
    return mesh.spawn_ranks(_spawned_rank, args.n_shards, backend=backend, device=dev.type,
                            timeout_s=SPAWN_TIMEOUT_S,
                            args=(sys.argv[1:] if argv is None else list(argv),))


def _spawned_rank(rank: int, argv) -> dict[str, float]:
    args = _parser().parse_args(argv)
    return _run(args, device_lib.resolve(torch.device(args.device).type), rank)


def _run(args, dev: torch.device, rank: int = 0) -> dict[str, float]:
    """Train, evaluate and report on this process (one rank of
    ``args.n_shards``; rank 0 prints and writes the trace and metrics)."""
    def say(*parts):
        if rank == 0:
            print(*parts)

    if args.log_every > 0:
        logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    if args.trace_out:
        trace_lib.configure_tracing(True)
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
        dp_clip, dp_sigma = _solve_sigma(args, ds, say)
    cfg = dmf.DMFConfig(
        n_users=ds.n_users, n_items=ds.n_items, dim=args.dim, mode=args.mode,
        alpha=args.alpha, beta=args.beta, gamma=args.gamma, lr=args.lr,
        neg_samples=args.neg_samples, seed=args.seed, n_shards=args.n_shards,
        dp_clip=dp_clip, dp_sigma=dp_sigma, dp_seed=args.dp_seed,
    )
    churn = None
    if (args.churn_dropout > 0 or args.churn_session_alpha > 0 or args.churn_delay > 0
            or args.churn_late_frac > 0):
        churn = ChurnConfig(dropout=args.churn_dropout, session_alpha=args.churn_session_alpha,
                            delay_classes=tuple(range(args.churn_delay + 1)),
                            late_frac=args.churn_late_frac, seed=args.churn_seed)
        plan = churn.compile(ds.n_users, args.epochs)
        say(f"churn dropout={args.churn_dropout} delay<= {args.churn_delay} "
            f"late_frac={args.churn_late_frac} participation={plan.participation_rate:.3f}")
    attack = defense = None
    if args.byz_family != "none" and args.byz_frac > 0:
        attack = AttackConfig(family=args.byz_family, frac=args.byz_frac, scale=args.byz_scale,
                              target_item=args.byz_target_item,
                              collude=not args.byz_no_collude,
                              start_epoch=args.byz_start_epoch, seed=args.byz_seed)
        say(f"byzantine family={args.byz_family} frac={args.byz_frac} "
            f"scale={args.byz_scale} seed={args.byz_seed}")
    if args.screen or args.aggregation != "sum":
        norm_cap = args.norm_cap
        if args.screen and norm_cap == 0.0:
            norm_cap = screening_threshold(cfg, cfg.dim)
            say(f"screening norm cap auto-calibrated: tau={norm_cap:.4f}")
        defense = DefenseConfig(screen=args.screen, norm_cap=norm_cap,
                                aggregation=args.aggregation, trim_frac=args.trim_frac)

    comm = graph.communication_bytes(W, D=args.walk_length, K=args.dim,
                                     n_ratings=len(ds.train))
    fanout = "dense" if args.dense_reference else f"S={int(prop.idx.shape[1])}"
    say(f"dataset={args.dataset} users={ds.n_users} items={ds.n_items} "
        f"train={len(ds.train)} comm/epoch={comm/1e6:.2f} MB "
        f"propagation={fanout} shards={args.n_shards}")

    def cb(t, state, loss):
        if t % 10 == 0:
            say(f"epoch {t:4d} train_loss {loss:.5f}")

    res = dmf.fit(cfg, ds.train, prop, epochs=args.epochs, test=ds.test, callback=cb,
                  dense_reference=args.dense_reference, dp_delta=args.dp_delta,
                  churn=churn, checkpoint_dir=args.checkpoint_dir,
                  checkpoint_every=args.checkpoint_every, resume_from=args.resume_from,
                  attack=attack, defense=defense, on_nonfinite=args.on_nonfinite,
                  telemetry=args.telemetry, telemetry_out=args.telemetry_out,
                  log_every=args.log_every, device=dev)
    if res.diverged_at is not None:
        say(f"training halted: diverged at epoch {res.diverged_at}")
    ev = dmf.evaluate(res.state, ds.train, ds.test, ds.n_users, ds.n_items,
                      n_shards=args.n_shards, device=dev)
    if res.privacy is not None:
        pv = dict(res.privacy)
        pv.pop("eps_trajectory", None)
        say("privacy " + json.dumps(pv))
    if res.telemetry:
        last = res.telemetry[-1]
        say("telemetry " + json.dumps(
            {k: last[k] for k in ("epoch", "train_loss", "n_messages") if k in last}))
    if args.trace_out and rank == 0:
        tracer = trace_lib.get_tracer()
        tracer.export_chrome_trace(args.trace_out)
        say(f"trace written to {args.trace_out} ({len(tracer.events())} events)")
    if args.metrics_out and rank == 0:
        obs_metrics.get_registry().write_jsonl(args.metrics_out, event="dmf_train_final")
        say(f"metrics snapshot appended to {args.metrics_out}")
    say(json.dumps({k: round(v, 4) for k, v in ev.items()}))
    return ev


if __name__ == "__main__":
    main()
