"""What each rank runs in the sharded tests of the port
(`tests/test_torch_sharded.py`, `tests/test_torch_sharded_faults.py`).

The ranks are processes started by `repro_torch.launch.mesh.spawn_ranks`,
which imports these functions by name; this module imports only numpy,
torch and `repro_torch`, so a rank starts without JAX. Each function runs
every case of one shard count on the reference tests' small world (80
users, 50 items, 600 ratings, K=6, B=64) on the CPU, one thread a rank,
and returns host arrays; rank 0's return value reaches the test.
"""
from __future__ import annotations

import pathlib

import numpy as np
import torch

from repro_torch.core import dmf, graph
from repro_torch.data import synthetic_poi
from repro_torch.robustness import AttackConfig, ChurnConfig, DefenseConfig
from repro_torch.sharding import dmf as sharded_dmf

EPOCHS = 5
OBS_EPOCHS = 4
MODES = ("dmf", "gdmf", "ldmf")
DP = dict(dp_sigma=0.5, dp_clip=1.0, dp_seed=3)
BYZ_DP = dict(dp_sigma=0.3, dp_clip=1.0, dp_seed=3)
CHURN = dict(dropout=0.2, delay_classes=(0, 1, 2), late_frac=0.1, seed=4)
CHURN_SHORT = dict(dropout=0.2, delay_classes=(0, 1), seed=4)
ATTACK = dict(family="sign_flip", frac=0.2, seed=5)
MEDIAN = dict(screen=True, norm_cap=2.0, aggregation="median")
SCREEN = dict(screen=True, norm_cap=2.0)
PERTURBED_RATING = 0.37


def world(n_users=80, n_items=50, n_ratings=600, seed=0, walk_length=3):
    ds = synthetic_poi.generate(synthetic_poi.POIDatasetConfig(
        n_users=n_users, n_items=n_items, n_ratings=n_ratings, n_cities=4, seed=seed))
    gcfg = graph.GraphConfig(n_neighbors=2, walk_length=walk_length)
    W = graph.build_adjacency(ds.user_coords, ds.user_city, gcfg)
    return ds, graph.walk_neighbor_table(W, gcfg, device="cpu")


def config(ds, **kw) -> dmf.DMFConfig:
    return dmf.DMFConfig(n_users=ds.n_users, n_items=ds.n_items, dim=6, batch_size=64,
                         beta=0.1, gamma=0.01, **kw)


def host(res: dmf.FitResult) -> dict:
    """A `FitResult` as host data."""
    return dict(losses=list(res.train_losses), test_losses=list(res.test_losses),
                U=res.state.U.numpy(), P=res.state.P.numpy(), Q=res.state.Q.numpy(),
                privacy=res.privacy, telemetry=res.telemetry, diverged_at=res.diverged_at)


def _fit(ds, nbr, D, cfg_kw=None, device="cpu", **kw) -> dict:
    return host(dmf.fit(config(ds, n_shards=D, **(cfg_kw or {})), ds.train, nbr,
                        device=device, **kw))


def sharded_epochs(ds, nbr, D, cfg_kw=None, device="cpu", epochs=EPOCHS) -> dict:
    """`fit`'s loop by hand through `sharding.dmf.train_epoch_sharded`, so
    that one rank (D=1) runs the sharded epoch too; `fit` at D=1 is the
    unsharded path, as in the reference. The plan's clock counts the
    collectives."""
    cfg = config(ds, n_shards=D, **(cfg_kw or {}))
    clock = sharded_dmf.ExchangeClock()
    plan = sharded_dmf.make_shard_plan(nbr, cfg, device, clock)
    rng = np.random.default_rng(cfg.seed)
    state = sharded_dmf.init_local_state(cfg, rng, plan)
    losses = []
    for _ in range(epochs):
        state, loss = sharded_dmf.train_epoch_sharded(state, plan, ds.train, cfg, rng,
                                                      device=device)
        losses.append(loss)
    calls = clock.calls
    full = sharded_dmf.unpad_state(state, plan, cfg.n_users)
    return dict(losses=losses, collectives=calls, batches=len(ds.train) * 4 // cfg.batch_size,
                **{k: getattr(full, k).cpu().numpy() for k in "UPQ"})


def _full_stack(ds) -> dict:
    """DP + churn + Byzantine with screening (the reference's obs tests)."""
    return dict(epochs=OBS_EPOCHS, test=ds.test, churn=ChurnConfig(**CHURN_SHORT),
                attack=AttackConfig(**ATTACK), defense=DefenseConfig(**SCREEN))


def privacy_round(ds, nbr, D: int) -> dict:
    """One minibatch of the sharded epoch from the initial state, for the
    sampled ratings and again with one learner's ratings changed; returns
    both worlds' full U, P, Q and the learner."""
    cfg = config(ds, n_shards=D)
    plan = sharded_dmf.make_shard_plan(nbr, cfg, "cpu")
    ui, vj, r, conf = dmf.sample_epoch(ds.train, cfg, np.random.default_rng(0))
    n = cfg.batch_size
    shape = (1, n)
    L = int(ui[0])
    r2 = r.copy()
    r2[ui == L] = PERTURBED_RATING
    out = {"learner": L}
    for name, rr in (("base", r), ("perturbed", r2)):
        routed = sharded_dmf.shard_batches(ui[:n].reshape(shape), vj[:n].reshape(shape),
                                           rr[:n].reshape(shape), conf[:n].reshape(shape),
                                           D, plan.rows)
        st = sharded_dmf.init_local_state(cfg, np.random.default_rng(cfg.seed), plan)
        i64, f32 = sharded_dmf._upload(plan, torch.int64), sharded_dmf._upload(plan)
        ui_l, vj_s, r_s, conf_s, valid, rid = routed
        sharded_dmf._epoch_sharded(st.U, st.P, st.Q, plan, i64(ui_l), i64(vj_s), f32(r_s),
                                   f32(conf_s), f32(valid),
                                   sharded_dmf._upload(plan, torch.int32)(rid), 0, cfg)
        full = sharded_dmf.unpad_state(st, plan, cfg.n_users)
        out[name] = tuple(x.numpy() for x in (full.U, full.P, full.Q))
    return out


def training_case(rank: int, D: int) -> dict:
    """`fit` in the three modes, DP on, σ=0 with clip=∞, `evaluate`; at
    D=4 also 77 users, walk length 0 and one exchange round of two rating
    worlds."""
    torch.set_num_threads(1)
    ds, nbr = world()
    out = {mode: _fit(ds, nbr, D, dict(mode=mode), epochs=EPOCHS, test=ds.test)
           for mode in MODES}
    st = dmf.state_from_numpy(out["dmf"]["U"], out["dmf"]["P"], out["dmf"]["Q"], device="cpu")
    args = (st, ds.train, ds.test, ds.n_users, ds.n_items)
    out["evaluate"] = dmf.evaluate(*args, n_shards=D, device="cpu")
    out["evaluate_chunked"] = dmf.evaluate(*args, n_shards=D, chunk_users=7, device="cpu")
    out["evaluate_unsharded"] = dmf.evaluate(*args, device="cpu")
    out["dp"] = _fit(ds, nbr, D, DP, epochs=EPOCHS, test=ds.test)
    out["dp_off"] = _fit(ds, nbr, D, dict(dp_sigma=0.0, dp_clip=float("inf")), epochs=EPOCHS,
                         test=ds.test)
    out["by_hand"] = sharded_epochs(ds, nbr, D)
    if D == 4:
        ds77, nbr77 = world(n_users=77, n_items=40, n_ratings=500, seed=1)
        out["users77"] = _fit(ds77, nbr77, D, epochs=3)
        dsw, nbrw = world(walk_length=0)
        out["walk0"] = _fit(dsw, nbrw, D, epochs=3)
        out["privacy_round"] = privacy_round(ds, nbr, D)
    return out


def faults_case(rank: int, D: int, ckpt_root: str) -> dict:
    """Churn, DP, attacks and defenses, telemetry and checkpoints at D
    ranks. The 2-rank case writes snapshots under ``ckpt_root``; the 4-rank
    case resumes from its step_2."""
    torch.set_num_threads(1)
    ds, nbr = world()
    out = {"plain": _fit(ds, nbr, D, epochs=EPOCHS),
           "trivial": _fit(ds, nbr, D, epochs=EPOCHS, churn=ChurnConfig()),
           "dp_plain": _fit(ds, nbr, D, DP, epochs=EPOCHS),
           "dp_byz_off": _fit(ds, nbr, D, DP, epochs=EPOCHS, attack=None, defense=None)}
    stack = _full_stack(ds)
    out["stack_on"] = _fit(ds, nbr, D, BYZ_DP, telemetry=True, **stack)
    if D > 1:
        out["stack_off"] = _fit(ds, nbr, D, BYZ_DP, **stack)
        out["churn"] = _fit(ds, nbr, D, epochs=EPOCHS, churn=ChurnConfig(**CHURN))
        out["byzantine"] = _fit(ds, nbr, D, BYZ_DP, epochs=EPOCHS,
                                churn=ChurnConfig(**CHURN_SHORT),
                                attack=AttackConfig(**ATTACK), defense=DefenseConfig(**MEDIAN))
    if D <= 2:
        out["nan_halt"] = _fit(ds, nbr, D, epochs=EPOCHS, attack=AttackConfig(
            family="nan", frac=0.2, seed=5), on_nonfinite="halt")
    root = pathlib.Path(ckpt_root)
    if D == 2:
        kw = dict(epochs=3, test=ds.test, churn=ChurnConfig(**CHURN_SHORT))
        out["nobyz_off"] = _fit(ds, nbr, D, BYZ_DP, **kw)
        out["nobyz_on"] = _fit(ds, nbr, D, BYZ_DP, telemetry=True, **kw)
        kw = dict(epochs=EPOCHS, churn=ChurnConfig(**CHURN_SHORT))
        out["ckpt_full"] = _fit(ds, nbr, D, checkpoint_dir=root, checkpoint_every=2,
                                telemetry_out=root / "telemetry.jsonl", **kw)
        out["resumed"] = _fit(ds, nbr, D, resume_from=root / "step_2", **kw)
    if D == 4:
        out["churn_dp"] = _fit(ds, nbr, D, DP, epochs=EPOCHS, churn=ChurnConfig(**CHURN_SHORT))
        out["wider"] = _fit(ds, nbr, D, epochs=EPOCHS, churn=ChurnConfig(**CHURN_SHORT),
                            resume_from=root / "step_2")
    return out


def card_case(rank: int, D: int) -> dict:
    """On the card: `fit` DP off and on, the sharded epochs by hand, and
    `evaluate(n_shards=D)`."""
    ds, nbr = world()
    out = {}
    for name, kw in (("plain", {}), ("dp", DP)):
        res = dmf.fit(config(ds, n_shards=D, **kw), ds.train, nbr, epochs=EPOCHS,
                      test=ds.test, device="cuda")
        out[name] = dict(losses=res.train_losses, test_losses=res.test_losses,
                         **{k: getattr(res.state, k).cpu().numpy() for k in "UPQ"})
        out[name + "_by_epoch"] = sharded_epochs(ds, nbr, D, kw, device="cuda")
        if name == "plain":
            out["evaluate"] = dmf.evaluate(res.state, ds.train, ds.test, ds.n_users,
                                           ds.n_items, n_shards=D, device="cuda")
    return out


def raise_on_rank_one(rank: int) -> None:
    """Rank 1 raises; rank 0 waits in a collective that rank 1 never joins."""
    if rank == 1:
        raise ValueError("raised on purpose by rank 1")
    torch.distributed.barrier()


def hang(rank: int) -> None:
    """Every rank blocks in a collective that never completes."""
    if rank == 0:
        torch.distributed.recv(torch.zeros(1), src=1)
    else:
        torch.distributed.recv(torch.zeros(1), src=0)
