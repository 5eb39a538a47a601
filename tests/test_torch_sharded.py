"""Learner-sharded training in the port (`repro_torch.sharding.dmf`,
`dmf.fit` and `dmf.evaluate` with ``n_shards > 1``) against the
reference's, on the CPU: the port at D gloo ranks, each a process started
by `repro_torch.launch.mesh.spawn_ranks`, against the JAX package at the
same ``n_shards`` on its forced 8-device host mesh (`tests/conftest.py`),
with the same numpy inputs and seeds (the reference tests' small world:
80 users, 50 items, 600 ratings, K=6, B=64, 5 epochs).

One spawn per shard count runs every case of that count
(`_torch_sharded_ranks.training_case`); the reference runs meanwhile in
this process, and each parametrised case asserts on both.

Tolerances, the reference's own for its sharded runs: losses, test losses
and U/P/Q within 1e-5 of the reference's at the same shard count (the
port sums the P scatter's duplicates in another order than XLA); DP
losses within 1e-7 of the reference, P within 1e-5 and ε equal to 1e-12
relative; `evaluate(n_shards=D)` equal to the unsharded metrics exactly
and to the reference's. Bit for bit inside the port: σ=0 with clip=∞
against the plain run at each D, and the exchange round's privacy
contract (U and Q move only at the perturbed learner's rows, P only at
its receivers).
"""
import concurrent.futures

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import _torch_sharded_ranks as ranks  # noqa: E402
from repro.core import dmf as ref_dmf  # noqa: E402
from repro.core import graph as ref_graph  # noqa: E402
from repro.data import synthetic_poi as ref_poi  # noqa: E402
from repro.sharding import dmf as ref_sharded  # noqa: E402
from repro_torch.core import dmf, graph  # noqa: E402
from repro_torch.launch import dmf_train, mesh  # noqa: E402
from repro_torch.sharding import dmf as sharded_dmf  # noqa: E402

SHARDS = (1, 2, 4, 8)
TOL = 1e-5
DP_LOSS_TOL = 1e-7
SPAWN_TIMEOUT_S = 240.0


def ref_world(n_users=80, n_items=50, n_ratings=600, seed=0, walk_length=3):
    ds = ref_poi.generate(ref_poi.POIDatasetConfig(n_users=n_users, n_items=n_items,
                                                   n_ratings=n_ratings, n_cities=4, seed=seed))
    gcfg = ref_graph.GraphConfig(n_neighbors=2, walk_length=walk_length)
    W = ref_graph.build_adjacency(ds.user_coords, ds.user_city, gcfg)
    return ds, ref_graph.walk_neighbor_table(W, gcfg)


def ref_config(ds, **kw):
    return ref_dmf.DMFConfig(n_users=ds.n_users, n_items=ds.n_items, dim=6, batch_size=64,
                             beta=0.1, gamma=0.01, **kw)


def ref_fit(ds, nbr, D, cfg_kw=None, **kw):
    return ref_dmf.fit(ref_config(ds, n_shards=D, **(cfg_kw or {})), ds.train, nbr, **kw)


def reference_runs() -> dict:
    """The reference's runs of every case, by shard count."""
    ds, nbr = ref_world()
    out = {}
    for D in SHARDS:
        o = {mode: ref_fit(ds, nbr, D, dict(mode=mode), epochs=ranks.EPOCHS, test=ds.test)
             for mode in ranks.MODES}
        if D > 1:
            o["dp"] = ref_fit(ds, nbr, D, ranks.DP, epochs=ranks.EPOCHS, test=ds.test)
        out[D] = o
    ds77, nbr77 = ref_world(n_users=77, n_items=40, n_ratings=500, seed=1)
    out["users77"] = ref_fit(ds77, nbr77, 4, epochs=3)
    dsw, nbrw = ref_world(walk_length=0)
    out["walk0"] = ref_fit(dsw, nbrw, 4, epochs=3)
    out["privacy_round"] = ref_privacy_round(ds, nbr, 4)
    return out


def ref_privacy_round(ds, nbr, D):
    """The reference's `_one_sharded_epoch` on the same two rating worlds."""
    cfg = ref_config(ds, n_shards=D)
    plan = ref_sharded.make_shard_plan(nbr, cfg)
    ui, vj, r, conf = ref_dmf.sample_epoch(ds.train, cfg, np.random.default_rng(0))
    n, shape = cfg.batch_size, (1, cfg.batch_size)
    r2 = r.copy()
    r2[ui == int(ui[0])] = ranks.PERTURBED_RATING
    out = {}
    for name, rr in (("base", r), ("perturbed", r2)):
        b = ref_sharded.shard_batches(ui[:n].reshape(shape), vj[:n].reshape(shape),
                                      rr[:n].reshape(shape), conf[:n].reshape(shape), D,
                                      plan.rows)
        st = ref_sharded.shard_state(ref_dmf.init_state(cfg), plan)
        U, P, Q, _ = ref_sharded._epoch_sharded(
            st.U, st.P, st.Q, plan.part.idx, plan.part.wgt, *(jnp.asarray(x) for x in b),
            jnp.asarray(0, jnp.int32), cfg, plan.mesh)
        out[name] = tuple(np.asarray(x)[: ds.n_users] for x in (U, P, Q))
    return out


@pytest.fixture(scope="module")
def runs():
    """Every shard count's port runs (one spawn each, in a worker thread)
    and the reference's runs (in this thread, meanwhile)."""
    def spawn_all():
        return {D: mesh.spawn_ranks(ranks.training_case, D, backend="gloo", device="cpu",
                                    timeout_s=SPAWN_TIMEOUT_S, args=(D,)) for D in SHARDS}

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(spawn_all)
        ref = reference_runs()
        return dict(port=port.result(), ref=ref)


def assert_fit_close(got: dict, ref, tol=TOL, loss_tol=TOL) -> None:
    np.testing.assert_allclose(got["losses"], ref.train_losses, rtol=0, atol=loss_tol)
    np.testing.assert_allclose(got["test_losses"], ref.test_losses, rtol=0, atol=tol)
    for name in "UPQ":
        want = np.asarray(getattr(ref.state, name))
        assert got[name].shape == want.shape, name          # unpadded
        np.testing.assert_allclose(got[name], want, rtol=0, atol=tol, err_msg=name)


# ------------------------------------------------------------ the partition
@pytest.mark.parametrize("n_shards", [1, 3, 4, 8])
def test_partition_equals_the_reference_and_reconstructs_the_table(n_shards):
    ds, ref_nbr = ref_world()
    _, nbr = ranks.world()
    part = graph.partition_neighbor_table(nbr, n_shards, ds.n_users)
    ref = ref_graph.partition_neighbor_table(ref_nbr, n_shards, ds.n_users)
    np.testing.assert_array_equal(part.idx, np.asarray(ref.idx))
    np.testing.assert_array_equal(part.wgt, np.asarray(ref.wgt))
    assert (part.rows_per_shard, part.n_users) == (ref.rows_per_shard, ref.n_users)
    rows = part.rows_per_shard
    M_ref = ref_graph.dense_from_neighbor_table(ref_nbr, ds.n_users)
    M_got = np.zeros_like(M_ref)
    for d in range(n_shards):
        rcv = d * rows + part.idx[: ds.n_users, d]           # back to global rows
        np.add.at(M_got, (np.repeat(np.arange(ds.n_users), rcv.shape[1]), rcv.reshape(-1)),
                  part.wgt[: ds.n_users, d].reshape(-1))
    np.testing.assert_array_equal(M_got, M_ref)
    assert not part.wgt[ds.n_users:].any()                   # padded senders carry no mass


def test_shard_batches_equals_the_reference():
    ds, _ = ref_world()
    rng = np.random.default_rng(5)
    ui = rng.integers(0, ds.n_users, (6, 64))
    vj, r, c, g = (rng.integers(0, 50, (6, 64)), rng.random((6, 64)), rng.random((6, 64)),
                   (rng.random((6, 64)) > 0.3).astype(np.float32))
    for D in (1, 3, 8):
        rows = sharded_dmf.rows_per_shard(ds.n_users, D)
        got = sharded_dmf.shard_batches(ui, vj, r, c, D, rows, extras=(g,))
        want = ref_sharded.shard_batches(ui, vj, r, c, D, rows, extras=(g,))
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------ the shard-count grid (fit)
@pytest.mark.parametrize("mode", ranks.MODES)
@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_fit_matches_the_reference(runs, mode, n_shards):
    assert_fit_close(runs["port"][n_shards][mode], runs["ref"][n_shards][mode])


def test_nondivisible_users_pad_and_match_the_reference(runs):
    got = runs["port"][4]["users77"]
    assert got["U"].shape[0] == 77
    assert_fit_close(got, runs["ref"]["users77"])


def test_walk_length_zero_matches_the_reference(runs):
    assert_fit_close(runs["port"][4]["walk0"], runs["ref"]["walk0"])


@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_epoch_by_hand_is_fit_with_four_collectives_a_batch(runs, n_shards):
    """`train_epoch_sharded` in `fit`'s loop by hand gives `fit`'s run bit
    for bit (at D=1, where `fit` is the unsharded path, the same bits too),
    with one `all_to_all` per outbox tensor a batch and one gather of the
    losses an epoch."""
    got = runs["port"][n_shards]
    hand, fit = got["by_hand"], got["dmf"]
    assert hand["losses"] == fit["losses"]
    for name in "UPQ":
        np.testing.assert_array_equal(hand[name], fit[name], err_msg=name)
    assert hand["collectives"] == ranks.EPOCHS * (4 * hand["batches"] + 1)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_evaluate_equals_unsharded_and_the_reference(runs, n_shards):
    """`evaluate(n_shards=D)` on the port's trained state: the unsharded
    metrics exactly (chunked too), and the reference's `evaluate` at D on
    the same state."""
    got = runs["port"][n_shards]
    assert got["evaluate"] == got["evaluate_unsharded"]
    assert got["evaluate_chunked"] == got["evaluate_unsharded"]
    ds, _ = ref_world()
    st = ref_dmf.DMFState(*(jnp.asarray(got["dmf"][k]) for k in "UPQ"))
    ref = ref_dmf.evaluate(st, ds.train, ds.test, ds.n_users, ds.n_items, n_shards=n_shards)
    assert got["evaluate"] == ref


# ------------------------------------------------------------------ privacy
@pytest.mark.parametrize("n_shards", SHARDS)
def test_dp_off_is_the_plain_run_bit_for_bit(runs, n_shards):
    got = runs["port"][n_shards]
    assert got["dp_off"]["losses"] == got["dmf"]["losses"]
    assert got["dp_off"]["test_losses"] == got["dmf"]["test_losses"]
    np.testing.assert_array_equal(got["dp_off"]["P"], got["dmf"]["P"])
    assert got["dp_off"]["privacy"] is None


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_dp_on_matches_the_reference_at_every_shard_count(runs, n_shards):
    got, ref = runs["port"][n_shards]["dp"], runs["ref"][n_shards]["dp"]
    np.testing.assert_allclose(got["losses"], ref.train_losses, rtol=0, atol=DP_LOSS_TOL)
    np.testing.assert_allclose(got["P"], np.asarray(ref.state.P), rtol=0, atol=TOL)
    assert got["privacy"]["eps_max"] == pytest.approx(ref.privacy["eps_max"], rel=1e-12)
    # and the port is shard-count invariant
    np.testing.assert_allclose(got["losses"], runs["port"][1]["dp"]["losses"], rtol=0,
                               atol=DP_LOSS_TOL)
    assert got["privacy"] == runs["port"][1]["dp"]["privacy"]


def test_rating_perturbation_stays_local(runs):
    """One exchange round at 4 ranks: U and Q change only at the perturbed
    learner's rows, P only at its receivers; both worlds within 1e-5 of the
    reference's round."""
    got = runs["port"][4]["privacy_round"]
    _, nbr = ranks.world()
    L = got["learner"]
    (U1, P1, Q1), (U2, P2, Q2) = got["base"], got["perturbed"]
    idx, wgt = nbr.idx.numpy(), nbr.wgt.numpy()
    receivers = idx[L][wgt[L] > 0]
    assert set(np.nonzero((U1 != U2).any(axis=1))[0]) <= {L}
    assert set(np.nonzero((Q1 != Q2).any(axis=(1, 2)))[0]) <= {L}
    assert set(np.nonzero((P1 != P2).any(axis=(1, 2)))[0]) <= set(receivers)
    assert L in receivers
    assert (P1 != P2).any()                                  # the message did land
    for name in ("base", "perturbed"):
        for a, b in zip(got[name], runs["ref"]["privacy_round"][name]):
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


def test_outbox_is_a_pure_function_of_the_message():
    """`build_outbox(gp, tables, vj)` takes no ratings, u or q; equal errors
    from other rating values give the same outbox, equal to the
    reference's, in the fixed (D, B, S), (D, B, S), (D, B, K), (D, B)
    shapes."""
    ds, ref_nbr = ref_world()
    _, nbr = ranks.world()
    cfg = ranks.config(ds)
    part = graph.partition_neighbor_table(nbr, 4, ds.n_users)
    ref_part = ref_graph.partition_neighbor_table(ref_nbr, 4, ds.n_users)
    rng = np.random.default_rng(3)
    B, K = 32, cfg.dim
    u = torch.as_tensor(rng.normal(size=(B, K)).astype(np.float32))
    p = q = torch.zeros((B, K))
    users = rng.integers(0, ds.n_users, B)
    vj = torch.as_tensor(rng.integers(0, ds.n_items, B))
    _, gp1, _, _ = dmf._grads_and_loss(u, p, q, torch.full((B,), 1.0), torch.full((B,), 0.25),
                                       cfg)
    _, gp2, _, _ = dmf._grads_and_loss(u, p, q, torch.full((B,), 0.25), torch.full((B,), 1.0),
                                       cfg)
    assert torch.equal(gp1, gp2)
    tbl_i, tbl_w = torch.as_tensor(part.idx[users]), torch.as_tensor(part.wgt[users])
    box1 = sharded_dmf.build_outbox(gp1, tbl_i, tbl_w, vj)
    box2 = sharded_dmf.build_outbox(gp2, tbl_i, tbl_w, vj)
    ref_box = ref_sharded.build_outbox(jnp.asarray(gp1.numpy()), ref_part.idx[users],
                                       ref_part.wgt[users], jnp.asarray(vj.numpy()))
    for a, b, c in zip(box1, box2, ref_box):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    S = nbr.idx.shape[1]
    assert [tuple(x.shape) for x in box1] == [(4, B, S), (4, B, S), (4, B, K), (4, B)]


# ------------------------------------------------------------ failure paths
def test_fit_and_evaluate_outside_a_process_group_raise():
    ds, nbr = ranks.world()
    cfg = ranks.config(ds, n_shards=2)
    with pytest.raises(RuntimeError, match="process group"):
        dmf.fit(cfg, ds.train, nbr, epochs=1, device="cpu")
    st = dmf.init_state(ranks.config(ds), device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        dmf.evaluate(st, ds.train, ds.test, ds.n_users, ds.n_items, n_shards=2, device="cpu")
    with pytest.raises(ValueError, match="n_shards"):
        ranks.config(ds, n_shards=0)
    with pytest.raises(ValueError, match="dense_reference"):
        dmf.fit(cfg, ds.train, np.eye(ds.n_users, dtype=np.float32), epochs=1,
                dense_reference=True, device="cpu")


def test_nccl_with_more_ranks_than_cards_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="one card per rank"):
        mesh.spawn_ranks(ranks.hang, 2, backend="nccl", device="cuda")
    with pytest.raises(ValueError, match="cuda ranks only"):
        mesh.spawn_ranks(ranks.hang, 1, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        mesh.spawn_ranks(ranks.hang, 2, backend="mpi", device="cpu")
    with pytest.raises(ValueError, match="cuda ranks only"):
        dmf_train.main(["--n-shards", "2", "--dist-backend", "nccl", "--device", "cpu"])


def test_a_raising_rank_fails_the_spawn_with_its_traceback():
    with pytest.raises(RuntimeError, match="rank 1 of 2 raised") as err:
        mesh.spawn_ranks(ranks.raise_on_rank_one, 2, backend="gloo", device="cpu",
                         timeout_s=60.0)
    assert "Traceback" in str(err.value) and "raised on purpose by rank 1" in str(err.value)


def test_a_hung_rank_fails_the_spawn_at_its_timeout():
    with pytest.raises(RuntimeError, match="did not finish within"):
        mesh.spawn_ranks(ranks.hang, 2, backend="gloo", device="cpu", timeout_s=5.0)


def test_cli_shards_flag_prints_the_reference_shards_line(capfd):
    """`--n-shards 2` on the CPU spawns two gloo ranks; rank 0 alone
    prints, and the line names the shard count as the reference's does."""
    got = dmf_train.main(["--epochs", "2", "--n-shards", "2", "--device", "cpu"])
    out = [ln for ln in capfd.readouterr().out.splitlines() if ln.strip()]
    assert sum("shards=2" in ln for ln in out) == 1
    assert sum(ln.startswith("{") for ln in out) == 1
    assert set(got) == {"P@5", "R@5", "P@10", "R@10"}


def test_unpad_and_local_rows_take_each_ranks_rows():
    """`local_rows` on a stand-in plan: rank d's rows of a full array,
    zero-padded; the trailing rank may hold only padding."""
    x = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    for D, rank in ((3, 0), (3, 2), (4, 3)):
        rows = sharded_dmf.rows_per_shard(10, D)
        plan = sharded_dmf.ShardPlan(
            group=sharded_dmf.LearnerGroup(rank, D, torch.device("cpu"), "gloo"),
            part=graph.PartitionedNeighborTable(np.zeros((rows * D, D, 1), np.int64),
                                                np.zeros((rows * D, D, 1), np.float32),
                                                rows, 10),
            idx=torch.zeros(0), wgt=torch.zeros(0))
        got = sharded_dmf.local_rows(x, plan).numpy()
        want = np.zeros((rows, 3), np.float32)
        lo, hi = sharded_dmf.shard_row_slices(10, D)[rank]
        want[:hi - lo] = x[lo:hi]
        np.testing.assert_array_equal(got, want)
