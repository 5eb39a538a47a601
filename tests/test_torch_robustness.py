"""Churn, stale exchange and crash-resume in the port
(`repro_torch.robustness.faults`, `.recovery`, `dmf.train_epoch_churn`,
`fit(churn=, checkpoint_dir=, resume_from=)`) against the reference's, on
the CPU, on the reference tests' small world (80 users, 50 items, 600
ratings, K=6, B=64).

The reference runs its jnp path (`DMFConfig(use_pallas=False)`); the port
runs its kernels' plain versions. Tolerances:

* plans and per-epoch row masks: exact (the same numpy draws);
* the trivial plan against the port's plain `fit`, DP off and on: bit for
  bit (every gate multiplies by 1.0);
* churn `fit` against the reference (dropout, delay classes 0-2, late
  joiners, DP on): the training slice's fit tolerance
  (`tests/test_torch_training.py`): losses within 1e-4 relative, U/P/Q
  within 1e-5 absolute — the P scatter sums duplicates in another order
  than XLA's, and the DP draws differ by an ulp of log/cos; the privacy
  summary equal;
* the fault contracts (offline rows frozen, messages to offline receivers
  lost, straggler messages exactly k epochs late) and resume: bit for bit
  within the port.
"""
import dataclasses
import json

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import dmf as ref_dmf  # noqa: E402
from repro.core import graph as ref_graph  # noqa: E402
from repro.data import synthetic_poi as ref_poi  # noqa: E402
from repro.robustness import ChurnConfig as RefChurnConfig  # noqa: E402
from repro.robustness import ChurnPlan as RefChurnPlan  # noqa: E402
from repro.robustness import DelayRing as RefDelayRing  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.core import dmf, graph  # noqa: E402
from repro_torch.robustness import ChurnConfig, ChurnPlan, DelayRing, no_churn, recovery  # noqa: E402

EPOCHS = 5
LOSS_RTOL, STATE_ATOL = 1e-4, 1e-5
CHURN = dict(dropout=0.2, delay_classes=(0, 1, 2), late_frac=0.1, seed=4)
DP = dict(dp_sigma=0.5, dp_clip=1.0, dp_seed=3)


@pytest.fixture(scope="module")
def world():
    ds = ref_poi.generate(ref_poi.POIDatasetConfig(n_users=80, n_items=50, n_ratings=600,
                                                   n_cities=4, seed=0))
    gcfg = ref_graph.GraphConfig(n_neighbors=2, walk_length=3)
    W = ref_graph.build_adjacency(ds.user_coords, ds.user_city, gcfg)
    pgcfg = graph.GraphConfig(n_neighbors=2, walk_length=3)
    pW = graph.build_adjacency(ds.user_coords, ds.user_city, pgcfg)
    return dict(ds=ds, ref_nbr=ref_graph.walk_neighbor_table(W, gcfg),
                nbr=graph.walk_neighbor_table(pW, pgcfg, device="cpu"))


def _configs(ds, **kw):
    common = dict(n_users=ds.n_users, n_items=ds.n_items, dim=6, batch_size=64,
                  beta=0.1, gamma=0.01, **kw)
    return dmf.DMFConfig(**common), ref_dmf.DMFConfig(**common)


def _assert_same_bits(a, b):
    for name in "UPQ":
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def _assert_close_to_ref(state, ref_state):
    for name in "UPQ":
        np.testing.assert_allclose(getattr(state, name).numpy(),
                                   np.asarray(getattr(ref_state, name)),
                                   rtol=0, atol=STATE_ATOL, err_msg=name)


# ------------------------------------------------------------ schedules
PLANS = {"dropout_delays": CHURN,
         "sessions": dict(dropout=0.1, session_alpha=1.5, late_frac=0.2, seed=7),
         "probs": dict(delay_classes=(0, 1, 3), delay_probs=(0.5, 0.3, 0.2), seed=2),
         "trivial": dict()}


@pytest.mark.parametrize("case", list(PLANS))
def test_churn_plan_and_row_masks_equal_the_reference(case):
    got = ChurnConfig(**PLANS[case]).compile(64, 9)
    ref = RefChurnConfig(**PLANS[case]).compile(64, 9)
    for f in ("online", "delay", "join_epoch"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
    assert (got.k_max, got.participation_rate, got.is_trivial()) == (
        ref.k_max, ref.participation_rate, ref.is_trivial())
    ui = np.random.default_rng(1).integers(0, 64, (5, 16))
    for t in range(9):
        for a, b in zip(got.epoch_row_masks(t, ui), ref.epoch_row_masks(t, ui)):
            np.testing.assert_array_equal(a, b)
    assert no_churn(16, 4).is_trivial() and DelayRing.create(0, 128, 6, device="cpu") is None


def test_churn_config_refuses_bad_arguments():
    for kw in (dict(dropout=1.0), dict(late_frac=1.5), dict(delay_classes=(0, -1)),
               dict(delay_classes=(0, 1.5)), dict(delay_classes=(0, 1), delay_probs=(1.0,))):
        with pytest.raises(ValueError):
            ChurnConfig(**kw)
    plan = no_churn(4, 2)
    with pytest.raises(ValueError):
        plan.epoch_row_masks(2, np.zeros((1, 2), np.int64))


def test_delay_ring_writes_like_the_reference():
    ring = DelayRing.create(2, 8, 4, device="cpu")
    ref = RefDelayRing.create(2, 8, 4)
    ui = np.arange(8, dtype=np.int32)
    for t in range(5):
        held = ring.ui                                # the epoch's view of the old slot
        ring.write(t, torch.ones(8, 4) * (t + 1), ui + t, ui, np.full(8, t + 2, np.int32))
        ref.write(t, jnp.ones((8, 4)) * (t + 1), ui + t, ui, np.full(8, t + 2, np.int32))
        assert held is not ring.ui                    # copied, not written in place
    for f in ("ui", "vj", "due"):
        np.testing.assert_array_equal(getattr(ring, f), getattr(ref, f))
    np.testing.assert_array_equal(ring.gp.numpy(), np.asarray(ref.gp))


# ------------------------------------------------------------ bit-exactness
@pytest.mark.parametrize("dp", [False, True], ids=["dp_off", "dp_on"])
def test_trivial_plan_is_bitexact_with_plain_fit(world, dp):
    ds = world["ds"]
    cfg, _ = _configs(ds, **(DP if dp else {}))
    plain = dmf.fit(cfg, ds.train, world["nbr"], epochs=3, test=ds.test, device="cpu")
    for churn in (ChurnConfig(), no_churn(ds.n_users, 3)):
        got = dmf.fit(cfg, ds.train, world["nbr"], epochs=3, test=ds.test, churn=churn,
                      device="cpu")
        assert got.train_losses == plain.train_losses
        assert got.test_losses == plain.test_losses
        assert got.privacy == plain.privacy
        _assert_same_bits(got.state, plain.state)


# ------------------------------------------------------------ parity
@pytest.fixture(scope="module")
def churn_fits(world):
    ds = world["ds"]
    cfg, rcfg = _configs(ds, **DP)
    ref = ref_dmf.fit(rcfg, ds.train, world["ref_nbr"], epochs=EPOCHS, test=ds.test,
                      churn=RefChurnConfig(**CHURN))
    got = dmf.fit(cfg, ds.train, world["nbr"], epochs=EPOCHS, test=ds.test,
                  churn=ChurnConfig(**CHURN), device="cpu")
    return got, ref


def test_churn_fit_matches_the_reference(churn_fits):
    got, ref = churn_fits
    np.testing.assert_allclose(got.train_losses, ref.train_losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got.test_losses, ref.test_losses, rtol=LOSS_RTOL)
    _assert_close_to_ref(got.state, ref.state)
    assert got.privacy == ref.privacy and got.privacy["epochs"] == EPOCHS


def test_train_epoch_churn_matches_the_reference_with_a_ring(world):
    ds = world["ds"]
    cfg, rcfg = _configs(ds, **DP)
    plan = ChurnConfig(**CHURN).compile(ds.n_users, 3)
    rplan = RefChurnConfig(**CHURN).compile(ds.n_users, 3)
    n = (len(ds.train) * 4 // 64) * 64
    ring = DelayRing.create(plan.k_max, n, 6, device="cpu")
    rring = RefDelayRing.create(rplan.k_max, n, 6)
    st = dmf.init_state(cfg, np.random.default_rng(0), device="cpu")
    rst = ref_dmf.init_state(rcfg, np.random.default_rng(0))
    rng, rrng = np.random.default_rng(1), np.random.default_rng(1)
    for t in range(3):
        st, loss = dmf.train_epoch_churn(st, world["nbr"], ds.train, cfg, rng, t, plan, ring,
                                         device="cpu")
        rst, rloss = ref_dmf.train_epoch_churn(rst, world["ref_nbr"], ds.train, rcfg, rrng, t,
                                               rplan, rring)
        np.testing.assert_allclose(loss, rloss, rtol=LOSS_RTOL)
        _assert_close_to_ref(st, rst)
        for f in ("ui", "vj", "due"):
            np.testing.assert_array_equal(getattr(ring, f), getattr(rring, f))
        np.testing.assert_allclose(ring.gp.numpy(), np.asarray(rring.gp), rtol=0, atol=1e-6)


# ------------------------------------------------------------ fault contracts
def test_offline_learner_rows_are_bit_frozen(world):
    ds = world["ds"]
    cfg, _ = _configs(ds)
    online = np.ones((2, ds.n_users), bool)
    offline = np.asarray([3, 11, 40, 79])
    online[0, offline] = False
    plan = ChurnPlan(online=online, delay=np.zeros(ds.n_users, np.int32),
                     join_epoch=np.zeros(ds.n_users, np.int32))
    rng = np.random.default_rng(cfg.seed)
    state = dmf.init_state(cfg, rng, device="cpu")
    before = {k: getattr(state, k).clone() for k in "UPQ"}
    state, loss = dmf.train_epoch_churn(state, world["nbr"], ds.train, cfg, rng, 0, plan, None,
                                        device="cpu")
    assert np.isfinite(loss)
    for k in "UPQ":
        assert torch.equal(getattr(state, k)[offline], before[k][offline]), k
    assert not torch.equal(state.U, before["U"])
    U1 = state.U.clone()
    state, _ = dmf.train_epoch_churn(state, world["nbr"], ds.train, cfg, rng, 1, plan, None,
                                     device="cpu")
    assert any(not torch.equal(state.U[u], U1[u]) for u in offline)   # rejoined


def test_late_joiner_stateless_until_join_epoch(world):
    ds = world["ds"]
    cfg, _ = _configs(ds)
    plan = ChurnConfig(late_frac=0.2, late_by=0.5, seed=5).compile(ds.n_users, EPOCHS)
    late = np.flatnonzero(plan.join_epoch > 0)
    assert late.size > 0
    rng = np.random.default_rng(cfg.seed)
    state = dmf.init_state(cfg, rng, device="cpu")
    init = {k: getattr(state, k).clone() for k in "UPQ"}
    for t in range(EPOCHS):
        for u in late[plan.join_epoch[late] > t]:
            for k in "UPQ":
                assert torch.equal(getattr(state, k)[u], init[k][u]), (t, u, k)
        state, _ = dmf.train_epoch_churn(state, world["nbr"], ds.train, cfg, rng, t, plan, None,
                                         device="cpu")


def _straggler_world(world):
    """Only user s rates: the stream carries s's messages alone."""
    ds, nbr = world["ds"], world["nbr"]
    idx, wgt = nbr.idx.numpy(), nbr.wgt.numpy()
    s = next(u for u in range(ds.n_users) if ((wgt[u] > 0) & (idx[u] != u)).any())
    receivers = np.unique(idx[s][(wgt[s] > 0) & (idx[s] != s)])
    train = ds.train[ds.train[:, 0] == s]
    if len(train) < 8:
        items = np.random.default_rng(0).choice(ds.n_items, 8, replace=False)
        train = np.stack([np.full(8, s), items], 1).astype(ds.train.dtype)
    cfg, _ = _configs(ds)
    return dataclasses.replace(cfg, batch_size=16), s, receivers, train


def _run_epochs(world, cfg, train, plan, epochs):
    rng = np.random.default_rng(cfg.seed)
    state = dmf.init_state(cfg, rng, device="cpu")
    nb = (len(train) * (1 + cfg.neg_samples)) // cfg.batch_size
    ring = DelayRing.create(plan.k_max, nb * cfg.batch_size, cfg.dim, device="cpu")
    hist = [state.P.clone()]
    for t in range(epochs):
        state, _ = dmf.train_epoch_churn(state, world["nbr"], train, cfg, rng, t, plan, ring,
                                         device="cpu")
        hist.append(state.P.clone())
    return hist


def test_straggler_messages_land_exactly_k_epochs_late(world):
    cfg, s, receivers, train = _straggler_world(world)
    n = cfg.n_users
    delay = np.zeros(n, np.int32)
    delay[s] = 2
    plan = ChurnPlan(online=np.ones((4, n), bool), delay=delay,
                     join_epoch=np.zeros(n, np.int32))
    hist = _run_epochs(world, cfg, train, plan, 4)
    assert torch.equal(hist[1][receivers], hist[0][receivers])
    assert torch.equal(hist[2][receivers], hist[0][receivers])
    assert not torch.equal(hist[1][s], hist[0][s])            # local compute is on time
    assert not torch.equal(hist[3][receivers], hist[2][receivers])   # epoch 0's, due at 2


def test_message_to_offline_receiver_is_lost_not_queued(world):
    cfg, s, receivers, train = _straggler_world(world)
    n = cfg.n_users
    delay = np.zeros(n, np.int32)
    delay[s] = 1
    online = np.ones((3, n), bool)
    online[1, receivers] = False
    online[1:, s] = False
    plan = ChurnPlan(online=online, delay=delay, join_epoch=np.zeros(n, np.int32))
    hist = _run_epochs(world, cfg, train, plan, 3)
    assert torch.equal(hist[2][receivers], hist[0][receivers])
    assert torch.equal(hist[3][receivers], hist[0][receivers])
    plan_on = ChurnPlan(online=np.ones((3, n), bool), delay=delay,
                        join_epoch=np.zeros(n, np.int32))
    hist_on = _run_epochs(world, cfg, train, plan_on, 2)
    assert not torch.equal(hist_on[2][receivers], hist_on[1][receivers])


# ------------------------------------------------------------ resume
def test_resume_is_bit_identical_with_dp_and_churn(world, tmp_path):
    ds = world["ds"]
    cfg, _ = _configs(ds, dp_sigma=0.7, dp_clip=1.0, dp_seed=2)
    cc = ChurnConfig(dropout=0.2, delay_classes=(0, 1, 2), late_frac=0.1, seed=9)
    full = dmf.fit(cfg, ds.train, world["nbr"], epochs=EPOCHS, test=ds.test, churn=cc,
                   checkpoint_dir=tmp_path, checkpoint_every=2, device="cpu")
    assert ckpt.steps(tmp_path) == [2, 4] and ckpt.latest_step(tmp_path) == 4
    resumed = dmf.fit(cfg, ds.train, world["nbr"], epochs=EPOCHS, test=ds.test, churn=cc,
                      resume_from=tmp_path / "step_2", device="cpu")
    assert resumed.train_losses == full.train_losses
    assert resumed.test_losses == full.test_losses
    assert resumed.privacy == full.privacy
    _assert_same_bits(resumed.state, full.state)


def test_resume_from_root_picks_the_latest_step(world, tmp_path):
    ds = world["ds"]
    cfg, _ = _configs(ds)
    full = dmf.fit(cfg, ds.train, world["nbr"], epochs=4, checkpoint_dir=tmp_path,
                   checkpoint_every=1, device="cpu")
    assert recovery.resolve_step_dir(tmp_path).name == "step_4"
    resumed = dmf.fit(cfg, ds.train, world["nbr"], epochs=4, resume_from=tmp_path,
                      device="cpu")
    assert resumed.train_losses == full.train_losses
    _assert_same_bits(resumed.state, full.state)


def test_resolve_step_dir_falls_back_past_a_corrupted_latest(world, tmp_path):
    ds = world["ds"]
    cfg, _ = _configs(ds, **DP)
    cc = ChurnConfig(dropout=0.2, delay_classes=(0, 1), seed=4)
    full = dmf.fit(cfg, ds.train, world["nbr"], epochs=4, churn=cc, checkpoint_dir=tmp_path,
                   checkpoint_every=1, device="cpu")
    leaf = tmp_path / "step_4" / "state__P.npy"
    raw = bytearray(leaf.read_bytes())
    raw[-3] ^= 0x40                                  # one flipped bit on disk
    leaf.write_bytes(bytes(raw))
    with pytest.warns(RuntimeWarning, match="falling back to step_3"):
        assert recovery.resolve_step_dir(tmp_path).name == "step_3"
    with pytest.warns(RuntimeWarning, match="falling back"):
        resumed = dmf.fit(cfg, ds.train, world["nbr"], epochs=4, churn=cc,
                          resume_from=tmp_path, device="cpu")
    assert resumed.train_losses == full.train_losses
    _assert_same_bits(resumed.state, full.state)
    with pytest.raises(ckpt.CorruptCheckpointError):   # named explicitly: fail loudly
        dmf.fit(cfg, ds.train, world["nbr"], epochs=4, churn=cc,
                resume_from=tmp_path / "step_4", device="cpu")
    for step in (1, 2, 3):
        (tmp_path / f"step_{step}" / "state__U.npy").unlink()
    with pytest.raises(ckpt.CorruptCheckpointError, match="every checkpoint"):
        recovery.resolve_step_dir(tmp_path)
    with pytest.raises(FileNotFoundError):
        recovery.resolve_step_dir(tmp_path / "nothing_here")


def test_resume_ring_mismatch_raises(world, tmp_path):
    ds = world["ds"]
    cfg, _ = _configs(ds)
    dmf.fit(cfg, ds.train, world["nbr"], epochs=2, churn=ChurnConfig(),
            checkpoint_dir=tmp_path, checkpoint_every=2, device="cpu")
    meta = json.loads((tmp_path / "step_2" / recovery.SIDECAR).read_text())
    assert meta["has_ring"] is False and meta["step"] == 2
    with pytest.raises(ValueError, match="has_ring"):
        dmf.fit(cfg, ds.train, world["nbr"], epochs=2, churn=ChurnConfig(delay_classes=(0, 1)),
                resume_from=tmp_path / "step_2", device="cpu")


def test_fit_refuses_plans_that_do_not_fit_the_run(world):
    ds = world["ds"]
    cfg, _ = _configs(ds)
    with pytest.raises(ValueError, match="churn plan"):
        dmf.fit(cfg, ds.train, world["nbr"], epochs=3, churn=no_churn(ds.n_users, 2),
                device="cpu")
    with pytest.raises(ValueError, match="dense_reference"):
        dmf.fit(cfg, ds.train, np.eye(ds.n_users, dtype=np.float32), epochs=1,
                churn=ChurnConfig(), dense_reference=True, device="cpu")


def test_degradation_envelope_dropout_and_staleness(world):
    ds = world["ds"]
    cfg, _ = _configs(ds)
    free = dmf.fit(cfg, ds.train, world["nbr"], epochs=8, device="cpu")
    hit = dmf.fit(cfg, ds.train, world["nbr"], epochs=8, device="cpu",
                  churn=ChurnConfig(dropout=0.3, delay_classes=(0, 1, 2), seed=1))
    assert all(np.isfinite(hit.train_losses))
    assert hit.train_losses[-1] < hit.train_losses[0]
    assert abs(hit.train_losses[-1] - free.train_losses[-1]) <= 0.5 * free.train_losses[-1]


def test_ref_plan_runs_in_the_port(world):
    """A plan compiled by the reference is plain data: the port's `fit`
    takes it as it takes its own."""
    ds = world["ds"]
    cfg, _ = _configs(ds)
    rplan = RefChurnConfig(**CHURN).compile(ds.n_users, 3)
    plan = ChurnPlan(online=rplan.online, delay=rplan.delay, join_epoch=rplan.join_epoch)
    a = dmf.fit(cfg, ds.train, world["nbr"], epochs=3, churn=plan, device="cpu")
    b = dmf.fit(cfg, ds.train, world["nbr"], epochs=3, churn=ChurnConfig(**CHURN), device="cpu")
    assert a.train_losses == b.train_losses
    _assert_same_bits(a.state, b.state)
    assert isinstance(rplan, RefChurnPlan)
