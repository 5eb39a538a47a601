"""Byzantine-robust exchange in the port (`repro_torch.robustness.byzantine`,
`fit(attack=, defense=)`) against the reference's, on the CPU, on the
reference tests' small world (80 users, 50 items, 600 ratings, K=6, B=64).

Tolerances:

* attack plans, per-row attack arrays and bucket assignments: exact (the
  same numpy);
* `screen_ok`, `corrupt_messages`, `_sort_cols` and `robust_combine` on the
  same arrays (NaN, ±Inf, empty buckets): equal, NaN pattern included —
  each sums at most ``cap`` values along one axis in the same order;
* the inactive defense and the trivial attack against the port's plain
  `fit`: bit for bit;
* attacked and defended `fit` against the reference: losses within 1e-4
  relative and U/P/Q within 1e-5 absolute where the run stays near the
  fault-free scale (the training slice's fit tolerance). The undefended
  λ=100 run diverges and halts at the same epoch in both packages; its
  last finite factors, grown to ~1e21 by then, agree within 1e-4 relative
  elementwise (plus 1e-5 absolute): the scatter's fp32 sum order, amplified
  by the blow-up (the largest difference seen was 1.3e-5 relative).
"""
import math

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import dmf as ref_dmf  # noqa: E402
from repro.core import graph as ref_graph  # noqa: E402
from repro.data import synthetic_poi as ref_poi  # noqa: E402
from repro.robustness import ChurnConfig as RefChurnConfig  # noqa: E402
from repro.robustness import byzantine as ref_byz  # noqa: E402
from repro_torch.core import dmf, graph  # noqa: E402
from repro_torch.robustness import ChurnConfig, byzantine  # noqa: E402
from repro_torch.robustness.byzantine import AttackConfig, DefenseConfig  # noqa: E402

EPOCHS = 5
LOSS_RTOL, STATE_ATOL = 1e-4, 1e-5
FAMILIES = ("nan", "inf", "norm_inflate", "sign_flip", "shill")


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


def _same(got: torch.Tensor, ref) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ------------------------------------------------------------ host half
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("collude", [True, False])
def test_attack_plan_and_row_arrays_equal_the_reference(family, collude):
    kw = dict(family=family, frac=0.3, scale=7.0, target_item=4, collude=collude,
              start_epoch=1, seed=11)
    got = AttackConfig(**kw).compile(40, 4, 6)
    ref = ref_byz.AttackConfig(**kw).compile(40, 4, 6)
    for f in ("active", "malicious", "dirs"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
    assert (got.n_malicious, got.is_trivial()) == (ref.n_malicious, ref.is_trivial())
    rng = np.random.default_rng(3)
    ui = rng.integers(0, 41, (3, 16))                 # 40 = a padded slot
    vj = rng.integers(0, 9, (3, 16)).astype(np.int32)
    gate = rng.random((3, 16)) > 0.3
    for t in range(4):
        for a, b in zip(got.epoch_row_attack(t, ui, vj, sender_on=gate),
                        ref.epoch_row_attack(t, ui, vj, sender_on=gate)):
            np.testing.assert_array_equal(a, b)
    assert byzantine.no_attack(8, 2, 3).is_trivial()


def test_configs_refuse_bad_arguments():
    for kw in (dict(family="meteor"), dict(frac=1.5), dict(scale=0.0), dict(target_item=-1)):
        with pytest.raises(ValueError):
            AttackConfig(**kw)
    for kw in (dict(aggregation="mean"), dict(trim_frac=0.5), dict(norm_cap=0.0)):
        with pytest.raises(ValueError):
            DefenseConfig(**kw)
    assert not DefenseConfig().active and DefenseConfig(aggregation="median").active


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("gated", [False, True])
def test_group_messages_equal_the_reference(world, seed, gated):
    rng = np.random.default_rng(seed)
    idx, wgt = world["nbr"].idx.numpy(), world["nbr"].wgt.numpy()
    I, J = idx.shape[0], world["ds"].n_items
    ui = rng.integers(0, I, (3, 64))
    vj = rng.integers(0, J, (3, 64)).astype(np.int32)
    kw = {}
    if gated:
        kw = dict(sender_gate=rng.random((3, 64)) > 0.2, recv_on=rng.random(I) > 0.1)
    got = byzantine.group_messages(ui, vj, idx, wgt, J, **kw)
    ref = ref_byz.group_messages(ui, vj, np.asarray(world["ref_nbr"].idx),
                                 np.asarray(world["ref_nbr"].wgt), J, **kw)
    for f in ("bucket_id", "pos", "recv", "item"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
    assert got.cap == ref.cap and got.n_buckets == ref.n_buckets


# ------------------------------------------------------------ device half
def _messages(seed, n=40, K=5):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(n, K)).astype(np.float32)
    g[3, 1], g[7, 0], g[8, 4], g[9] = np.nan, np.inf, -np.inf, 0.0
    g[10] = [3.0, 4.0, 0.0, 0.0, 0.0]                 # norm exactly 5
    g[11] *= 100.0
    return g


@pytest.mark.parametrize("cap", [math.inf, 5.0, 2.5])
def test_screen_ok_equals_the_reference(cap):
    g = _messages(0)
    _same(byzantine.screen_ok(torch.from_numpy(g), cap), ref_byz.screen_ok(jnp.asarray(g), cap))
    got = byzantine.screen_ok(torch.from_numpy(g.reshape(4, 10, 5)), cap)
    assert got.shape == (4, 10)


def test_screen_ok_semantics():
    g = torch.tensor([[1.0, 2.0, 2.0], [np.nan, 0.0, 0.0], [np.inf, 1.0, 1.0],
                      [30.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
    assert byzantine.screen_ok(g, 10.0).tolist() == [1, 0, 0, 0, 1]
    assert byzantine.screen_ok(g, math.inf).tolist() == [1, 0, 0, 1, 1]
    assert byzantine.screen_ok(g, 3.0).tolist() == [1, 0, 0, 0, 1]   # exactly τ passes


def test_corrupt_messages_equals_the_reference():
    rng = np.random.default_rng(2)
    g = rng.normal(size=(12, 4)).astype(np.float32)
    amul = np.array([1, 100, np.nan, np.inf, -1, 1, 1, 1, 1, 1, 1, 1], np.float32)
    ashill = (rng.random(12) > 0.6).astype(np.float32)
    shill = rng.normal(size=(12, 4)).astype(np.float32)
    got = byzantine.corrupt_messages(*map(torch.from_numpy, (g, amul, ashill, shill)))
    _same(got, ref_byz.corrupt_messages(*map(jnp.asarray, (g, amul, ashill, shill))))


@pytest.mark.parametrize("cap", [1, 4, 5, 8])
def test_sort_cols_equals_the_reference_nan_included(cap):
    rng = np.random.default_rng(cap)
    vs = rng.normal(size=(30, cap, 3)).astype(np.float32)
    vs[rng.random(vs.shape) < 0.1] = np.nan
    vs[rng.random(vs.shape) < 0.1] = np.inf
    vs[rng.random(vs.shape) < 0.1] = -np.inf
    got = byzantine._sort_cols(torch.from_numpy(vs))
    _same(got, ref_byz._sort_cols(jnp.asarray(vs)))
    clean = np.sort(rng.normal(size=(30, cap, 3)).astype(np.float32), axis=1)[:, ::-1].copy()
    np.testing.assert_array_equal(byzantine._sort_cols(torch.from_numpy(clean)).numpy(),
                                  np.sort(clean, axis=1))


def _buckets(seed, M=200, n_buckets=32, cap=8, K=4, poison=True):
    """Random slots into unique (bucket, pos) cells, some invalid (the
    overflow row), values with NaN/±Inf where ``poison``, a few buckets
    left empty."""
    rng = np.random.default_rng(seed)
    cells = rng.permutation(n_buckets * cap)[:M]
    bucket = (cells // cap).astype(np.int32)
    pos = (cells % cap).astype(np.int32)
    bucket[bucket >= n_buckets - 3] = n_buckets        # 3 empty buckets
    invalid = rng.random(M) < 0.15
    bucket[invalid] = n_buckets
    pos[bucket == n_buckets] = 0
    vals = rng.normal(size=(M, K)).astype(np.float32)
    if poison:
        vals[rng.random((M, K)) < 0.05] = np.nan
        vals[rng.random((M, K)) < 0.05] = np.inf
        vals[rng.random((M, K)) < 0.05] = -np.inf
    validity = ((bucket < n_buckets) & (rng.random(M) < 0.9)).astype(np.float32)
    vals[bucket == n_buckets] = 0.0                   # host-invalid slots carry 0
    return vals, validity, bucket, pos, n_buckets, cap


@pytest.mark.parametrize("defense", [dict(aggregation="trim", trim_frac=0.25),
                                     dict(aggregation="trim", trim_frac=0.0),
                                     dict(aggregation="median")],
                         ids=["trim25", "trim0", "median"])
@pytest.mark.parametrize("poison", [False, True], ids=["finite", "nan_inf"])
@pytest.mark.parametrize("seed", [0, 1])
def test_robust_combine_equals_the_reference(defense, poison, seed):
    vals, validity, bucket, pos, nbk, cap = _buckets(seed, poison=poison)
    got = byzantine.robust_combine(*map(torch.from_numpy, (vals, validity, bucket, pos)),
                                   nbk, cap, DefenseConfig(**defense))
    ref = ref_byz.robust_combine(*map(jnp.asarray, (vals, validity, bucket, pos)), nbk, cap,
                                 ref_byz.DefenseConfig(**defense))
    assert got.shape == (nbk, vals.shape[1])
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(np.asarray(ref)))
    _same(got, ref)
    assert (got[-3:] == 0).all()                      # empty buckets combine to 0


def test_robust_combine_trim_and_median_math():
    vals = torch.tensor([[1.0], [2.0], [100.0], [3.0], [5.0], [77.0]])
    validity = torch.tensor([1.0, 1.0, 1.0, 1.0, 1.0, 0.0])
    bucket = torch.tensor([0, 0, 0, 0, 1, 2], dtype=torch.int32)
    pos = torch.tensor([0, 1, 2, 3, 0, 0], dtype=torch.int32)
    trim = DefenseConfig(aggregation="trim", trim_frac=0.25)
    assert byzantine.robust_combine(vals, validity, bucket, pos, 2, 4, trim).tolist() == [
        [10.0], [5.0]]
    med = DefenseConfig(aggregation="median")
    assert byzantine.robust_combine(vals, validity, bucket, pos, 2, 4, med).tolist() == [
        [10.0], [5.0]]
    none = byzantine.robust_combine(vals, torch.zeros(6), bucket, pos, 2, 4, med)
    assert none.tolist() == [[0.0], [0.0]]


# ------------------------------------------------------------ bit-exactness
@pytest.mark.parametrize("dp", [False, True], ids=["dp_off", "dp_on"])
def test_inactive_defense_and_trivial_attack_are_bitexact_with_plain_fit(world, dp):
    ds = world["ds"]
    cfg, _ = _configs(ds, **(dict(dp_sigma=0.5, dp_clip=1.0, dp_seed=3) if dp else {}))
    cc = ChurnConfig(dropout=0.2, delay_classes=(0, 1), seed=4)
    for churn in (None, cc):
        plain = dmf.fit(cfg, ds.train, world["nbr"], epochs=3, churn=churn, device="cpu")
        for kw in (dict(defense=DefenseConfig()), dict(attack=AttackConfig(family="none")),
                   dict(attack=AttackConfig(family="nan", frac=0.0), defense=DefenseConfig())):
            got = dmf.fit(cfg, ds.train, world["nbr"], epochs=3, churn=churn, device="cpu", **kw)
            assert got.train_losses == plain.train_losses, kw
            for n in "UPQ":
                assert torch.equal(getattr(got.state, n), getattr(plain.state, n)), (kw, n)


# ------------------------------------------------------------ parity under attack
RUNS = {
    "inflate_screen_trim": dict(attack=dict(family="norm_inflate", frac=0.2, scale=100.0, seed=5),
                                defense=dict(screen=True, norm_cap=1.0, aggregation="trim",
                                             trim_frac=0.25)),
    "nan_screen": dict(attack=dict(family="nan", frac=0.2, seed=5), defense=dict(screen=True)),
    "signflip_median_churn_dp": dict(
        attack=dict(family="sign_flip", frac=0.2, seed=5),
        defense=dict(screen=True, norm_cap=2.0, aggregation="median"),
        churn=dict(dropout=0.2, delay_classes=(0, 1), seed=4),
        dp=dict(dp_sigma=0.3, dp_clip=1.0, dp_seed=3)),
    "shill_screen_ring": dict(attack=dict(family="shill", frac=0.2, scale=3.0, seed=5),
                              defense=dict(screen=True, norm_cap=2.0),
                              churn=dict(delay_classes=(0, 1, 2), seed=4)),
    "inflate_undefended": dict(attack=dict(family="norm_inflate", frac=0.2, scale=100.0,
                                           seed=5)),
}


@pytest.fixture(scope="module", params=list(RUNS))
def attacked(request, world):
    ds, run = world["ds"], RUNS[request.param]
    cfg, rcfg = _configs(ds, **run.get("dp", {}))
    churn = run.get("churn")
    got = dmf.fit(cfg, ds.train, world["nbr"], epochs=EPOCHS, device="cpu",
                  attack=AttackConfig(**run["attack"]),
                  defense=DefenseConfig(**run["defense"]) if "defense" in run else None,
                  churn=ChurnConfig(**churn) if churn else None, on_nonfinite="halt")
    ref = ref_dmf.fit(rcfg, ds.train, world["ref_nbr"], epochs=EPOCHS,
                      attack=ref_byz.AttackConfig(**run["attack"]),
                      defense=(ref_byz.DefenseConfig(**run["defense"]) if "defense" in run
                               else None),
                      churn=RefChurnConfig(**churn) if churn else None, on_nonfinite="halt")
    return request.param, got, ref


def test_attacked_fit_matches_the_reference(attacked):
    case, got, ref = attacked
    assert got.diverged_at == ref.diverged_at
    assert (got.diverged_at is None) == (case != "inflate_undefended")
    np.testing.assert_allclose(got.train_losses, ref.train_losses, rtol=LOSS_RTOL)
    for n in "UPQ":
        a, b = getattr(got.state, n).numpy(), np.asarray(getattr(ref.state, n))
        if case == "inflate_undefended":
            np.testing.assert_allclose(a, b, rtol=LOSS_RTOL, atol=STATE_ATOL, err_msg=n)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=STATE_ATOL, err_msg=n)
    assert got.privacy == ref.privacy


def test_defended_runs_hold_and_the_undefended_one_collapses(world, attacked):
    case, got, _ = attacked
    if case == "inflate_undefended":          # halted: the last finite state is kept
        base = dmf.fit(_configs(world["ds"])[0], world["ds"].train, world["nbr"], epochs=EPOCHS,
                       device="cpu").train_losses[-1]
        assert not np.isfinite(got.train_losses[-1]) and max(got.train_losses[:-1]) >= 5 * base
        for n in "UPQ":
            assert torch.isfinite(getattr(got.state, n)).all(), n
    else:
        assert np.isfinite(got.train_losses).all()
        for n in "UPQ":
            assert torch.isfinite(getattr(got.state, n)).all(), n


def test_nan_bomb_lands_without_screening(world):
    ds = world["ds"]
    cfg, _ = _configs(ds)
    und = dmf.fit(cfg, ds.train, world["nbr"], epochs=EPOCHS, device="cpu",
                  attack=AttackConfig(family="nan", frac=0.2, seed=5), on_nonfinite="halt")
    assert und.diverged_at is not None
    for n in "UPQ":
        assert torch.isfinite(getattr(und.state, n)).all()


def test_stale_malicious_ring_message_is_screened_at_delivery(world):
    """A straggler's NaN message buffered in the delay ring is screened
    when it lands: the defense sits at delivery too."""
    ds = world["ds"]
    cfg, _ = _configs(ds)
    cc = ChurnConfig(delay_classes=(0, 1, 2), seed=4)
    atk = AttackConfig(family="nan", frac=0.3, seed=5)
    und = dmf.fit(cfg, ds.train, world["nbr"], epochs=EPOCHS, churn=cc, attack=atk,
                  on_nonfinite="halt", device="cpu")
    assert und.diverged_at is not None
    dfd = dmf.fit(cfg, ds.train, world["nbr"], epochs=EPOCHS, churn=cc, attack=atk,
                  defense=DefenseConfig(screen=True), device="cpu")
    assert np.isfinite(dfd.train_losses).all()
    for n in "UPQ":
        assert torch.isfinite(getattr(dfd.state, n)).all(), n
    # the only delivery screen: with every learner a straggler, the fresh
    # path carries no neighbour messages, so only the ring can poison
    plan = ChurnConfig(delay_classes=(1,), seed=0).compile(ds.n_users, 3)
    got = dmf.fit(cfg, ds.train, world["nbr"], epochs=3, churn=plan, attack=atk,
                  defense=DefenseConfig(screen=True), device="cpu")
    assert np.isfinite(got.train_losses).all() and torch.isfinite(got.state.P).all()


def test_attack_without_a_defense_is_refused_by_the_epoch(world):
    ds = world["ds"]
    cfg, _ = _configs(ds)
    plan = AttackConfig(family="nan", frac=0.2).compile(ds.n_users, 1, 6)
    state = dmf.init_state(cfg, device="cpu")
    with pytest.raises(ValueError, match="DefenseConfig"):
        dmf.train_epoch_churn(state, world["nbr"], ds.train, cfg, np.random.default_rng(0), 0,
                              ChurnConfig().compile(ds.n_users, 1), None, attack=plan,
                              device="cpu")
    with pytest.raises(ValueError, match="target_item"):
        dmf.fit(cfg, ds.train, world["nbr"], epochs=1, device="cpu",
                attack=AttackConfig(family="shill", frac=0.2, target_item=ds.n_items))
