"""The port's DP mechanism (`repro_torch.privacy`, the noise stream, the DP
kernels' plain versions, the DP step and the DP online refresh) against
the reference's, on the CPU.

The same numpy inputs, from fixed seeds, go through both packages. The
reference runs its Pallas kernels in interpret mode (`ops.*(interpret=True)`,
`DMFConfig(use_pallas=True)`); the port runs its kernels' plain versions,
which is what its wrappers run on CPU tensors. Tolerances:

* mechanism and accountant: exact (the same numpy arithmetic);
* the noise stream: hash words exact; draws within 1e-6 absolute — about
  one draw in ten differs by one ulp of fp32 log/cos between PyTorch's and
  XLA's CPU libraries (at most 4.8e-7);
* clip + noise and the fused DP step: 1e-6 absolute (the row norm and the
  sums over K in another order, and the draws' ulp); batch loss 1e-5
  relative; the disabled mechanism (clip=inf, noise 0) bit for bit;
* the DP online refresh: losses 1e-5 relative, U/P/Q 1e-5 absolute (the P
  scatter sums duplicate (receiver, item) pairs in another order than
  XLA's).
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import dmf as ref_dmf  # noqa: E402
from repro.core import graph as ref_graph  # noqa: E402
from repro.data import synthetic_poi as ref_poi  # noqa: E402
from repro.kernels import dp_noise as ref_dp_noise  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.privacy import accountant as ref_accountant  # noqa: E402
from repro.privacy import mechanism as ref_mechanism  # noqa: E402
from repro.serving import OnlineConfig as RefOnlineConfig  # noqa: E402
from repro.serving import online as ref_online  # noqa: E402
from repro_torch import privacy  # noqa: E402
from repro_torch.core import dmf, graph  # noqa: E402
from repro_torch.kernels import dp_noise, ops, ref  # noqa: E402
from repro_torch.privacy import accountant, mechanism  # noqa: E402
from repro_torch.serving import OnlineConfig, online  # noqa: E402

INF = float("inf")
K = 10
HP = dict(theta=0.1, alpha=0.1, beta=0.1, gamma=0.01)


def _t(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


# --------------------------------------------------------------- config
def test_config_carries_dp_seed_and_refuses_noise_without_a_finite_clip():
    cfg = dmf.DMFConfig(n_users=4, n_items=3, dp_sigma=1.0, dp_clip=0.5, dp_seed=9)
    assert cfg.dp_seed == 9 and cfg.dp
    with pytest.raises(ValueError, match="finite dp_clip"):
        dmf.DMFConfig(n_users=4, n_items=3, dp_sigma=1.0)
    with pytest.raises(AssertionError):         # the reference refuses it too
        ref_dmf.DMFConfig(n_users=4, n_items=3, dp_sigma=1.0)
    with pytest.raises(ValueError):
        dmf.DMFConfig(n_users=4, n_items=3, dp_clip=0.0)
    # clip only is DP; ldmf exchanges nothing, so its DP params are inert
    assert dmf.DMFConfig(n_users=4, n_items=3, dp_clip=1.0).dp
    assert not dmf.DMFConfig(n_users=4, n_items=3, dp_clip=1.0, dp_sigma=2.0, mode="ldmf").dp
    assert not dmf.DMFConfig(n_users=4, n_items=3).dp


# ------------------------------------------------------------ mechanism
@pytest.mark.parametrize("sigma,clip,dp_seed", [(0.0, INF, 0), (0.0, 0.25, 3),
                                                (1.0, 0.5, 0), (40.0, 25.0, 2**31 - 1)])
def test_mechanism_equals_reference(sigma, clip, dp_seed):
    kw = dict(n_users=5, n_items=4, dp_sigma=sigma, dp_clip=clip, dp_seed=dp_seed)
    cfg, rcfg = dmf.DMFConfig(**kw), ref_dmf.DMFConfig(**kw)
    assert mechanism.dp_enabled(cfg) == ref_mechanism.dp_enabled(rcfg) == cfg.dp == rcfg.dp
    assert mechanism.noise_std(cfg) == ref_mechanism.noise_std(rcfg)
    for dim, p in ((10, 1e-6), (6, 1e-3)):
        assert (mechanism.screening_threshold(cfg, dim, p)
                == ref_mechanism.screening_threshold(rcfg, dim, p))
    a, b = np.random.default_rng(11), np.random.default_rng(11)
    seeds = [mechanism.epoch_noise_seed(a, cfg) for _ in range(5)]
    assert seeds == [ref_mechanism.epoch_noise_seed(b, rcfg) for _ in range(5)]
    assert all(0 <= s < 2**31 for s in seeds)


def test_package_exports_the_reference_names():
    for name in ("GaussianAccountant", "rdp_subsampled_gaussian", "rdp_to_epsilon",
                 "sigma_for_epsilon", "dp_enabled", "epoch_noise_seed", "noise_std",
                 "screening_threshold"):
        assert callable(getattr(privacy, name)), name


# ----------------------------------------------------------- accountant
@pytest.mark.parametrize("q", [0.0, 0.01, 0.3, 1.0, np.array([0.0, 0.02, 0.5, 1.0])])
@pytest.mark.parametrize("sigma", [0.5, 1.0, 4.0])
def test_rdp_and_epsilon_equal_reference(q, sigma):
    got = accountant.rdp_subsampled_gaussian(q, sigma)
    expect = ref_accountant.rdp_subsampled_gaussian(q, sigma)
    np.testing.assert_array_equal(got, expect)
    for delta in (1e-5, 1e-3):
        for g, e in zip(accountant.rdp_to_epsilon(25 * got, delta=delta),
                        ref_accountant.rdp_to_epsilon(25 * expect, delta=delta)):
            np.testing.assert_array_equal(g, e)


@pytest.mark.parametrize("eps,q,steps,rows", [(2.0, 0.05, 400, 1.0), (8.0, 0.3, 1100, 3.5)])
def test_sigma_for_epsilon_equals_reference(eps, q, steps, rows):
    assert (accountant.sigma_for_epsilon(eps, q, steps, rows_per_step=rows)
            == ref_accountant.sigma_for_epsilon(eps, q, steps, rows_per_step=rows))
    with pytest.raises(ValueError):
        accountant.sigma_for_epsilon(1e-9, 1.0, 10**6)


def test_accountant_equals_reference_over_epochs():
    rng = np.random.default_rng(4)
    n_users = 40
    got = accountant.GaussianAccountant(n_users=n_users, sigma=0.8, delta=1e-5)
    expect = ref_accountant.GaussianAccountant(n_users=n_users, sigma=0.8, delta=1e-5)
    for epoch in range(3):
        ui = rng.integers(0, n_users - 5, (12, 16))    # the last users never release
        valid = rng.random((12, 16)) < 0.8 if epoch == 2 else None
        got.observe_epoch(ui, valid=valid)
        expect.observe_epoch(ui, valid=valid)
    assert got.summary() == expect.summary()
    for g, e in zip(got.epsilon(), expect.epsilon()):
        np.testing.assert_array_equal(g, e)
    np.testing.assert_array_equal(got.messages, expect.messages)


# ----------------------------------------------------------- noise stream
def _ref_words(seed, rid, n_cols):
    """The reference's two hash words, from its own `_mix32` and constants
    in the order its `gauss_counter` applies them."""
    B = len(rid)
    s = ref_dp_noise._mix32(jnp.asarray(seed).astype(jnp.uint32))
    col = jax.lax.broadcasted_iota(jnp.uint32, (B, n_cols), 1)
    r32 = jnp.asarray(rid).reshape(-1, 1).astype(jnp.uint32)
    s_row = ref_dp_noise._mix32(
        s ^ ((r32 >> np.uint32(23)) * ref_dp_noise._GOLDEN + np.uint32(1)))
    base = ((r32 & np.uint32(0x7FFFFF)) * np.uint32(ref_dp_noise._STRIDE)
            + col * np.uint32(2))
    h1 = ref_dp_noise._mix32(base ^ s_row)
    h2 = ref_dp_noise._mix32((base + np.uint32(1)) ^ (s_row * ref_dp_noise._GOLDEN))
    return np.asarray(h1).astype(np.int64), np.asarray(h2).astype(np.int64)


def _stream_rids():
    return np.concatenate([np.arange(0, 30_000), np.arange((1 << 23) - 300, (1 << 23) + 300),
                           [2**31 - 1, 3 << 23]]).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_gauss_counter_hash_words_exact_and_draws_match_reference(seed):
    rid = _stream_rids()
    h1, h2 = dp_noise.counter_words_ref(seed, torch.from_numpy(rid), K)
    e1, e2 = _ref_words(seed, rid, K)
    np.testing.assert_array_equal(h1.numpy(), e1)
    np.testing.assert_array_equal(h2.numpy(), e2)
    got = ops.gauss_counter(seed, torch.from_numpy(rid), K)
    assert torch.equal(got, dp_noise.gauss_counter_ref(seed, torch.from_numpy(rid), K))
    expect = np.asarray(ref_dp_noise.gauss_counter(seed, jnp.asarray(rid).reshape(-1, 1), K))
    np.testing.assert_allclose(got.numpy(), expect, rtol=0, atol=1e-6)
    assert np.isfinite(got.numpy()).all()
    # the stride is 2·KMAX, not 2·K: a wider block keeps the first K columns
    wide = dp_noise.gauss_counter_ref(seed, torch.from_numpy(rid[:64]), dp_noise.KMAX)
    assert torch.equal(wide[:, :K], got[:64])


def test_gauss_counter_rows_2_23_apart_draw_distinct_streams():
    rid = np.arange(512, dtype=np.int32)
    a = dp_noise.gauss_counter_ref(7, torch.from_numpy(rid), K)
    b = dp_noise.gauss_counter_ref(7, torch.from_numpy(rid + (1 << 23)), K)
    assert not torch.isclose(a, b).any()


@pytest.mark.parametrize("B", [256, 100, 1])
@pytest.mark.parametrize("clip,std", [(INF, 0.0), (0.5, 0.0), (0.5, 0.7), (1e-3, 1.0),
                                      (INF, 0.3)])
def test_dp_clip_noise_plain_matches_reference_kernel(B, clip, std):
    rng = np.random.default_rng(B)
    g = rng.normal(size=(B, K)).astype(np.float32)
    g[0] = 0.0                                   # zero-norm row: scale 1
    rid = ((1 << 23) - B // 2 + np.arange(B)).astype(np.int32)
    got = ops.dp_clip_noise(*_t(g, rid), 11, clip=clip, noise_std=std)
    expect = ref_ops.dp_clip_noise(jnp.asarray(g), jnp.asarray(rid), 11, clip=clip,
                                   noise_std=std, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=0, atol=1e-6)
    if clip == INF and std == 0.0:
        assert torch.equal(got, torch.from_numpy(g))     # disabled: bit for bit
    if std == 0.0:
        norms = torch.linalg.vector_norm(got, dim=1)
        assert (norms <= clip * (1 + 1e-6)).all()


@pytest.mark.parametrize("B", [256, 100])
@pytest.mark.parametrize("clip", [INF, 0.5, 1e-3])
@pytest.mark.parametrize("zs", [0.0, 0.5])
def test_dmf_fused_step_dp_plain_matches_reference_kernel(B, clip, zs):
    rng = np.random.default_rng(B + 1)
    u, p, q = (rng.normal(0, 0.5, (B, K)).astype(np.float32) for _ in range(3))
    u[0] = p[0] = 0.0                            # a zero-norm message row
    r = (rng.random(B) < 0.25).astype(np.float32)
    conf = np.where(r > 0, 1.0, 1.0 / 3).astype(np.float32)
    z = (zs * rng.normal(size=(B, K))).astype(np.float32)
    expect = ref_ops.dmf_fused_step_dp(*map(jnp.asarray, (u, p, q, r, conf, z)), **HP,
                                       clip=clip, interpret=True)
    got = ops.dmf_fused_step_dp(*_t(u, p, q, r, conf, z), **HP, clip=clip)
    for g, e in zip(got[:3], expect[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(got[3]), float(expect[3]), rtol=1e-5)
    # the step itself is kernel 3's; the message is its gp clipped, plus z
    plain = ops.dmf_fused_step(*_t(u, p, q, r, conf), **HP)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[2], plain[2])
    clipped = ref.dp_clip_noise_ref(plain[1], torch.zeros(B, dtype=torch.int32), 0, clip, 0.0)
    assert torch.equal(got[1], clipped + torch.from_numpy(z))


# -------------------------------------------------------------- DP step
def _step_world(B=64, I=30, J=20):
    rng = np.random.default_rng(3)
    U = rng.normal(0, 0.5, (I, K)).astype(np.float32)
    P = rng.normal(0, 0.3, (I, J, K)).astype(np.float32)
    Q = rng.normal(0, 0.3, (I, J, K)).astype(np.float32)
    ui = rng.integers(0, I, B)
    vj = rng.integers(0, J, B)
    r = (rng.random(B) < 0.3).astype(np.float32)
    conf = np.where(r > 0, 1.0, 1 / 3).astype(np.float32)
    valid = (np.arange(B) < B - 9).astype(np.float32)
    conf = conf * valid
    return U, P, Q, ui, vj, r, conf, valid


def test_dp_step_routes_agree_and_mask_padded_rows():
    """The epoch's route (noise block into kernel 7) and the refresh's
    (kernel 3, then kernel 8 drawing from the rows' ids) give the same
    message; padded rows release nothing."""
    U, P, Q, ui, vj, r, conf, valid = _step_world()
    cfg = dmf.DMFConfig(n_users=30, n_items=20, dim=K, beta=0.1, dp_sigma=1.0, dp_clip=0.5)
    st = dmf.state_from_numpy(U, P, Q, device="cpu")
    ui_t, vj_t = torch.as_tensor(ui), torch.as_tensor(vj)
    rid = torch.arange(100, 100 + len(ui), dtype=torch.int32)
    args = (st.U, st.P, st.Q, ui_t, vj_t, *_t(r, conf), cfg, torch.from_numpy(valid))
    block = dmf._dp_noise_rows(rid, 5, cfg, K)
    fused = dmf._step_deltas_dp(*args, noise=block)
    split = dmf._step_deltas_dp(*args, rid=rid, dp_seed=5)
    for a, b in zip(fused, split):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    pad = valid == 0
    assert (fused[1][pad] == 0).all() and (split[1][pad] == 0).all()
    assert (fused[1][~pad].abs() > 0).any()
    with pytest.raises(ValueError):
        dmf._step_deltas_dp(*args)
    # the reference's jnp path: `_step_deltas` then `_dp_message` on the block
    rcfg = ref_dmf.DMFConfig(n_users=30, n_items=20, dim=K, beta=0.1, dp_sigma=1.0, dp_clip=0.5)
    expect = ref_dmf._step_deltas_dp(
        jnp.asarray(U), jnp.asarray(P), jnp.asarray(Q), jnp.asarray(ui), jnp.asarray(vj),
        jnp.asarray(r), jnp.asarray(conf), rcfg, jnp.asarray(valid),
        jnp.asarray(block.numpy()))
    for a, b in zip(fused, expect):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------- online refresh
@pytest.fixture(scope="module")
def world():
    ds = ref_poi.foursquare_like(reduced=True)
    gcfg = ref_graph.GraphConfig(n_neighbors=2, walk_length=3)
    W = ref_graph.build_adjacency(ds.user_coords, ds.user_city, gcfg)
    ref_nbr = ref_graph.walk_neighbor_table(W, gcfg)
    pgcfg = graph.GraphConfig(n_neighbors=2, walk_length=3)
    nbr = graph.walk_neighbor_table(
        graph.build_adjacency(ds.user_coords, ds.user_city, pgcfg), pgcfg, device="cpu")
    kw = dict(n_users=ds.n_users, n_items=ds.n_items, dim=K, beta=0.1, gamma=0.01,
              batch_size=128)
    st = ref_dmf.fit(ref_dmf.DMFConfig(**kw), ds.train, ref_nbr, epochs=2).state
    return dict(ds=ds, ref_nbr=ref_nbr, nbr=nbr, kw=kw,
                state=tuple(np.asarray(x) for x in (st.U, st.P, st.Q)))


@pytest.mark.parametrize("sigma,clip", [(1.0, 0.5), (0.0, 0.25)])
def test_dp_online_refresh_matches_reference(world, sigma, clip):
    ds = world["ds"]
    kw = dict(world["kw"], dp_sigma=sigma, dp_clip=clip, dp_seed=3)
    U, P, Q = world["state"]
    events = ds.test[:150]
    ocfg = dict(batch_cap=128, steps=3, neg_samples=3)
    ref_out, ref_report = ref_online.online_refresh(
        ref_dmf.DMFState(*(jnp.array(x) for x in (U, P, Q))), world["ref_nbr"], events,
        ref_dmf.DMFConfig(use_pallas=True, **kw), RefOnlineConfig(**ocfg),
        np.random.default_rng(5))
    state = dmf.state_from_numpy(U, P, Q, device="cpu")
    out, report = online.online_refresh(state, world["nbr"], events, dmf.DMFConfig(**kw),
                                        OnlineConfig(**ocfg), np.random.default_rng(5))
    assert out.U is state.U                          # updated in place
    assert report.n_batches == ref_report.n_batches > 3
    np.testing.assert_array_equal(report.touched_users, ref_report.touched_users)
    np.testing.assert_allclose(report.losses, ref_report.losses, rtol=1e-5)
    for a, b in zip((out.U, out.P, out.Q), (ref_out.U, ref_out.P, ref_out.Q)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    # locality holds under DP: untouched users' rows are bit-identical
    untouched = np.setdiff1d(np.arange(ds.n_users), report.touched_users)
    assert torch.equal(out.P[untouched], torch.from_numpy(P[untouched]))


def test_dp_online_refresh_needs_a_persistent_rng(world):
    ds = world["ds"]
    cfg = dmf.DMFConfig(**dict(world["kw"], dp_sigma=1.0, dp_clip=0.5))
    state = dmf.state_from_numpy(*world["state"], device="cpu")
    with pytest.raises(ValueError, match="persistent rng"):
        online.online_refresh(state, world["nbr"], ds.test[:10], cfg)
    # DP off draws no mechanism seed: the rng stream is the sampler's alone
    off = dataclasses.replace(cfg, dp_sigma=0.0, dp_clip=INF)
    a, b = np.random.default_rng(1), np.random.default_rng(1)
    online.online_refresh(state, world["nbr"], ds.test[:10], off, OnlineConfig(steps=1), a)
    dmf.sample_with_negatives(ds.test[:10], off.n_items, 3, b)
    assert a.integers(1 << 30) == b.integers(1 << 30)
