"""Run-to-run determinism of the port's accumulating scatters, and the
route choice of the walk-mixing product, on the CPU.

The reference's XLA scatters give the same bits on every run; the port's
`core.scatter.scatter_add_rows_` sums duplicate index tuples in a fixed
order on each device, so two runs from one seed give bitwise-equal
factors: one sparse step with many duplicate (receiver, item) pairs, a
2-epoch `fit` with DP off and on, an ingest round, and 2 epochs of
`fit_mf` and `fit_bpr`. (Parity with the reference, at its tolerances,
stays in the other `test_torch_*` files.) `gossip_mix_op`'s route choice
is pure host arithmetic: a nonzero count either side of the density
threshold, non-finite X to the dense route, small products dense without
a count.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import baselines, dmf, graph
from repro_torch.core.scatter import scatter_add_rows_
from repro_torch.data import synthetic_poi
from repro_torch.kernels import gossip_mix
from repro_torch.serving import online


@pytest.fixture(scope="module")
def world():
    ds = synthetic_poi.foursquare_like(reduced=True)
    gcfg = graph.GraphConfig(n_neighbors=2, walk_length=3)
    W = graph.build_adjacency(ds.user_coords, ds.user_city, gcfg)
    return dict(ds=ds, nbr=graph.walk_neighbor_table(W, gcfg, device="cpu"))


def _same_state(a, b, names="UPQ"):
    for n in names:
        assert torch.equal(getattr(a, n), getattr(b, n)), f"{n} differs between two runs"


def test_scatter_add_rows_matches_index_put_sum():
    """The helper computes ``index_put_(accumulate=True)``'s sum (up to
    fp32 order), for one and for two index tensors that broadcast."""
    rng = np.random.default_rng(0)
    P = torch.as_tensor(rng.normal(size=(30, 20, 4)).astype(np.float32))
    rows = torch.as_tensor(rng.integers(0, 5, (64, 3)))
    cols = torch.as_tensor(rng.integers(0, 3, 64))[:, None].expand(64, 3)
    upd = torch.as_tensor(rng.normal(size=(64, 3, 4)).astype(np.float32))
    want = P.double().index_put_((rows, cols), upd.double(), accumulate=True)
    got = scatter_add_rows_(P.clone(), (rows, cols), upd)
    torch.testing.assert_close(got.double(), want, rtol=0, atol=1e-5)
    U = torch.zeros(10, 4)
    ui = torch.tensor([3, 3, 3, 1])
    scatter_add_rows_(U, (ui,), torch.ones(4, 4))
    assert U[3].tolist() == [3.0] * 4 and U[1].tolist() == [1.0] * 4 and U.sum() == 16


@pytest.mark.parametrize("dp", [False, True])
def test_sparse_step_with_duplicate_pairs_same_bits_twice(world, dp):
    ds, nbr = world["ds"], world["nbr"]
    kw = dict(dp_sigma=1.0, dp_clip=0.5) if dp else {}
    cfg = dmf.DMFConfig(n_users=ds.n_users, n_items=ds.n_items, **kw)
    rng = np.random.default_rng(3)
    B = 256
    ui = torch.as_tensor(rng.integers(0, 6, B))       # 6 senders, 4 items: many repeats
    vj = torch.as_tensor(rng.integers(0, 4, B))
    r = torch.as_tensor((rng.random(B) < 0.3).astype(np.float32))
    conf = torch.ones(B)
    rid = torch.arange(B, dtype=torch.int32)
    runs = []
    for _ in range(2):
        st = dmf.init_state(cfg, np.random.default_rng(1), device="cpu")
        st.P.normal_(generator=torch.Generator().manual_seed(2))
        dmf._sparse_batch_update(st.U, st.P, st.Q, nbr.idx, nbr.wgt, ui, vj, r, conf, cfg,
                                 rid=rid, dp_seed=7)
        runs.append(st)
    _same_state(*runs)


@pytest.mark.parametrize("dp", [False, True])
def test_fit_two_epochs_same_bits_twice(world, dp):
    ds, nbr = world["ds"], world["nbr"]
    kw = dict(dp_sigma=1.0, dp_clip=0.5, dp_seed=3) if dp else {}
    cfg = dmf.DMFConfig(n_users=ds.n_users, n_items=ds.n_items, beta=0.1, **kw)
    a, b = (dmf.fit(cfg, ds.train, nbr, epochs=2, device="cpu") for _ in range(2))
    assert a.train_losses == b.train_losses
    _same_state(a.state, b.state)


def test_ingest_round_same_bits_twice(world):
    ds, nbr = world["ds"], world["nbr"]
    cfg = dmf.DMFConfig(n_users=ds.n_users, n_items=ds.n_items, beta=0.1)
    base = dmf.fit(cfg, ds.train, nbr, epochs=1, device="cpu").state
    runs = []
    for _ in range(2):
        st = dmf.DMFState(*(x.clone() for x in (base.U, base.P, base.Q)))
        out, report = online.online_refresh(st, nbr, ds.test, cfg, online.OnlineConfig(steps=2),
                                            np.random.default_rng(5))
        runs.append((out, report.losses))
    _same_state(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("model", ["mf", "bpr"])
def test_baselines_two_epochs_same_bits_twice(world, model):
    ds = world["ds"]
    common = dict(n_users=ds.n_users, n_items=ds.n_items)
    cfg, fit = ((baselines.MFConfig(**common), baselines.fit_mf) if model == "mf"
                else (baselines.BPRConfig(**common), baselines.fit_bpr))
    (sa, la), (sb, lb) = (fit(cfg, ds.train, epochs=2, device="cpu") for _ in range(2))
    assert la == lb
    _same_state(sa, sb, "UV")


WALK_I, WALK_F, WALK_NNZ = 6524, 31970, 60374     # the Foursquare walk matrix x every P


@pytest.mark.parametrize("nnz,x_finite,route", [
    (WALK_NNZ, True, "sparse"),
    (WALK_I * WALK_I // 16, True, "sparse"),       # at the threshold
    (WALK_I * WALK_I // 16 + 1, True, "dense"),    # just above it
    (WALK_I * WALK_I, True, "dense"),
    (WALK_NNZ, False, "dense"),                    # 0·Inf is NaN in the plain product
    (0, False, "dense"),
])
def test_gossip_mix_route_choice(nnz, x_finite, route):
    assert gossip_mix.counts_needed(WALK_I, WALK_F)
    assert gossip_mix.mix_route(WALK_I, nnz, x_finite) == route


@pytest.mark.parametrize("I,F,needed", [(512, 1024, False), (128, 128, False),
                                        (2048, 300, True), (WALK_I, 10, False),
                                        (WALK_I, 20, True)])
def test_gossip_mix_small_products_skip_the_count(I, F, needed):
    assert gossip_mix.counts_needed(I, F) is needed


def test_gossip_mix_cpu_path_is_the_plain_product_whatever_the_route():
    """On the CPU the wrapper runs the plain product: NaN where X is
    non-finite and M's weight is 0, as the dense route gives on the card."""
    M = torch.tensor([[1.0, 0.0], [0.0, 0.5]])
    X = torch.tensor([[1.0, 2.0], [float("inf"), 3.0]])
    Y = gossip_mix.gossip_mix_op(M, X)
    assert torch.isnan(Y[0, 0]) and Y[0, 1] == 2.0 and Y[1, 0] == float("inf")
