"""The training slice end to end: the port's `fit`, `train_epoch`,
`evaluate` and `dmf_train` CLI against the reference's, on the CPU, on the
reduced Foursquare data.

Both packages get the same data, neighbor table and seeds, so they draw
the same initial U, the same sampled epochs and the same DP seeds. The
reference runs its Pallas kernels in interpret mode
(`DMFConfig(use_pallas=True)`, the path the port's fused step follows);
the port runs its kernels' plain versions.

Tolerances (the DESIGN.md §5 bar over 5 epochs): losses within 1e-4
relative, U/P/Q within 1e-5 absolute — the P scatter sums duplicate
(receiver, item) pairs in another order than XLA's, and with DP the draws
differ by up to one fp32 ulp of log/cos. The `privacy` summary is equal
(the same numpy arithmetic on the same stream). Ranking metrics are equal
to the reference's `evaluate_dense` (its `lax.top_k` oracle: the port's
kernel keeps the lowest-id tie order, which the reference's Pallas merge
does not across tiles, ROADMAP §C), and chunked `evaluate` equals
unchunked exactly.
"""
import json
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import dmf as ref_dmf  # noqa: E402
from repro.core import graph as ref_graph  # noqa: E402
from repro.core import metrics as ref_metrics  # noqa: E402
from repro.data import synthetic_poi as ref_poi  # noqa: E402
from repro.launch import dmf_train as ref_cli  # noqa: E402
from repro.privacy import GaussianAccountant as RefAccountant  # noqa: E402
from repro_torch.configs import dmf_alipay, dmf_foursquare  # noqa: E402
from repro_torch.core import dmf, graph, metrics  # noqa: E402
from repro_torch.launch import dmf_train  # noqa: E402
from repro_torch.privacy import GaussianAccountant  # noqa: E402

EPOCHS = 5
HYPER = dict(beta=0.1, gamma=0.01)


@pytest.fixture(scope="module")
def world():
    ds = ref_poi.foursquare_like(reduced=True)
    gcfg = ref_graph.GraphConfig(n_neighbors=2, walk_length=3)
    W = ref_graph.build_adjacency(ds.user_coords, ds.user_city, gcfg)
    pgcfg = graph.GraphConfig(n_neighbors=2, walk_length=3)
    pW = graph.build_adjacency(ds.user_coords, ds.user_city, pgcfg)
    return dict(ds=ds, W=W, ref_nbr=ref_graph.walk_neighbor_table(W, gcfg),
                nbr=graph.walk_neighbor_table(pW, pgcfg, device="cpu"),
                M=graph.walk_propagation_matrix(pW, pgcfg))


def _configs(ds, **kw):
    common = dict(n_users=ds.n_users, n_items=ds.n_items, **HYPER, **kw)
    return dmf.DMFConfig(**common), ref_dmf.DMFConfig(use_pallas=True, **common)


def _assert_states(state, ref_state, atol=1e-5):
    for a, b in zip((state.U, state.P, state.Q), (ref_state.U, ref_state.P, ref_state.Q)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=atol)


CASES = {"dmf": dict(), "gdmf": dict(mode="gdmf"), "ldmf": dict(mode="ldmf"),
         "dmf_dp": dict(dp_sigma=1.0, dp_clip=0.5, dp_seed=3),
         "dmf_clip_only": dict(dp_clip=0.25)}


@pytest.fixture(scope="module", params=list(CASES))
def fits(request, world):
    ds = world["ds"]
    cfg, rcfg = _configs(ds, **CASES[request.param])
    ref = ref_dmf.fit(rcfg, ds.train, world["ref_nbr"], epochs=EPOCHS, test=ds.test)
    got = dmf.fit(cfg, ds.train, world["nbr"], epochs=EPOCHS, test=ds.test, device="cpu")
    return dict(case=request.param, cfg=cfg, got=got, ref=ref)


def test_fit_matches_reference(world, fits):
    got, ref = fits["got"], fits["ref"]
    np.testing.assert_allclose(got.train_losses, ref.train_losses, rtol=1e-4)
    np.testing.assert_allclose(got.test_losses, ref.test_losses, rtol=1e-4)
    _assert_states(got.state, ref.state)
    assert got.train_losses[-1] < got.train_losses[0]
    assert got.diverged_at is None and ref.diverged_at is None


def test_fit_privacy_summary_equals_reference(fits):
    got, ref = fits["got"].privacy, fits["ref"].privacy
    if fits["case"] == "dmf_dp":
        assert got == ref and got["epochs"] == EPOCHS and got["eps_max"] > 0
    else:
        assert got is None and ref is None       # no noise: no ε claim


def test_evaluate_matches_reference_dense_oracle_and_chunks(world, fits):
    ds = world["ds"]
    st = fits["got"].state
    args = (ds.train, ds.test, ds.n_users, ds.n_items)
    got = dmf.evaluate(st, *args, device="cpu")
    ref_state = ref_dmf.DMFState(*(jnp.asarray(x.numpy()) for x in (st.U, st.P, st.Q)))
    assert got == ref_dmf.evaluate_dense(ref_state, *args)
    assert got == dmf.evaluate_dense(st, *args, device="cpu")
    for chunk in (1, 77, ds.n_users, 10 * ds.n_users):
        assert dmf.evaluate(st, *args, chunk_users=chunk, device="cpu") == got
    ks = (1, 3, 16)
    assert (dmf.evaluate(st, *args, ks=ks, device="cpu")
            == ref_dmf.evaluate_dense(ref_state, *args, ks=ks))


def test_topk_recommend_matches_reference_with_ties(world):
    ds = world["ds"]
    rng = np.random.default_rng(2)
    sc = rng.normal(size=(ds.n_users, ds.n_items)).astype(np.float32)
    sc[:, ::3] = 0.0                             # exact ties
    sc[5] = 0.0
    train_mask = metrics.masks_from_interactions(ds.n_users, ds.n_items, ds.train)
    train_mask[7] = True                         # all seen: -inf ties everywhere
    got = metrics.topk_recommend(sc, train_mask, 10).numpy()
    expect = np.asarray(ref_metrics.topk_recommend(jnp.asarray(sc), jnp.asarray(train_mask), 10))
    np.testing.assert_array_equal(got, expect)
    test_mask = metrics.masks_from_interactions(ds.n_users, ds.n_items, ds.test)
    assert (metrics.evaluate_ranking(sc, train_mask, test_mask)
            == ref_metrics.evaluate_ranking(sc, train_mask, test_mask))
    for s in (0, 123):
        np.testing.assert_array_equal(
            metrics.masks_from_interactions_rows(s, 50, ds.n_items, ds.train),
            ref_metrics.masks_from_interactions_rows(s, 50, ds.n_items, ds.train))


def test_dense_reference_matches_sparse_path_and_reference_oracle(world):
    ds = world["ds"]
    cfg, _ = _configs(ds)
    sparse = dmf.fit(cfg, ds.train, world["nbr"], epochs=3, device="cpu")
    dense = dmf.fit(cfg, ds.train, world["M"], epochs=3, dense_reference=True, device="cpu")
    np.testing.assert_allclose(dense.train_losses, sparse.train_losses, rtol=1e-5)
    _assert_states(dense.state, sparse.state)
    ref = ref_dmf.fit(ref_dmf.DMFConfig(n_users=ds.n_users, n_items=ds.n_items, **HYPER),
                      ds.train, np.asarray(world["M"]), epochs=3, dense_reference=True)
    np.testing.assert_allclose(dense.train_losses, ref.train_losses, rtol=1e-5)
    _assert_states(dense.state, ref.state)
    with pytest.raises(ValueError):
        dmf.fit(cfg, ds.train, world["nbr"], epochs=1, dense_reference=True, device="cpu")
    cfg_dp, _ = _configs(ds, dp_clip=0.5)
    with pytest.raises(ValueError):
        dmf.fit(cfg_dp, ds.train, world["M"], epochs=1, dense_reference=True, device="cpu")


def test_train_epoch_takes_a_dense_matrix_and_the_accountant(world):
    ds = world["ds"]
    cfg, rcfg = _configs(ds, dp_sigma=0.7, dp_clip=0.5)
    acc = GaussianAccountant(n_users=ds.n_users, sigma=0.7)
    st = dmf.init_state(cfg, np.random.default_rng(0), device="cpu")
    st, loss = dmf.train_epoch(st, world["M"], ds.train, cfg, np.random.default_rng(1),
                               accountant=acc, device="cpu")
    ref_acc = RefAccountant(n_users=ds.n_users, sigma=0.7)
    rst = ref_dmf.init_state(rcfg, np.random.default_rng(0))
    rst, rloss = ref_dmf.train_epoch(rst, world["ref_nbr"], ds.train, rcfg,
                                     np.random.default_rng(1), accountant=ref_acc)
    np.testing.assert_allclose(loss, rloss, rtol=1e-5)
    _assert_states(st, rst)
    assert acc.summary() == ref_acc.summary()


def _diverging(ds):
    cfg = dmf.DMFConfig(n_users=ds.n_users, n_items=ds.n_items, dim=6, batch_size=64,
                        lr=5.0, dp_sigma=40.0, dp_clip=25.0, dp_seed=3, **HYPER)
    return cfg


def test_on_nonfinite_raise_halt_and_warn(world):
    ds = world["ds"]
    cfg = _diverging(ds)
    halted = dmf.fit(cfg, ds.train, world["nbr"], epochs=12, on_nonfinite="halt",
                     device="cpu")
    assert halted.diverged_at is not None
    assert len(halted.train_losses) == halted.diverged_at + 1
    assert not np.isfinite(halted.train_losses[-1])
    for x in (halted.state.U, halted.state.P, halted.state.Q):
        assert torch.isfinite(x).all()
    # the halted state is the one before the diverged epoch
    before = dmf.fit(cfg, ds.train, world["nbr"], epochs=halted.diverged_at, device="cpu")
    for a, b in zip((halted.state.U, halted.state.P), (before.state.U, before.state.P)):
        assert torch.equal(a, b)
    with pytest.raises(dmf.DivergenceError):
        dmf.fit(cfg, ds.train, world["nbr"], epochs=12, on_nonfinite="raise", device="cpu")
    with pytest.warns(RuntimeWarning, match="non-finite"):
        dmf.fit(cfg, ds.train, world["nbr"], epochs=12, on_nonfinite="warn", device="cpu")
    with pytest.raises(ValueError):
        dmf.fit(cfg, ds.train, world["nbr"], epochs=1, on_nonfinite="explode", device="cpu")
    ref = ref_dmf.fit(ref_dmf.DMFConfig(**{f: getattr(cfg, f) for f in (
        "n_users", "n_items", "dim", "batch_size", "lr", "dp_sigma", "dp_clip", "dp_seed",
        "beta", "gamma")}), ds.train, world["ref_nbr"], epochs=12, on_nonfinite="halt")
    assert ref.diverged_at == halted.diverged_at


def test_fit_callback_log_every_and_seed(world, caplog):
    ds = world["ds"]
    cfg, rcfg = _configs(ds, dp_sigma=1.0, dp_clip=0.5)
    seen = []
    with caplog.at_level("INFO", logger="repro_torch.dmf"):
        got = dmf.fit(cfg, ds.train, world["nbr"], epochs=4, test=ds.test, seed=9,
                      log_every=2, callback=lambda t, st, l: seen.append((t, l)),
                      device="cpu")
    assert [t for t, _ in seen] == [0, 1, 2, 3]
    assert [l for _, l in seen] == got.train_losses
    lines = [r.getMessage() for r in caplog.records if r.name == "repro_torch.dmf"]
    assert len(lines) == 2 and lines[-1].startswith("epoch 4/4") and "eps=" in lines[-1]
    ref = ref_dmf.fit(rcfg, ds.train, world["ref_nbr"], epochs=4, seed=9)
    np.testing.assert_allclose(got.train_losses, ref.train_losses, rtol=1e-4)


def test_graph_helpers_and_configs_match_reference(world):
    W = world["W"]
    np.testing.assert_array_equal(graph.neighbor_counts(W, 3),
                                  ref_graph.neighbor_counts(W, 3))
    assert (graph.communication_bytes(W, D=3, K=10, n_ratings=661)
            == ref_graph.communication_bytes(W, D=3, K=10, n_ratings=661))
    from repro.configs import dmf_alipay as ref_alipay
    assert dmf_alipay.GRAPH == graph.GraphConfig(**vars(ref_alipay.GRAPH))
    assert dmf_alipay.DATASET == ref_alipay.DATASET
    assert dmf_alipay.dmf_config is dmf_foursquare.dmf_config


def _lines(text):
    return [ln for ln in text.splitlines() if ln.strip()]


@pytest.mark.parametrize("argv", [["--epochs", "2", "--dp-sigma", "1", "--dp-clip", "0.5"],
                                  ["--epochs", "11", "--mode", "gdmf"],
                                  ["--epochs", "2", "--dp-epsilon", "50", "--dataset", "alipay"]],
                         ids=["dp", "gdmf", "eps_target"])
def test_cli_prints_the_reference_report(argv, capsys, monkeypatch):
    got = dmf_train.main(argv + ["--device", "cpu"])
    out = _lines(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["dmf_train", *argv, "--use-pallas"])
    ref_cli.main()
    expect = _lines(capsys.readouterr().out)
    assert len(out) == len(expect)
    for a, b in zip(out, expect):
        if a.startswith("{"):                        # the final P@k/R@k line
            ja, jb = json.loads(a), json.loads(b)
            assert ja.keys() == jb.keys() == got.keys()
            np.testing.assert_allclose([ja[k] for k in ja], [jb[k] for k in jb], atol=1e-4)
        elif a.startswith("privacy "):
            assert json.loads(a[8:]) == json.loads(b[8:])
        elif a.startswith("epoch "):
            assert a.split()[:3] == b.split()[:3]
            assert abs(float(a.split()[3]) - float(b.split()[3])) <= 1e-4
        else:                                        # dataset / dp-target lines
            assert a == b


def test_cli_rejects_flags_of_later_slices():
    # --n-shards is ported (tests/test_torch_sharded.py); a width below 1
    # and an unknown backend are refused, as --use-pallas still is
    for flag in (["--use-pallas"], ["--n-shards", "0"], ["--n-shards", "2", "--dist-backend",
                                                          "mpi"]):
        with pytest.raises(SystemExit):
            dmf_train.main(flag + ["--device", "cpu"])


ROBUST_ARGV = {
    "churn": ["--epochs", "3", "--dp-sigma", "0.5", "--dp-clip", "0.25", "--churn-dropout",
              "0.2", "--churn-delay", "2", "--churn-late-frac", "0.1", "--churn-seed", "3"],
    "byzantine": ["--epochs", "3", "--dp-sigma", "0.5", "--dp-clip", "0.25", "--byz-family",
                  "norm_inflate", "--byz-frac", "0.2", "--byz-scale", "50", "--screen",
                  "--norm-cap", "0", "--aggregation", "trim", "--trim-frac", "0.25"],
    "checkpoint": ["--epochs", "3", "--dp-sigma", "0.5", "--dp-clip", "0.25", "--churn-dropout",
                   "0.2", "--churn-delay", "1", "--screen", "--aggregation", "median"],
}


def _assert_reports_match(out, expect):
    assert len(out) == len(expect)
    for a, b in zip(out, expect):
        if a.startswith("{"):
            ja, jb = json.loads(a), json.loads(b)
            assert ja.keys() == jb.keys()
            np.testing.assert_allclose([ja[k] for k in ja], [jb[k] for k in jb], atol=1e-4)
        elif a.startswith("privacy "):
            assert json.loads(a[8:]) == json.loads(b[8:])
        elif a.startswith("epoch "):
            assert a.split()[:3] == b.split()[:3]
            assert abs(float(a.split()[3]) - float(b.split()[3])) <= 1e-4
        else:                        # churn / byzantine / tau / dataset lines
            assert a == b


@pytest.mark.parametrize("case", list(ROBUST_ARGV))
def test_cli_prints_the_reference_report_for_robustness_flags(case, capsys, monkeypatch,
                                                              tmp_path):
    argv = ROBUST_ARGV[case]
    if case == "checkpoint":         # snapshot every epoch, then resume from step_2
        dmf_train.main(argv + ["--checkpoint-dir", str(tmp_path / "port"),
                               "--checkpoint-every", "1", "--device", "cpu"])
        whole = _lines(capsys.readouterr().out)
        assert sorted(p.name for p in (tmp_path / "port").iterdir()) == [
            "step_1", "step_2", "step_3"]
        argv = argv + ["--resume-from", str(tmp_path / "port" / "step_2")]
    dmf_train.main(argv + ["--device", "cpu"])
    out = _lines(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["dmf_train", *argv])
    ref_cli.main()
    expect = _lines(capsys.readouterr().out)
    _assert_reports_match(out, expect)
    assert out[0].startswith("churn " if case != "byzantine" else "byzantine ")
    if case == "checkpoint":         # the resumed run ends as the whole run did
        assert [ln for ln in out if not ln.startswith("epoch ")] == [
            ln for ln in whole if not ln.startswith("epoch ")]
