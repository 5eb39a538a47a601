"""The leakage audit (`repro_torch.privacy.audit`) and the checkpoint format
(`repro_torch.checkpoint.ckpt`, `robustness.recovery`) against the
reference's, on the CPU, on the reference tests' small world (80 users, 50
items, 600 ratings, K=6, B=64).

Tolerances:

* `observe_messages`: the sender, item, rating and confidence columns
  exactly; the messages within 1e-6 absolute + 1e-6 relative, DP off and
  on (the P scatter's fp32 sum order; with DP the draws' ulp of log/cos);
* `run_audit`: the attack advantages within 0.02 absolute (they are AUCs
  over 704 messages whose scores may differ by the messages' 1e-6, so a
  near-tie can flip; the largest difference seen was 0.0, at σ 0 and 1);
  `n_messages`, `dp_clip` and `dp_sigma` equal;
* the attacks and `screening_report` on one log: equal (the same numpy);
* checkpoints: leaves bit for bit, manifests equal between the packages
  (files, shapes, dtypes, raw flags and sha256s);
* a reference snapshot resumed in the port's `fit`: within the training
  slice's fit tolerance of the reference's uninterrupted run (losses 1e-4
  relative, U/P/Q 1e-5 absolute), the privacy summary equal.
"""
import json
import math

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint import ckpt as ref_ckpt  # noqa: E402
from repro.core import dmf as ref_dmf  # noqa: E402
from repro.core import graph as ref_graph  # noqa: E402
from repro.data import synthetic_poi as ref_poi  # noqa: E402
from repro.privacy import audit as ref_audit  # noqa: E402
from repro.robustness import ChurnConfig as RefChurnConfig  # noqa: E402
from repro_torch import privacy  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.core import dmf, graph  # noqa: E402
from repro_torch.privacy import audit  # noqa: E402
from repro_torch.robustness import ChurnConfig, recovery  # noqa: E402

MSG_TOL = 1e-6
ADV_TOL = 0.02
LOSS_RTOL, STATE_ATOL = 1e-4, 1e-5
AUDIT = {"dp_off": {}, "clip_only": dict(dp_clip=0.25),
         "dp_on": dict(dp_sigma=1.0, dp_clip=0.25, dp_seed=3)}


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


# ------------------------------------------------------------ the audit
@pytest.fixture(scope="module", params=list(AUDIT))
def logs(request, world):
    ds = world["ds"]
    cfg, rcfg = _configs(ds, **AUDIT[request.param])
    got = audit.observe_messages(cfg, ds.train, world["nbr"], epochs=2, seed=0, device="cpu")
    ref = ref_audit.observe_messages(rcfg, ds.train, world["ref_nbr"], epochs=2, seed=0)
    return dict(case=request.param, cfg=cfg, rcfg=rcfg, got=got, ref=ref)


def test_observe_messages_matches_the_reference(logs):
    got, ref = logs["got"], logs["ref"]
    for f in ("sender", "item", "rating", "conf"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
    assert got.gp.shape == ref.gp.shape and got.gp.dtype == np.float32
    np.testing.assert_allclose(got.gp, ref.gp, rtol=MSG_TOL, atol=MSG_TOL)
    if logs["case"] != "dp_off":
        assert np.linalg.norm(got.gp, axis=1).max() > 0
    if logs["case"] == "clip_only":
        assert np.linalg.norm(got.gp, axis=1).max() <= 0.25 * (1 + 1e-6)


def test_attacks_and_screening_report_equal_the_reference_on_one_log(logs, world):
    got, ds = logs["got"], world["ds"]
    assert (audit.rating_reconstruction_attack(got)
            == ref_audit.rating_reconstruction_attack(got))
    rng_a, rng_b = np.random.default_rng(5), np.random.default_rng(5)
    assert (audit.membership_inference_attack(got, ds.train, ds.n_users, ds.n_items, rng=rng_a,
                                              n_pairs=300)
            == ref_audit.membership_inference_attack(got, ds.train, ds.n_users, ds.n_items,
                                                     rng=rng_b, n_pairs=300))
    norms = np.linalg.norm(got.gp, axis=1)
    for cap, p in ((math.inf, None), (float(np.quantile(norms, 0.9)), 1e-6)):
        assert audit.screening_report(got, cap, p) == ref_audit.screening_report(got, cap, p)
    for pos, neg in ((np.array([1.0, 2.0]), np.array([0.5, 2.0])), (np.zeros(0), np.ones(2))):
        assert audit._auc(pos, neg) == ref_audit._auc(pos, neg)
    assert audit._advantage(0.3) == 0.0


@pytest.mark.parametrize("sigma", [0.0, 1.0])
def test_run_audit_matches_the_reference(world, sigma):
    ds = world["ds"]
    cfg, rcfg = _configs(ds, dp_sigma=sigma, dp_clip=0.25, dp_seed=1)
    got = audit.run_audit(cfg, ds.train, world["nbr"], ds.n_users, ds.n_items, epochs=1,
                          n_pairs=400, device="cpu")
    ref = ref_audit.run_audit(rcfg, ds.train, world["ref_nbr"], ds.n_users, ds.n_items,
                              epochs=1, n_pairs=400)
    assert got.keys() == ref.keys()
    for key in ("dp_clip", "dp_sigma", "n_messages"):
        assert got[key] == ref[key]
    for key in got:
        if key.endswith(("_auc", "_advantage")):
            assert abs(got[key] - ref[key]) <= ADV_TOL, (key, got[key], ref[key])


def test_dp_lowers_the_attack_advantage(world):
    ds = world["ds"]
    adv = {}
    for sigma in (0.0, 1.0):
        cfg, _ = _configs(ds, dp_sigma=sigma, dp_clip=0.25, dp_seed=1)
        rep = privacy.run_audit(cfg, ds.train, world["nbr"], ds.n_users, ds.n_items, epochs=1,
                                n_pairs=400, device="cpu")
        adv[sigma] = rep["rating_inversion_advantage"]
    assert adv[1.0] < adv[0.0]
    with pytest.raises(ValueError, match="ldmf"):
        privacy.observe_messages(_configs(ds, mode="ldmf")[0], ds.train, world["nbr"],
                                 device="cpu")


# ------------------------------------------------------------ checkpoints
def _tree():
    rng = np.random.default_rng(0)
    f32 = rng.normal(size=(3, 4, 2)).astype(np.float32)
    bf = rng.normal(size=(5, 3)).astype(np.float32)
    return {"state": {"U": torch.from_numpy(f32[0].copy()), "P": torch.from_numpy(f32)},
            "bf16": torch.from_numpy(bf).to(torch.bfloat16),
            "acc": {"rdp": rng.random((4, 3)), "messages": np.arange(4, dtype=np.int64),
                    "zero_d": np.float32(2.5)},
            "ring": {"ui": np.arange(6, dtype=np.int32).reshape(2, 3)}}


def _as_ref(tree):
    """The same leaves as the reference holds them (numpy / ml_dtypes)."""
    if isinstance(tree, dict):
        return {k: _as_ref(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        if tree.dtype == torch.bfloat16:
            return jnp.asarray(tree.float().numpy()).astype(jnp.bfloat16)
        return tree.numpy()
    return tree


def test_checkpoint_round_trip_and_layout_equal_the_reference(tmp_path):
    tree = _tree()
    ckpt.save(tmp_path / "port", tree, step=7)
    ref_ckpt.save(tmp_path / "ref", _as_ref(tree), step=7)
    got_m = json.loads((tmp_path / "port" / "manifest.json").read_text())
    ref_m = json.loads((tmp_path / "ref" / "manifest.json").read_text())
    assert got_m == ref_m and got_m["step"] == 7
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(
        p.name for p in (tmp_path / "ref").iterdir())
    assert got_m["leaves"]["bf16"]["raw"] and got_m["leaves"]["bf16"]["dtype"] == "bfloat16"
    back = ckpt.restore(tmp_path / "port", tree, device="cpu")
    assert torch.equal(back["state"]["P"], tree["state"]["P"])
    assert back["bf16"].dtype == torch.bfloat16 and torch.equal(back["bf16"], tree["bf16"])
    np.testing.assert_array_equal(back["acc"]["rdp"], tree["acc"]["rdp"])
    assert back["acc"]["zero_d"].shape == () and back["acc"]["zero_d"] == 2.5
    assert isinstance(back["ring"]["ui"], np.ndarray)
    # each package reads the other's files
    cross = ckpt.restore(tmp_path / "ref", tree, device="cpu")
    assert torch.equal(cross["bf16"], tree["bf16"])
    ref_back = ref_ckpt.restore(tmp_path / "port", _as_ref(tree))
    assert ref_back["bf16"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(np.asarray(ref_back["state"]["P"]), tree["state"]["P"].numpy())
    assert ckpt.verify(tmp_path / "port") and ref_ckpt.verify(tmp_path / "port")


def test_checkpoint_corruption_is_detected(tmp_path):
    tree = _tree()
    ckpt.save(tmp_path, tree, step=1)
    leaf = tmp_path / "state__P.npy"
    raw = bytearray(leaf.read_bytes())
    raw[-1] ^= 0x01
    leaf.write_bytes(bytes(raw))
    assert not ckpt.verify(tmp_path)
    with pytest.raises(ckpt.CorruptCheckpointError, match="sha256"):
        ckpt.restore(tmp_path, tree, device="cpu")
    (tmp_path / "bf16.npy").unlink()
    with pytest.raises(ckpt.CorruptCheckpointError, match="missing"):
        ckpt.restore(tmp_path, {"bf16": tree["bf16"]}, device="cpu")
    (tmp_path / "manifest.json").write_text("{not json")
    assert not ckpt.verify(tmp_path)
    assert ckpt.steps(tmp_path) == [] and ckpt.latest_step(tmp_path) is None


def test_pre_checksum_manifest_restores_unverified(tmp_path):
    tree = _tree()
    ckpt.save(tmp_path, tree)
    m = json.loads((tmp_path / "manifest.json").read_text())
    for info in m["leaves"].values():
        del info["sha256"]
    (tmp_path / "manifest.json").write_text(json.dumps(m))
    assert ckpt.verify(tmp_path)
    back = ckpt.restore(tmp_path, tree, device="cpu")
    assert torch.equal(back["state"]["U"], tree["state"]["U"])


# ------------------------------------------------------------ across packages
CC = dict(dropout=0.2, delay_classes=(0, 1, 2), late_frac=0.1, seed=9)
DP = dict(dp_sigma=0.7, dp_clip=1.0, dp_seed=2)


@pytest.fixture(scope="module")
def ref_snapshot(world, tmp_path_factory):
    ds = world["ds"]
    _, rcfg = _configs(ds, **DP)
    root = tmp_path_factory.mktemp("ref_ckpt")
    full = ref_dmf.fit(rcfg, ds.train, world["ref_nbr"], epochs=5, test=ds.test,
                       churn=RefChurnConfig(**CC), checkpoint_dir=root, checkpoint_every=2)
    return root, full


def test_reference_snapshot_resumes_in_the_port(world, ref_snapshot):
    ds = world["ds"]
    root, full = ref_snapshot
    cfg, _ = _configs(ds, **DP)
    got = dmf.fit(cfg, ds.train, world["nbr"], epochs=5, test=ds.test, churn=ChurnConfig(**CC),
                  resume_from=root / "step_2", device="cpu")
    assert got.train_losses[:2] == full.train_losses[:2]      # carried in the sidecar
    np.testing.assert_allclose(got.train_losses, full.train_losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got.test_losses, full.test_losses, rtol=LOSS_RTOL)
    for n in "UPQ":
        np.testing.assert_allclose(getattr(got.state, n).numpy(),
                                   np.asarray(getattr(full.state, n)), rtol=0, atol=STATE_ATOL)
    assert got.privacy == full.privacy


def test_port_snapshot_restores_in_the_reference_with_the_same_layout(world, ref_snapshot,
                                                                      tmp_path):
    ds = world["ds"]
    ref_root, _ = ref_snapshot
    cfg, rcfg = _configs(ds, **DP)
    plan = ChurnConfig(**CC).compile(ds.n_users, 5)       # the reference run's 5-epoch plan
    dmf.fit(cfg, ds.train, world["nbr"], epochs=2, test=ds.test, churn=plan,
            checkpoint_dir=tmp_path, checkpoint_every=2, device="cpu")
    mine, theirs = tmp_path / "step_2", ref_root / "step_2"
    assert sorted(p.name for p in mine.iterdir()) == sorted(p.name for p in theirs.iterdir())
    got_m = json.loads((mine / "manifest.json").read_text())
    ref_m = json.loads((theirs / "manifest.json").read_text())
    assert list(got_m["leaves"]) == list(ref_m["leaves"]) and got_m["step"] == ref_m["step"]
    for name, info in got_m["leaves"].items():
        assert {k: info[k] for k in ("file", "shape", "dtype", "raw")} == {
            k: ref_m["leaves"][name][k] for k in ("file", "shape", "dtype", "raw")}
    side = json.loads((mine / recovery.SIDECAR).read_text())
    ref_side = json.loads((theirs / recovery.SIDECAR).read_text())
    assert side.keys() == ref_side.keys() and side["rng_state"] == ref_side["rng_state"]
    # the reference restores the port's snapshot and resumes from it
    rstate = ref_dmf.init_state(rcfg, np.random.default_rng(0))
    like = {"state": {"U": rstate.U, "P": rstate.P, "Q": rstate.Q}}
    out = ref_ckpt.restore(mine, like)
    np.testing.assert_allclose(np.asarray(out["state"]["P"]),
                               np.asarray(ref_ckpt.restore(theirs, like)["state"]["P"]),
                               rtol=0, atol=STATE_ATOL)
    resumed = ref_dmf.fit(rcfg, ds.train, world["ref_nbr"], epochs=3, test=ds.test,
                          churn=RefChurnConfig(**CC), resume_from=mine)
    assert len(resumed.train_losses) == 3 and np.isfinite(resumed.train_losses).all()
