"""Learner-sharded churn, DP, Byzantine defenses, telemetry and
checkpoints in the port (`sharding.dmf.train_epoch_churn_sharded`, `fit`
with ``n_shards > 1``) against the reference's, on the CPU: the port at D
gloo ranks (`launch.mesh.spawn_ranks`, one spawn per shard count running
every case of that count, `_torch_sharded_ranks.faults_case`) against the
JAX package at the same ``n_shards`` on its 8-device host mesh, run in this
process meanwhile. The reference tests' small world: 80 users, 50 items,
600 ratings, K=6, B=64.

Tolerances, the reference's for its own sharded runs: churn losses within
1e-7 of the reference's (dropout 0.2, delay classes 0-2, late joiners),
churn + DP within 1e-7, attacked and defended runs (sign flip, screening,
median, DP, churn) within 1e-6; factors within 1e-5 throughout, the
privacy ledger equal to 1e-12 relative. Bit for bit inside the port at
every shard count: the trivial churn plan against plain `fit`, no attack
and no defense against plain DP `fit`, telemetry on against off (the full
DP + churn + screened stack, and without the Byzantine path), and a
2-rank run resumed from its own snapshot. A 2-rank snapshot resumed at 4
ranks within 1e-6 (losses) and 1e-5 (factors). Telemetry: a
``messages_per_shard`` entry per rank summing to ``n_messages``, the
counts equal at 1, 2 and 4 ranks and to the reference's, and rank 0
alone writing the JSONL stream.
"""
import concurrent.futures
import json

import numpy as np
import pytest

pytest.importorskip("jax")

import _torch_sharded_ranks as ranks  # noqa: E402
from repro.core import dmf as ref_dmf  # noqa: E402
from repro.core import graph as ref_graph  # noqa: E402
from repro.data import synthetic_poi as ref_poi  # noqa: E402
from repro.robustness import ChurnConfig as RefChurnConfig  # noqa: E402
from repro.robustness.byzantine import AttackConfig as RefAttackConfig  # noqa: E402
from repro.robustness.byzantine import DefenseConfig as RefDefenseConfig  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402

SHARDS = (1, 2, 4, 8)
STATE_TOL = 1e-5
CHURN_LOSS_TOL = 1e-7
BYZ_LOSS_TOL = 1e-6
SPAWN_TIMEOUT_S = 240.0


def ref_world():
    ds = ref_poi.generate(ref_poi.POIDatasetConfig(n_users=80, n_items=50, n_ratings=600,
                                                   n_cities=4, seed=0))
    gcfg = ref_graph.GraphConfig(n_neighbors=2, walk_length=3)
    W = ref_graph.build_adjacency(ds.user_coords, ds.user_city, gcfg)
    return ds, ref_graph.walk_neighbor_table(W, gcfg)


def ref_fit(ds, nbr, D, cfg_kw=None, **kw):
    cfg = ref_dmf.DMFConfig(n_users=ds.n_users, n_items=ds.n_items, dim=6, batch_size=64,
                            beta=0.1, gamma=0.01, n_shards=D, **(cfg_kw or {}))
    return ref_dmf.fit(cfg, ds.train, nbr, **kw)


def reference_runs() -> dict:
    ds, nbr = ref_world()
    stack = dict(epochs=ranks.OBS_EPOCHS, test=ds.test,
                 churn=RefChurnConfig(**ranks.CHURN_SHORT),
                 attack=RefAttackConfig(**ranks.ATTACK), defense=RefDefenseConfig(**ranks.SCREEN))
    out = {}
    for D in SHARDS[1:]:
        out[D] = {
            "churn": ref_fit(ds, nbr, D, epochs=ranks.EPOCHS,
                             churn=RefChurnConfig(**ranks.CHURN)),
            "byzantine": ref_fit(ds, nbr, D, ranks.BYZ_DP, epochs=ranks.EPOCHS,
                                 churn=RefChurnConfig(**ranks.CHURN_SHORT),
                                 attack=RefAttackConfig(**ranks.ATTACK),
                                 defense=RefDefenseConfig(**ranks.MEDIAN))}
    out[4]["churn_dp"] = ref_fit(ds, nbr, 4, ranks.DP, epochs=ranks.EPOCHS,
                                 churn=RefChurnConfig(**ranks.CHURN_SHORT))
    out[2]["ckpt_full"] = ref_fit(ds, nbr, 2, epochs=ranks.EPOCHS,
                                  churn=RefChurnConfig(**ranks.CHURN_SHORT))
    out["stack_on"] = ref_fit(ds, nbr, 2, ranks.BYZ_DP, telemetry=True, **stack)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sharded_ckpt"))

    def spawn_all():        # in order: the 4-rank case resumes the 2-rank snapshot
        return {D: mesh.spawn_ranks(ranks.faults_case, D, backend="gloo", device="cpu",
                                    timeout_s=SPAWN_TIMEOUT_S, args=(D, root))
                for D in SHARDS}

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(spawn_all)
        ref = reference_runs()
        return dict(port=port.result(), ref=ref, root=root)


def assert_same_bits(a: dict, b: dict) -> None:
    assert a["losses"] == b["losses"]
    for name in "UPQ":
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def as_host(res) -> dict:
    """A reference `FitResult` as the ranks' host dicts."""
    return dict(losses=list(res.train_losses),
                **{k: np.asarray(getattr(res.state, k)) for k in "UPQ"})


def assert_close(got: dict, want, loss_tol: float) -> None:
    want = want if isinstance(want, dict) else as_host(want)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0, atol=loss_tol)
    for name in "UPQ":
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=STATE_TOL, err_msg=name)


# ------------------------------------------------------------ bit for bit
@pytest.mark.parametrize("n_shards", SHARDS)
def test_trivial_churn_plan_is_plain_fit_bit_for_bit(runs, n_shards):
    got = runs["port"][n_shards]
    assert_same_bits(got["trivial"], got["plain"])


@pytest.mark.parametrize("n_shards", SHARDS)
def test_no_attack_no_defense_is_plain_dp_fit_bit_for_bit(runs, n_shards):
    got = runs["port"][n_shards]
    assert_same_bits(got["dp_byz_off"], got["dp_plain"])
    assert got["dp_byz_off"]["privacy"] == got["dp_plain"]["privacy"]


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_telemetry_leaves_the_full_stack_bit_for_bit(runs, n_shards):
    got = runs["port"][n_shards]
    assert_same_bits(got["stack_on"], got["stack_off"])
    assert got["stack_on"]["test_losses"] == got["stack_off"]["test_losses"]
    assert got["stack_off"]["telemetry"] is None
    events = got["stack_on"]["telemetry"]
    assert len(events) == ranks.OBS_EPOCHS
    for ev in events:
        assert len(ev["messages_per_shard"]) == n_shards
        assert sum(ev["messages_per_shard"]) == ev["n_messages"]


def test_telemetry_without_the_byzantine_path_is_bit_for_bit(runs):
    got = runs["port"][2]
    assert_same_bits(got["nobyz_on"], got["nobyz_off"])
    assert [len(ev["messages_per_shard"]) for ev in got["nobyz_on"]["telemetry"]] == [2] * 3


def test_message_counts_are_shard_count_invariant_and_the_references(runs):
    counts = {D: [ev["n_messages"] for ev in runs["port"][D]["stack_on"]["telemetry"]]
              for D in SHARDS}
    ref = [ev["n_messages"] for ev in runs["ref"]["stack_on"].telemetry]
    assert counts[1] == counts[2] == counts[4] == counts[8] == ref
    ev, rev = runs["port"][2]["stack_on"]["telemetry"][0], runs["ref"]["stack_on"].telemetry[0]
    for key in ("messages_per_shard", "screen_accept", "screen_reject", "n_online",
                "ring_occupancy"):
        assert ev[key] == rev[key], key
    for key in ("u_update_norm", "q_update_norm", "p_msg_norm", "p_scatter_norm"):
        assert ev[key] == pytest.approx(rev[key], rel=1e-5), key


def test_rank_zero_alone_writes_the_telemetry_stream(runs):
    with open(f"{runs['root']}/telemetry.jsonl") as f:
        lines = [json.loads(ln) for ln in f]
    assert [ev["epoch"] for ev in lines] == list(range(ranks.EPOCHS))


# ------------------------------------------------------ against the reference
@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sharded_churn_matches_the_reference(runs, n_shards):
    assert_close(runs["port"][n_shards]["churn"], runs["ref"][n_shards]["churn"],
                 CHURN_LOSS_TOL)


def test_sharded_churn_with_dp_matches_the_reference(runs):
    got, ref = runs["port"][4]["churn_dp"], runs["ref"][4]["churn_dp"]
    assert_close(got, ref, CHURN_LOSS_TOL)
    assert got["privacy"]["eps_max"] == pytest.approx(ref.privacy["eps_max"], rel=1e-12)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_attack_and_defense_match_the_reference(runs, n_shards):
    got = runs["port"][n_shards]["byzantine"]
    assert got["diverged_at"] is None
    assert_close(got, runs["ref"][n_shards]["byzantine"], BYZ_LOSS_TOL)
    # and the port is shard-count invariant
    assert_close(got, runs["port"][2]["byzantine"], BYZ_LOSS_TOL)


def test_an_undefended_nan_bomb_halts_every_rank_at_the_same_epoch(runs):
    """`on_nonfinite="halt"` at 2 ranks stops where the single-device run
    stops and returns the last finite state, the same bits."""
    one, two = runs["port"][1]["nan_halt"], runs["port"][2]["nan_halt"]
    assert one["diverged_at"] is not None and two["diverged_at"] == one["diverged_at"]
    for name in "UPQ":
        assert np.isfinite(two[name]).all(), name
    np.testing.assert_allclose(two["losses"][:-1], one["losses"][:-1], rtol=0,
                               atol=CHURN_LOSS_TOL)
    for name in "UPQ":
        np.testing.assert_allclose(two[name], one[name], rtol=0, atol=STATE_TOL, err_msg=name)


# --------------------------------------------------------------- checkpoints
def test_resume_is_bit_for_bit_at_two_ranks(runs):
    got = runs["port"][2]
    assert_same_bits(got["resumed"], got["ckpt_full"])
    assert_close(got["ckpt_full"], runs["ref"][2]["ckpt_full"], CHURN_LOSS_TOL)


def test_two_rank_snapshot_resumes_at_four_ranks(runs):
    full, wider = runs["port"][2]["ckpt_full"], runs["port"][4]["wider"]
    assert_close(wider, full, 1e-6)
    assert wider["losses"][:2] == full["losses"][:2]     # restored from the snapshot
