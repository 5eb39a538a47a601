"""The mesh half's steps on the CPU: one 4-rank gloo group (spawned once for
the whole file by `repro_torch.launch.mesh.spawn_ranks`, one thread a
rank; the rank functions live in tests/_torch_mesh_ranks.py) builds the
(2, 2), (4, 1) and (1, 4) meshes from one world and holds:

* `moe_ffn_sharded`, expert parallel and weight-stationary, B=4 and B=1,
  against the reference's `moe_ffn_sharded`, which runs here on a jax
  (2, 2) mesh of the conftest's host devices, on the same numpy params
  and tokens (outputs within 2e-5, aux within 1e-6 relative);
* the ``allreduce`` mesh step (3 steps; on (2, 2), with `DP_OVERRIDES`,
  with ignored labels (-1) on one batch shard only, and
  deepseek-v2-lite's experts parallel on (1, 4)) against the port's
  one-device step: losses within 1e-6 relative, parameters within 5e-6
  of each leaf's largest magnitude, and each rank's state bytes equal to
  the analytic count of its shards from `params_pspecs`;
* the gossip mesh step with learners as ranks, L=4 on (4, 1) and L=2 on
  (2, 2), against the one-device gossip step at the same L: losses
  and the consensus error within 1e-6 relative, parameters within 1e-6;
  at model=1 on the CPU the parameters are equal bit for bit (the
  learner's loss, gradient, norm — its periods stacked, as the one-device
  tree holds them — AdamW and the ring mix run the same operations in
  the same order). At model=2 the clipping norm sums each model half's
  squares and then the halves; with that sum taken in the one-device
  order instead (the gradients gathered whole, a probe of the cause)
  (2, 2) is bit for bit too, so that order is the whole difference;
* prefill and decode on a sequence-sharded cache, for GQA (qwen, over
  ``model`` at B=2 and over ``(data, model)`` at B=1), MLA
  (deepseek-v2-lite), a sliding-window ring past its wrap (yi-34b-swa,
  its window cut to 8) and Jamba's hybrid (SSM caches gathered per
  period), against the one-device prefill and decode: logits and every
  cache leaf within 5e-6 relative, greedy ids equal.

The reference's own execution tests of these steps fail on jax 0.9.0
(ROADMAP §C3), so the steps are held against the port's one-device
steps, which tests/test_torch_lm_serving.py and
tests/test_torch_lm_training.py hold against the reference.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as ref_moe  # noqa: E402
from repro.models.config import LayerSpec, ModelConfig  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
import _torch_mesh_ranks as ranks  # noqa: E402

MOE_CFG = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=0,
               vocab_size=64, n_routed_experts=8, n_shared_experts=1, moe_top_k=2, moe_d_ff=32,
               compute_dtype="float32")
LOSS_RTOL, PARAM_REL, SERVE_REL, MOE_TOL = 1e-6, 5e-6, 5e-6, 2e-5


def reference_moe():
    """The reference's `moe_ffn_sharded` on a jax (2, 2) mesh: EP and ws,
    B=4 and B=1, and the numpy inputs it ran on."""
    cfg = ModelConfig(**MOE_CFG, period=(LayerSpec(kind="attn", moe=True),))
    params, _ = ref_moe.init_moe(jax.random.PRNGKey(0), cfg)
    arrays = {k: np.asarray(v) for k, v in params.items()}
    x = np.random.default_rng(0).normal(size=(4, 16, 64)).astype(np.float32)
    arrays["x4"], arrays["x1"] = x, x[:1].copy()
    m = jax.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
    out = {}
    for ws in (False, True):
        for B in (4, 1):
            f = jax.jit(lambda p, xx, ws=ws: ref_moe.moe_ffn_sharded(p, xx, cfg, jnp.float32, m,
                                                                    weight_stationary=ws))
            y, aux = f(params, jnp.asarray(arrays[f"x{B}"]))
            out[f"{'ws' if ws else 'ep'}_B{B}"] = (np.asarray(y), float(aux))
    return arrays, out


@pytest.fixture(scope="module")
def run():
    arrays, ref = reference_moe()
    got = mesh.spawn_ranks(ranks.mesh_case, 4, backend="gloo", device="cpu", timeout_s=600,
                           args=(MOE_CFG, arrays))
    return got, ref


@pytest.mark.parametrize("case", ["ep_B4", "ep_B1", "ws_B4", "ws_B1"])
def test_moe_ffn_sharded_matches_reference(run, case):
    got, ref = run
    y, aux = got["moe"][case]
    ry, raux = ref[case]
    np.testing.assert_allclose(y, ry, rtol=MOE_TOL, atol=MOE_TOL)
    assert abs(aux - raux) <= 1e-6 * abs(raux)


@pytest.mark.parametrize("case", ["allreduce_2x2", "allreduce_dp_2x2", "allreduce_masked_2x2",
                                  "allreduce_moe_1x4"])
def test_allreduce_mesh_step_matches_one_device_step(run, case):
    out = run[0][case]
    for loss, want in out["losses"]:
        assert abs(loss - want) <= LOSS_RTOL * abs(want), out["losses"]
    assert out["param_rel"] <= PARAM_REL, out
    assert out["state_bytes"] == out["analytic_bytes"], out


@pytest.mark.parametrize("case", ["gossip_4x1", "gossip_2x2", "gossip_2x2_one_device_norm"])
def test_gossip_learners_as_ranks_match_one_device_gossip(run, case):
    out = run[0][case]
    for loss, want, cons, want_cons in out["rows"]:
        assert abs(loss - want) <= LOSS_RTOL * abs(want), out["rows"]
        assert abs(cons - want_cons) <= 1e-6 * abs(want_cons) + 1e-12, out["rows"]
    assert out["param_rel"] <= 1e-6, out
    if case != "gossip_2x2":
        assert out["bitwise"], out


@pytest.mark.parametrize("case", ["qwen1.5-4b_1x4_B2", "qwen1.5-4b_2x2_B1",
                                  "deepseek-v2-lite-16b_1x4_B2", "yi-34b-swa_1x4_B2",
                                  "jamba-1.5-large-398b_2x2_B2"])
def test_sequence_sharded_decode_matches_one_device(run, case):
    out = run[0][f"serve_{case}"]
    assert out["same_ids"], out
    assert out["logits_rel"] <= SERVE_REL and out["cache_rel"] <= SERVE_REL, out
    if "jamba" not in case:     # the positions lie over the mesh, not gathered
        assert all("'model'" in s for s in out["cache_specs"]), out["cache_specs"]
