"""The LM stack's training steps in the port against the reference, on the
CPU: `core/gossip.py` and `launch/train.py` (`make_train_step` with
``allreduce`` and ``gossip``, `train_state_from_numpy` /
`train_state_to_numpy`) of `repro_torch` against `repro`.

* The reference's four gossip unit tests (`tests/test_gossip.py`), on the
  port; `ring_mix`, `mix_global` and `consensus_error` against the
  reference's on the same learner-stacked trees (within 1e-6 relative).
* The steps against the reference's step bodies, composed here from its
  public functions (`loss_fn` under `jax.value_and_grad`, `opt.update`
  under `jax.vmap` for the learners, `apply_updates`, `mix_global`,
  `consensus_error`) on one CPU device; the reference's own
  `make_train_step` needs a mesh, whose lowering fails on this jax
  (ROADMAP §C3). Both start from the reference's numpy tree and take the
  same `SyntheticLM` batches; after each of 3 steps the loss agrees
  within 1e-5 relative and every parameter and moment leaf within 1e-4 ×
  the reference leaf's largest magnitude. The learners' global-norm
  clipping is active (each learner clips by its own norm). AdamW runs
  with eps=1e-3: at the default 1e-8 its first step is -lr·sign(g) for
  any |g| above 1e-8, so an element whose gradient is near zero flips
  with the last bit of the gradient, and a dozen of ~3·10⁵ elements
  differ by ~2·lr between the two packages (fp32 sums in another order).
  Both runs also carry the reference's state (parameters and optimiser
  state) after 2 steps into the port and hold the third step from there.
* The convergence run of `test_gossip_training_converges_small_lm` on the
  port, with that test's own assertions (that test fails on this jax,
  §C3, so the port holds its assertions, not its numbers).
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("hypothesis")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro import optim as ref_optim  # noqa: E402
from repro.configs import registry as ref_registry  # noqa: E402
from repro.core import gossip as ref_gossip  # noqa: E402
from repro.models import config as ref_mc  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch import device as device_lib  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import gossip  # noqa: E402
from repro_torch.data.lm_pipeline import LMDataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import config as mc  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.utils import tree as tree_lib  # noqa: E402

device_lib.settle_cpu()
LOSS_RTOL, LEAF_REL, MIX_RTOL = 1e-5, 1e-4, 1e-6
# the reference gossip test's model (tests/test_gossip.py:92-93)
SMALL = dict(n_kv_heads=4, vocab_size=256, d_model=128, d_ff=256, n_heads=4, head_dim=32)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for these small tensors: the suite runs its files
    in parallel, and with every core busy each parallel region waits for its
    threads (a gossip loop of 2 s took 136 s at 8 threads on 8 busy cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------- tests/test_gossip.py, on the port
@settings(max_examples=20, deadline=None)
@given(st.integers(2, 16), st.floats(0.2, 0.9), st.integers(0, 99))
def test_ring_mix_preserves_mean(L, w_self, seed):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(L, 5)), dtype=torch.float32)
    cfg = gossip.GossipConfig(self_weight=w_self)
    y = gossip.ring_mix(x, cfg)
    np.testing.assert_allclose(y.mean(0).numpy(), x.mean(0).numpy(), rtol=1e-4, atol=1e-5)


def test_mixing_contracts_to_consensus():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(8, 3)), dtype=torch.float32)
    cfg = gossip.GossipConfig(self_weight=0.5)
    devs = [float((x - x.mean(0)).abs().max())]
    for _ in range(40):
        x = gossip.ring_mix(x, cfg)
        devs.append(float((x - x.mean(0)).abs().max()))
    assert devs[-1] < 0.05 * devs[0]
    assert all(b <= a + 1e-6 for a, b in zip(devs, devs[1:]))


def test_walk_length_matches_matrix_power():
    """D rounds of ring mixing == applying the ring matrix W^D (Eq. 4)."""
    L, D = 6, 3
    rng = np.random.default_rng(1)
    x = np.asarray(rng.normal(size=(L, 2)), np.float32)
    cfg = gossip.GossipConfig(self_weight=0.5, walk_length=D)
    W = np.zeros((L, L), np.float32)
    for i in range(L):
        W[i, i] = 0.5
        W[i, (i - 1) % L] = 0.25
        W[i, (i + 1) % L] = 0.25
    want = np.linalg.matrix_power(W, D) @ x
    got = torch.from_numpy(x)
    for _ in range(D):
        got = gossip.ring_mix(got, cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_personal_partition_untouched():
    params = {"blocks": {"0": {"attn": {"wq": torch.ones((4, 3, 2))},
                               "ln1": torch.arange(4 * 3, dtype=torch.float32).reshape(4, 3)}}}
    cfg = gossip.GossipConfig(walk_length=2)
    mixed = gossip.mix_global(params, cfg)
    # ln1 (personal, q^i) unchanged; wq (global, p) mixed
    np.testing.assert_array_equal(mixed["blocks"]["0"]["ln1"].numpy(),
                                  params["blocks"]["0"]["ln1"].numpy())
    # wq constant across learners stays constant (fixed point)
    np.testing.assert_allclose(mixed["blocks"]["0"]["attn"]["wq"].numpy(),
                               params["blocks"]["0"]["attn"]["wq"].numpy(), rtol=1e-6)


# --------------------------------------------- mixing against the reference
def _learner_tree(L, seed):
    """The reduced qwen tree stacked over L learners, each learner moved
    off the others (so that mixing and the consensus error do something)."""
    cfg = ref_mc.reduced(ref_registry.get_config("qwen1.5-4b"), **SMALL)
    params = jax.device_get(ref_tf.init_params(cfg, jax.random.PRNGKey(seed))[0])
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (a[None] + rng.normal(0, 0.01, (L, *a.shape))).astype(np.float32), params)


def _torch_tree(tree):
    return tree_lib.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close_trees(got, want, rtol, what, atol_rel=0.0):
    got, want = dict(tree_lib.tree_paths(got)), dict(tree_lib.tree_paths(want))
    assert set(got) == set(want), what
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].numpy() if torch.is_tensor(got[k]) else np.asarray(got[k])
        assert g.shape == w.shape, (what, k)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol_rel * float(np.abs(w).max()),
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("walk_length,self_weight", [(1, 0.5), (2, 0.5), (3, 0.3)])
@pytest.mark.parametrize("personal", ["default", "nothing"])
def test_mixing_and_consensus_match_the_reference(walk_length, self_weight, personal):
    """`ring_mix` on every leaf, `mix_global` (the default predicate keeps
    `bq`/`bk`/`bv`, `ln1`/`ln2` and `final_norm` personal; a predicate of
    the reference's form that keeps nothing personal), and
    `consensus_error` before and after."""
    pred = None if personal == "default" else (lambda path: False)
    tree = _learner_tree(4, 7)
    rcfg = ref_gossip.GossipConfig(walk_length=walk_length, self_weight=self_weight,
                                   personal_predicate=pred)
    pcfg = gossip.GossipConfig(walk_length=walk_length, self_weight=self_weight,
                               personal_predicate=pred)
    ptree = _torch_tree(tree)
    for (path, x), (_, y) in zip(tree_lib.tree_paths(tree), tree_lib.tree_paths(ptree)):
        np.testing.assert_allclose(gossip.ring_mix(y, pcfg).numpy(),
                                   np.asarray(ref_gossip.ring_mix(jnp.asarray(x), rcfg)),
                                   rtol=MIX_RTOL, atol=0, err_msg=path)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    want = jax.device_get(ref_gossip.mix_global(jtree, rcfg))
    got = gossip.mix_global(ptree, pcfg)
    _close_trees(got, want, MIX_RTOL, "mix_global")
    personal_paths = [k for k, _ in tree_lib.tree_paths(tree) if gossip._is_personal(pcfg, k)]
    if personal == "default":
        assert {p.split("/")[-1] for p in personal_paths} == {
            "bq", "bk", "bv", "ln1", "ln2", "final_norm"}
        got_leaves, given = dict(tree_lib.tree_paths(got)), dict(tree_lib.tree_paths(ptree))
        for k in personal_paths:      # untouched: the same tensors
            assert got_leaves[k] is given[k]
    else:
        assert personal_paths == []
    for t, jt in ((ptree, jtree), (got, jax.tree_util.tree_map(jnp.asarray, want))):
        np.testing.assert_allclose(float(gossip.consensus_error(t, pcfg)),
                                   float(ref_gossip.consensus_error(jt, rcfg)), rtol=MIX_RTOL)


def test_stack_params_copies_each_learner():
    params = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    stacked = gossip.stack_params(params, 3)
    want = ref_gossip.stack_params({"a": jnp.asarray(params["a"].numpy())}, 3)["a"]
    np.testing.assert_array_equal(stacked["a"].numpy(), np.asarray(want))
    assert stacked["a"].is_contiguous()
    stacked["a"][0].add_(1.0)                 # learner 0's copy alone
    np.testing.assert_array_equal(stacked["a"][1].numpy(), params["a"].numpy())


# ------------------------------------------------- the steps, held together
def _configs(arch, **kw):
    ref = ref_mc.reduced(ref_registry.get_config(arch), **kw)
    port = mc.reduced(registry.get_config(arch), **kw)
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    return ref, port


def _ref_allreduce_step(cfg, opt):
    """`launch/train.py:75-80` on one device."""
    @jax.jit
    def step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(ref_tf.loss_fn)(params, batch, cfg)
        updates, opt_state = opt.update(grads, opt_state, params)
        return ref_optim.apply_updates(params, updates), opt_state, {"loss": loss}
    return step


def _ref_gossip_step(cfg, opt, gcfg, L):
    """`launch/train.py:130-148` on one device (mesh=None in the learners,
    as the reference passes)."""
    @jax.jit
    def step(params, opt_state, batch):
        lb = jax.tree_util.tree_map(lambda x: x.reshape(L, x.shape[0] // L, *x.shape[1:]), batch)

        def per_learner(p, b, ostate):
            loss, grads = jax.value_and_grad(ref_tf.loss_fn)(p, b, cfg)
            upd, ostate = opt.update(grads, ostate, p)
            return ref_optim.apply_updates(p, upd), ostate, loss

        params, opt_state, losses = jax.vmap(per_learner)(params, lb, opt_state)
        params = ref_gossip.mix_global(params, gcfg)
        return params, opt_state, {"loss": jnp.mean(losses),
                                   "consensus_err": ref_gossip.consensus_error(params, gcfg)}
    return step


def _hold_state(state, params, opt_state, what):
    got_params, got_opt = train.train_state_to_numpy(state)
    _close_trees(got_params, jax.device_get(params), 0.0, f"{what} params", LEAF_REL)
    want_opt = jax.device_get(opt_state)
    np.testing.assert_array_equal(got_opt.step, want_opt.step)
    _close_trees(got_opt.inner, want_opt.inner, 0.0, f"{what} moments", LEAF_REL)


def _adamw(m):
    """The examples' optimiser with a schedule, clipping and a decay mask
    (biases and norms undecayed); eps=1e-3 (module docstring)."""
    def decay(path):
        if not isinstance(path, str):
            path = "/".join(str(p.key) for p in path)
        return not gossip.default_personal(path)
    return m.adamw(m.linear_warmup_cosine(6e-3, 2, 10), weight_decay=0.01, eps=1e-3,
                   grad_clip_norm=0.5, mask=decay)


@pytest.mark.parametrize("arch,opt_name", [("qwen1.5-4b", "adamw"),
                                           ("musicgen-medium", "nesterov")])
def test_allreduce_step_matches_the_reference_step_body(arch, opt_name):
    kw = SMALL if arch == "qwen1.5-4b" else dict(vocab_size=256, d_model=128, d_ff=256)
    ref_cfg, cfg = _configs(arch, **kw)
    make = _adamw if opt_name == "adamw" else (lambda m: m.momentum(0.05, 0.9, nesterov=True))
    ref_opt, opt = make(ref_optim), make(optim)
    params = ref_tf.init_params(ref_cfg, jax.random.PRNGKey(0))[0]
    opt_state = ref_opt.init(params)
    ref_step = _ref_allreduce_step(ref_cfg, ref_opt)
    step, _ = train.make_train_step(cfg, opt, device="cpu")
    state = train.train_state_from_numpy(cfg, opt, jax.device_get(params), device="cpu")
    data = SyntheticLM(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=32, batch_size=4, seed=1))
    for i in range(3):
        if i == 2:   # carry the reference's state across and go on from it
            state = train.train_state_from_numpy(cfg, opt, jax.device_get(params),
                                                 jax.device_get(opt_state), device="cpu")
        b = data.batch(i, n_codebooks=cfg.n_codebooks)
        params, opt_state, want = ref_step(params, opt_state, {k: jnp.asarray(v) for k, v in b.items()})
        state, got = step(state, b)
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=LOSS_RTOL)
        _hold_state(state, params, opt_state, f"{arch} step {i}")


def test_gossip_step_matches_the_reference_step_body():
    """L=4 learners, D=2; each learner clips by its own global norm (0.5,
    active: every learner's norm is above it at the first step)."""
    L = 4
    ref_cfg, cfg = _configs("qwen1.5-4b", **SMALL)
    ref_opt, opt = _adamw(ref_optim), _adamw(optim)
    rg, pg = ref_gossip.GossipConfig(walk_length=2), gossip.GossipConfig(walk_length=2)
    params = ref_gossip.stack_params(ref_tf.init_params(ref_cfg, jax.random.PRNGKey(0))[0], L)
    opt_state = jax.vmap(ref_opt.init)(params)
    ref_step = _ref_gossip_step(ref_cfg, ref_opt, rg, L)
    step, _ = train.make_train_step(cfg, opt, sync="gossip", gossip=pg, n_learners=L, device="cpu")
    state = train.train_state_from_numpy(cfg, opt, jax.device_get(params), sync="gossip",
                                         device="cpu")
    data = SyntheticLM(LMDataConfig(vocab_size=256, seq_len=32, batch_size=8, seed=0))
    b0 = {k: torch.from_numpy(v) for k, v in data.batch(0).items()}
    for i in range(L):          # each learner's gradient norm at the first step
        model = transformer.params_from_numpy(
            jax.tree_util.tree_map(lambda x: np.asarray(x[i]), jax.device_get(params)), cfg,
            device="cpu")
        transformer.loss_fn(model, {k: v[2 * i:2 * i + 2] for k, v in b0.items()}).backward()
        assert float(tree_lib.global_norm([p.grad for p in model.parameters()])) > 0.5
    for i in range(3):
        if i == 2:   # carry the reference's stacked state across and go on from it
            state = train.train_state_from_numpy(cfg, opt, jax.device_get(params),
                                                 jax.device_get(opt_state), sync="gossip",
                                                 device="cpu")
        b = data.batch(i)
        params, opt_state, want = ref_step(params, opt_state, {k: jnp.asarray(v) for k, v in b.items()})
        state, got = step(state, b)
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(got["consensus_err"]), float(want["consensus_err"]),
                                   rtol=1e-4)
        _hold_state(state, params, opt_state, f"gossip step {i}")
    assert state.opt_state.step.tolist() == [3] * L


def test_gossip_training_converges_small_lm():
    """`tests/test_gossip.py::test_gossip_training_converges_small_lm` on
    the port: its config, L=4 (its mesh's ``data`` axis), D=2,
    ``adamw(6e-3)``, 60 steps; its assertions."""
    cfg = mc.reduced(registry.get_config("qwen1.5-4b"), **SMALL)
    gcfg = gossip.GossipConfig(learner_axis="data", walk_length=2)
    step, init_fn = train.make_train_step(cfg, optim.adamw(6e-3), sync="gossip", gossip=gcfg,
                                          n_learners=4, device="cpu")
    state = init_fn(0)
    data = SyntheticLM(LMDataConfig(vocab_size=256, seq_len=64, batch_size=16, seed=0))
    losses = []
    for i in range(60):
        state, m = step(state, data.batch(i))
        losses.append(float(m["loss"]))
    cons = float(m["consensus_err"])
    assert losses[-1] < losses[0] - 0.3, (losses[0], losses[-1])
    assert cons < 0.5, cons


def test_gossip_step_with_remat_equals_without():
    """Each learner's gradient is taken inside its `functional_call`, so a
    remat period's recompute in the backward sees the learner's own
    parameters: remat on equals remat off, bit for bit, over 2 steps."""
    cfg = mc.reduced(registry.get_config("qwen1.5-4b"))
    data = SyntheticLM(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=16, batch_size=4))
    runs = []
    for remat in (False, True):
        step, init = train.make_train_step(dataclasses.replace(cfg, remat=remat),
                                           optim.adamw(3e-3), sync="gossip",
                                           gossip=gossip.GossipConfig(), n_learners=2,
                                           device="cpu")
        state = init(0)
        for i in range(2):
            state, m = step(state, data.batch(i))
        runs.append((m["loss"], tree_lib.tree_paths(state.params)))
    (loss_a, a), (loss_b, b) = runs
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b))
