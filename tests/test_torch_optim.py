"""The LM training half's optimisers, schedules and token stream in the
port against the reference, on the CPU: `optim/` (`sgd`, `momentum`,
`adamw`, `apply_updates`, the schedules, the state's carry-over) and
`data/lm_pipeline.py` of `repro_torch` against `repro`.

* `SyntheticLM` batches equal the reference's bit for bit.
* The schedules within 1e-6 relative (float32 `cos` in another library).
* The reference's six `tests/test_optim.py` cases, on the port.
* `update` against the reference's `update` on the same numpy trees for 5
  steps (the same gradients fed to both): updates, moments and steps
  within 1e-6 relative + 1e-6 × the leaf's largest magnitude (float32
  `pow` and `sqrt` in another library).
* `update_` (the in-place form) against `update` + `apply_updates`: equal
  bit for bit.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import optim as ref_optim  # noqa: E402
from repro.data import lm_pipeline as ref_data  # noqa: E402
from repro_torch import device as device_lib  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.data import lm_pipeline  # noqa: E402
from repro_torch.utils import tree as tree_lib  # noqa: E402

device_lib.settle_cpu()
RTOL, ATOL_REL = 1e-6, 1e-6


# --------------------------------------------------------------- token stream
@pytest.mark.parametrize("n_codebooks", [0, 4])
@pytest.mark.parametrize("seed,vocab,seq,batch", [(0, 256, 64, 16), (3, 8192, 33, 5),
                                                  (11, 151_936, 17, 2)])
def test_synthetic_lm_equals_the_reference_bit_for_bit(seed, vocab, seq, batch, n_codebooks):
    kw = dict(vocab_size=vocab, seq_len=seq, batch_size=batch, seed=seed)
    ref = ref_data.SyntheticLM(ref_data.LMDataConfig(**kw))
    port = lm_pipeline.SyntheticLM(lm_pipeline.LMDataConfig(**kw))
    for step in (0, 1, 7, 1000):
        want, got = ref.batch(step, n_codebooks), port.batch(step, n_codebooks)
        assert set(got) == {"tokens", "labels"}
        for k in got:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            np.testing.assert_array_equal(got[k], want[k])
    assert port.unigram_entropy() == ref.unigram_entropy()


# ------------------------------------------------------------------ schedules
@pytest.mark.parametrize("name,args", [
    ("constant", (6e-3,)),
    ("cosine_decay", (2.0, 50)),
    ("cosine_decay", (3e-3, 300, 1e-4)),
    ("linear_warmup_cosine", (3e-3, 20, 300)),
    ("linear_warmup_cosine", (1.0, 0, 10, 0.5)),
])
def test_schedules_equal_the_reference(name, args):
    ref, port = getattr(ref_optim, name)(*args), getattr(optim, name)(*args)
    for s in [0, 1, 5, 9, 10, 11, 19, 20, 21, 49, 50, 51, 150, 299, 300, 301, 1000]:
        want = np.float32(ref(jnp.asarray(s, jnp.int32)))
        got = port(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), want, rtol=RTOL, atol=0, err_msg=f"step {s}")


# ----------------------------------- the reference's tests/test_optim.py cases
def _t(*shape):
    return torch.zeros(shape, dtype=torch.float32)


def _quad_grads(p):
    """The gradient of sum((w - 3)²) + sum((b + 1)²)."""
    return {"w": 2 * (p["w"] - 3.0), "b": 2 * (p["b"] + 1.0)}


def _fit(opt, steps=200):
    params = {"w": _t(4), "b": _t(2)}
    state = opt.init(params)
    for _ in range(steps):
        upd, state = opt.update(_quad_grads(params), state, params)
        params = optim.apply_updates(params, upd)
    return params


def test_sgd_matches_closed_form():
    opt = optim.sgd(0.1)
    params = {"w": _t(1), "b": _t(1)}
    state = opt.init(params)
    upd, state = opt.update(_quad_grads(params), state, params)
    params = optim.apply_updates(params, upd)
    # w1 = 0 - 0.1 * 2(0-3) = 0.6
    np.testing.assert_allclose(params["w"].numpy(), [0.6], rtol=1e-6)
    np.testing.assert_allclose(params["b"].numpy(), [-0.2], rtol=1e-6)


def test_adamw_converges_quadratic():
    p = _fit(optim.adamw(0.05), steps=400)
    np.testing.assert_allclose(p["w"].numpy(), 3.0, atol=1e-2)
    np.testing.assert_allclose(p["b"].numpy(), -1.0, atol=1e-2)


def test_momentum_converges():
    p = _fit(optim.momentum(0.02, 0.9), steps=300)
    np.testing.assert_allclose(p["w"].numpy(), 3.0, atol=1e-2)


def test_grad_clip_bounds_update():
    opt = optim.adamw(1.0, grad_clip_norm=1e-3)
    params = {"w": _t(4), "b": _t(2)}
    state = opt.init(params)
    g = {k: v + 1e6 for k, v in params.items()}
    upd, _ = opt.update(g, state, params)
    assert np.isfinite(upd["w"].numpy()).all()


def test_weight_decay_mask():
    def no_decay(path):        # the reference's mask reads path[-1].key
        return not path.split("/")[-1].startswith("b")

    opt = optim.adamw(0.1, weight_decay=0.5, mask=no_decay, grad_clip_norm=None)
    params = {"w": torch.ones(2), "b": torch.ones(2)}
    state = opt.init(params)
    upd, _ = opt.update({k: torch.zeros_like(v) for k, v in params.items()}, state, params)
    assert float(upd["w"].abs().max()) > 0      # decayed
    np.testing.assert_allclose(upd["b"].numpy(), 0.0)  # masked out


def test_schedules():
    s = optim.linear_warmup_cosine(1.0, warmup=10, total_steps=100)
    step = lambda i: torch.tensor(i, dtype=torch.int32)
    assert float(s(step(0))) == 0.0
    assert abs(float(s(step(10))) - 1.0) < 1e-6
    assert float(s(step(100))) < 1e-6
    c = optim.cosine_decay(2.0, 50, floor=0.5)
    assert abs(float(c(step(0))) - 2.0) < 1e-6
    assert abs(float(c(step(50))) - 0.5) < 1e-6


# ------------------------------------------- update against the reference's
def _tree(rng):
    """A reference-shaped parameter tree: stacked blocks, norms, biases."""
    return {
        "blocks": {"0": {"attn": {"bq": rng.normal(0, 0.3, (2, 4, 3)),
                                  "wq": rng.normal(0, 0.02, (2, 8, 4, 3))},
                         "ln1": 1 + rng.normal(0, 0.1, (2, 8))}},
        "embed": rng.normal(0, 0.02, (16, 8)),
        "final_norm": 1 + rng.normal(0, 0.1, (8,)),
    }


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _to_torch(tree):
    return tree_lib.tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


def _not_bias(path) -> bool:
    """Decay all but biases and norms. The reference's mask gets a key
    path, the port's the '/'-joined string."""
    if not isinstance(path, str):
        path = "/".join(str(p.key) for p in path)
    leaf = path.split("/")[-1]
    return not (leaf.startswith("b") or "norm" in leaf or leaf.startswith("ln"))


OPTIMIZERS = {
    "sgd": lambda m, sched: m.sgd(sched(m) if sched else 0.1),
    "momentum": lambda m, sched: m.momentum(sched(m) if sched else 0.05, 0.9),
    "nesterov": lambda m, sched: m.momentum(sched(m) if sched else 0.05, 0.9, nesterov=True),
    "adamw": lambda m, sched: m.adamw(sched(m) if sched else 3e-3, weight_decay=0.1,
                                      grad_clip_norm=None),
    "adamw_clip": lambda m, sched: m.adamw(sched(m) if sched else 3e-3, weight_decay=0.1,
                                           grad_clip_norm=0.5),
    "adamw_clip_mask": lambda m, sched: m.adamw(sched(m) if sched else 3e-3, weight_decay=0.1,
                                                grad_clip_norm=0.5, mask=_not_bias),
}
SCHEDULE = lambda m: m.linear_warmup_cosine(3e-3, 2, 5)


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL_REL * max(float(np.abs(want).max()), 1e-30),
                               err_msg=what)


def _close_trees(got, want, what):
    want = dict(tree_lib.tree_paths(want))
    got = dict(tree_lib.tree_paths(got))
    assert set(got) == set(want), what
    for k in want:
        _close(got[k].numpy() if torch.is_tensor(got[k]) else got[k], want[k], f"{what} {k}")


@pytest.mark.parametrize("scheduled", [False, True], ids=["constant_lr", "schedule"])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_update_matches_the_reference_over_five_steps(name, scheduled):
    rng = np.random.default_rng(0)
    params = _f32(_tree(rng))
    ref = OPTIMIZERS[name](ref_optim, SCHEDULE if scheduled else None)
    port = OPTIMIZERS[name](optim, SCHEDULE if scheduled else None)
    rp, pp = jax.tree_util.tree_map(jnp.asarray, params), _to_torch(params)
    rs, ps = ref.init(rp), port.init(pp)
    for step in range(5):
        grads = _f32(jax.tree_util.tree_map(lambda a: rng.normal(0, 0.5, a.shape), params))
        ru, rs = ref.update(jax.tree_util.tree_map(jnp.asarray, grads), rs, rp)
        pu, ps = port.update(_to_torch(grads), ps, pp)
        _close_trees(pu, jax.device_get(ru), f"{name} step {step} updates")
        rp, pp = ref_optim.apply_updates(rp, ru), optim.apply_updates(pp, pu)
        _close_trees(pp, jax.device_get(rp), f"{name} step {step} params")
        want_state = jax.device_get(rs)
        got_state = optim.state_to_numpy(ps)
        assert int(got_state.step) == int(want_state.step) == step + 1
        _close_trees(got_state.inner, want_state.inner, f"{name} step {step} state")


def _split_periods(tree):
    """The tree as `transformer.param_tree` holds a model: each
    ``blocks`` leaf a list of its periods' tensors."""
    block = tree["blocks"]["0"]
    return {**tree, "blocks": {"0": {"attn": {k: list(v) for k, v in block["attn"].items()},
                                     "ln1": list(block["ln1"])}}}


@pytest.mark.parametrize("periods", [False, True], ids=["stacked", "period_lists"])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_update_in_place_equals_update_and_apply_bit_for_bit(name, periods):
    """``update_`` writes the same bits into the parameters and the state
    as ``update`` + ``apply_updates`` return, step after step, a constant
    rate and a schedule alike, on stacked leaves and on per-period lists
    (`transformer.param_tree`'s form)."""
    rng = np.random.default_rng(1)
    params = _f32(_tree(rng))
    form = _split_periods if periods else (lambda t: t)
    tn = optim.optimizers.tree_to_numpy
    for sched in (None, SCHEDULE):
        opt = OPTIMIZERS[name](optim, sched)
        a, b = form(_to_torch(params)), form(_to_torch(params))
        sa, sb = opt.init(a), opt.init(b)
        for _ in range(4):
            grads = _f32(jax.tree_util.tree_map(lambda x: rng.normal(0, 0.5, x.shape), params))
            upd, sa = opt.update(form(_to_torch(grads)), sa, a)
            a = optim.apply_updates(a, upd)
            assert opt.update_(form(_to_torch(grads)), sb, b) is sb
            na, nb = optim.state_to_numpy(sa), optim.state_to_numpy(sb)
            assert int(na.step) == int(nb.step)
            for what, x, y in (("params", tn(a), tn(b)), ("state", na.inner, nb.inner)):
                want, got = tree_lib.tree_paths(x), tree_lib.tree_paths(y)
                assert [k for k, _ in got] == [k for k, _ in want]
                for (k, u), (_, v) in zip(got, want):
                    np.testing.assert_array_equal(u, v, err_msg=f"{name} {what} {k}")


def test_state_carries_across_from_the_reference():
    """The reference's AdamW state after 3 steps, carried into the port
    (`state_from_numpy`, a stacked leaf split into periods) and back
    (`state_to_numpy`), bit for bit; the port's next step then matches
    the reference's next step."""
    rng = np.random.default_rng(2)
    params = _f32(_tree(rng))
    ref, port = ref_optim.adamw(3e-3, weight_decay=0.1), optim.adamw(3e-3, weight_decay=0.1)
    rp = jax.tree_util.tree_map(jnp.asarray, params)
    rs = ref.init(rp)
    for _ in range(3):
        g = jax.tree_util.tree_map(lambda a: jnp.asarray(rng.normal(0, 0.5, a.shape), jnp.float32),
                                   rp)
        u, rs = ref.update(g, rs, rp)
        rp = ref_optim.apply_updates(rp, u)
    want = jax.device_get(rs)
    pp = _to_torch(jax.device_get(rp))
    pp["blocks"]["0"]["attn"]["wq"] = list(pp["blocks"]["0"]["attn"]["wq"])
    ps = optim.state_from_numpy(want, pp)
    assert isinstance(ps.inner.mu["blocks"]["0"]["attn"]["wq"], list)
    back = optim.state_to_numpy(ps)
    assert int(back.step) == 3
    for x, y in zip(jax.tree_util.tree_leaves(back.inner), jax.tree_util.tree_leaves(want.inner)):
        np.testing.assert_array_equal(x, y)
    g = jax.tree_util.tree_map(lambda a: np.asarray(rng.normal(0, 0.5, a.shape), np.float32),
                               jax.device_get(rp))
    ru, rs = ref.update(jax.tree_util.tree_map(jnp.asarray, g), rs, rp)
    gt = _to_torch(g)
    gt["blocks"]["0"]["attn"]["wq"] = list(gt["blocks"]["0"]["attn"]["wq"])
    ps = port.update_(gt, ps, pp)
    got = optim.optimizers.tree_to_numpy(pp)
    _close_trees(got, jax.device_get(ref_optim.apply_updates(rp, ru)), "after the carry-over")
    with pytest.raises(ValueError):
        optim.state_from_numpy(want, {**pp, "embed": torch.zeros(3)})
