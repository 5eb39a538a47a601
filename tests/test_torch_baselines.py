"""The port's centralized baselines (`repro_torch.core.baselines`: MF and
BPR) against the reference's, on the CPU, on the reduced Foursquare data.

Both packages get the same data and seed, so they draw the same initial U
and V and the same sampled epochs (MF: `sample_epoch`; BPR: a permutation
and negatives per epoch). Tolerances: per-epoch losses within 1e-5
relative, U and V within 1e-5 absolute (fp32 sums and scatters in another
order than XLA's); `evaluate_mf`'s P@k/R@k equal, through the same dense
scores and the lowest-id tie order of a stable sort. Measured on this
data: losses within 1e-7 relative, factors within 1e-6.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import baselines as ref_bl  # noqa: E402
from repro.data import synthetic_poi as ref_poi  # noqa: E402
from repro_torch.core import baselines  # noqa: E402
from repro_torch.data import synthetic_poi  # noqa: E402

LOSS_REL_TOL = 1e-5
STATE_TOL = 1e-5


@pytest.fixture(scope="module")
def ds():
    ref = ref_poi.foursquare_like(reduced=True)
    port = synthetic_poi.foursquare_like(reduced=True)
    np.testing.assert_array_equal(port.train, ref.train)
    return ref


def _fit_both(kind, ds, epochs, seed=None):
    common = dict(n_users=ds.n_users, n_items=ds.n_items)
    if kind == "mf":
        rcfg, pcfg = ref_bl.MFConfig(**common), baselines.MFConfig(**common)
        rfit, pfit = ref_bl.fit_mf, baselines.fit_mf
    else:
        rcfg, pcfg = ref_bl.BPRConfig(**common), baselines.BPRConfig(**common)
        rfit, pfit = ref_bl.fit_bpr, baselines.fit_bpr
    rstate, rloss = rfit(rcfg, ds.train, epochs=epochs, seed=seed)
    pstate, ploss = pfit(pcfg, ds.train, epochs=epochs, seed=seed, device="cpu")
    return rstate, rloss, pstate, ploss


@pytest.mark.parametrize("epochs", [3, 30])
@pytest.mark.parametrize("kind", ["mf", "bpr"])
def test_fit_matches_reference(ds, kind, epochs):
    rstate, rloss, pstate, ploss = _fit_both(kind, ds, epochs)
    assert len(ploss) == epochs and all(isinstance(x, float) for x in ploss)
    np.testing.assert_allclose(ploss, rloss, rtol=LOSS_REL_TOL, atol=0)
    for name in ("U", "V"):
        got = getattr(pstate, name)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(rstate, name)),
                                   rtol=0, atol=STATE_TOL)
    want = ref_bl.evaluate_mf(rstate, ds.train, ds.test, ds.n_users, ds.n_items)
    got = baselines.evaluate_mf(pstate, ds.train, ds.test, ds.n_users, ds.n_items, device="cpu")
    assert got == want


def test_fit_seed_argument_overrides_the_config_seed(ds):
    rstate, rloss, pstate, ploss = _fit_both("mf", ds, 2, seed=7)
    np.testing.assert_allclose(ploss, rloss, rtol=LOSS_REL_TOL, atol=0)
    np.testing.assert_allclose(pstate.U.numpy(), np.asarray(rstate.U), rtol=0, atol=STATE_TOL)
    other = baselines.fit_mf(baselines.MFConfig(n_users=ds.n_users, n_items=ds.n_items),
                             ds.train, epochs=2, device="cpu")[1]
    assert other != ploss


def test_init_mf_equals_the_reference_draws(ds):
    cfg = dict(n_users=ds.n_users, n_items=ds.n_items, dim=7, seed=3)
    want = ref_bl.init_mf(ref_bl.MFConfig(**cfg))
    got = baselines.init_mf(baselines.MFConfig(**cfg), device="cpu")
    np.testing.assert_array_equal(got.U.numpy(), np.asarray(want.U))
    np.testing.assert_array_equal(got.V.numpy(), np.asarray(want.V))


def test_evaluate_mf_on_the_reference_state_is_equal(ds):
    """The reference's trained state carried across with
    `mf_state_from_numpy` evaluates to the reference's dict, and the
    scores equal the reference's to fp32 rounding."""
    rstate, _ = ref_bl.fit_mf(ref_bl.MFConfig(n_users=ds.n_users, n_items=ds.n_items),
                              ds.train, epochs=20)
    state = baselines.mf_state_from_numpy(np.asarray(rstate.U), np.asarray(rstate.V),
                                          device="cpu")
    np.testing.assert_array_equal(state.U.numpy(), np.asarray(rstate.U))
    np.testing.assert_array_equal(state.V.numpy(), np.asarray(rstate.V))
    want = ref_bl.evaluate_mf(rstate, ds.train, ds.test, ds.n_users, ds.n_items)
    assert want["P@10"] > 0
    assert baselines.evaluate_mf(state, ds.train, ds.test, ds.n_users, ds.n_items,
                                 device="cpu") == want
    np.testing.assert_allclose(baselines.mf_scores(state).numpy(), ref_bl.mf_scores(rstate),
                               rtol=0, atol=1e-6)


def test_mf_state_from_numpy_round_trips():
    rng = np.random.default_rng(0)
    U, V = rng.normal(size=(5, 3)), rng.normal(size=(4, 3)).astype(np.float32)
    state = baselines.mf_state_from_numpy(U, V, device="cpu")
    assert state.U.dtype == state.V.dtype == torch.float32
    np.testing.assert_array_equal(state.U.numpy(), U.astype(np.float32))
    np.testing.assert_array_equal(state.V.numpy(), V)
    back = baselines.mf_state_from_numpy(state.U.numpy(), state.V.numpy(), device="cpu")
    assert torch.equal(back.U, state.U) and torch.equal(back.V, state.V)
    ref_state = ref_bl.MFState(jnp.asarray(state.U.numpy()), jnp.asarray(state.V.numpy()))
    np.testing.assert_array_equal(np.asarray(ref_state.U), state.U.numpy())


def test_bpr_step_loss_is_jax_softplus_at_every_margin():
    """`jax.nn.softplus` is logaddexp(x, 0); the port's BPR loss is too,
    at margins on both sides of `torch.nn.functional.softplus`'s
    threshold of 20."""
    import jax
    margins = np.array([-30.0, -1.0, 0.0, 1.0, 19.9, 20.5, 40.0], np.float32)
    cfg = baselines.BPRConfig(n_users=1, n_items=2, dim=1)
    for m in margins:
        U = torch.tensor([[1.0]])
        V = torch.tensor([[float(m)], [0.0]])
        zero = torch.zeros(1, dtype=torch.int64)
        loss = baselines._bpr_step(U, V, zero, zero, zero + 1, cfg)   # margin u·(xp − xn) = m
        want = float(jax.nn.softplus(jnp.asarray(-m)))
        assert float(loss) == pytest.approx(want, rel=1e-7, abs=0), m
