"""The port's kernels (`repro_torch.kernels`) against the reference's Pallas
kernels, on the CPU.

The same numpy inputs, drawn from a fixed seed, go through the reference's
`repro.kernels.ops` wrappers (Pallas in interpret mode) and the port's
plain versions, which is what the port's wrappers run on CPU tensors.
Tolerances: top-k indices equal; values within 1e-6 abs + 1e-6 rel (the
two frameworks sum over K in another order, about 1 ulp), for the fp32
window, whole-slab (`serve_topk`) and int8/bf16 window
(`serve_topk_window_quant`) forms alike; fused-step
deltas within 1e-6 abs, loss within 1e-5 rel (a sum over the batch).
The CUDA kernels themselves are held against the same plain versions on
the card by `chip_smoke.py` and `tests/test_torch_cuda.py`.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import dmf as ref_dmf  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.core import dmf  # noqa: E402
from repro_torch.kernels import dp_noise, ops, ref  # noqa: E402

K = 10


def _window_inputs(seed=0, R=12, Cw=256, J=3197):
    """Serve-window inputs with exact ties (zero users, zero and repeated
    item vectors), -1 padding, an all-seen row and rows with fewer
    unmasked candidates than k."""
    rng = np.random.default_rng(seed)
    U = rng.normal(0, 1, (R, K)).astype(np.float32)
    U[1] = 0.0                                   # every score exactly 0
    Vw = rng.normal(0, 1, (R, Cw, K)).astype(np.float32)
    Vw[2, ::3] = 0.0                             # zero item factors: 0.0 ties
    Vw[3, 10:20] = Vw[3, 5]                      # repeated vectors: exact ties
    n_valid = rng.integers(Cw // 2, Cw + 1, R)
    n_valid[4] = 3                               # k > unmasked candidates
    n_valid[5] = 0                               # empty bucket
    cand = np.full((R, Cw), -1, np.int32)
    for r in range(R):
        cand[r, : n_valid[r]] = np.sort(rng.choice(J, n_valid[r], replace=False))
    seen = (rng.random((R, Cw)) < 0.2).astype(np.int8)
    seen[6] = 1                                  # all seen
    seen[4] = 0
    return U, Vw, cand, seen


def _dense_inputs(seed=1, R=9, J=300):
    """Dense per-user inputs: J not a multiple of 128, an all-masked row,
    a row with fewer unmasked items than k, zero rows."""
    rng = np.random.default_rng(seed)
    U = rng.normal(0, 1, (R, K)).astype(np.float32)
    U[0] = 0.0
    V = rng.normal(0, 1, (R, J, K)).astype(np.float32)
    V[2, 50:] = 0.0
    V[3, 100:140] = V[3, 7]
    mask = (rng.random((R, J)) < 0.3).astype(np.int8)
    mask[4] = 1
    mask[5] = 1
    mask[5, [11, 200, 299]] = 0
    return U, V, mask


def _t(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


def _assert_topk(port, reference):
    (pv, pi), (rv, ri) = port, reference
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k", [1, 5, 10, 16])
@pytest.mark.parametrize("seed", [0, 1])
def test_serve_topk_window_plain_matches_reference_kernel(seed, k):
    U, Vw, cand, seen = _window_inputs(seed)
    expect = ref_ops.serve_topk_window(jnp.asarray(U), jnp.asarray(Vw), jnp.asarray(cand),
                                       jnp.asarray(seen), k, interpret=True)
    got = ref.serve_topk_window_ref(*_t(U, Vw, cand, seen), k)
    _assert_topk(got, expect)
    vals, idx = got[0].numpy(), got[1].numpy()
    # contract rows: all-seen and empty rows dead, the 3-candidate row
    # fills 3 slots and leaves (NEG_INF, -1) behind
    for r in (5, 6):
        assert (idx[r] == -1).all() and (vals[r] == np.float32(ref.NEG_INF)).all()
    assert (idx[4, :3] >= 0).all() and (idx[4, 3:] == -1).all()


def _slab_inputs(seed):
    """Whole per-request slabs (R, J, K) and seen rows (R, J) holding the
    window inputs at the candidate ids, random elsewhere."""
    U, Vw, cand, seen_w = _window_inputs(seed)
    R, J = cand.shape[0], 3197
    rng = np.random.default_rng(seed + 100)
    V = rng.normal(0, 1, (R, J, K)).astype(np.float32)
    seen = (rng.random((R, J)) < 0.3).astype(np.int8)
    for r in range(R):
        live = cand[r] >= 0
        V[r, cand[r, live]] = Vw[r, live]
        seen[r, cand[r, live]] = seen_w[r, live]
    return U, V, cand, seen


@pytest.mark.parametrize("k", [1, 10, 16])
@pytest.mark.parametrize("seed", [0, 1])
def test_serve_topk_plain_matches_reference_kernel(seed, k):
    U, V, cand, seen = _slab_inputs(seed)
    expect = ref_ops.serve_topk(jnp.asarray(U), jnp.asarray(V), jnp.asarray(cand),
                                jnp.asarray(seen), k, interpret=True)
    got = ref.serve_topk_ref(*_t(U, V, cand, seen), k)
    _assert_topk(got, expect)
    idx = got[1].numpy()
    for r in (5, 6):                       # empty bucket, all seen
        assert (idx[r] == -1).all()
    assert (idx[4, :3] >= 0).all() and (idx[4, 3:] == -1).all()
    # the slab form equals the window form on the windows it gathers
    _, Vw, _, seen_w = _window_inputs(seed)
    for a, b in zip(got, ref.serve_topk_window_ref(*_t(U, Vw, cand, seen_w), k)):
        assert torch.equal(a, b)
    # an id past the slab is no candidate (the CUDA kernel reads nothing there)
    past = cand.copy()
    past[past == past.max()] = V.shape[1] + 3
    got_past = ref.serve_topk_ref(*_t(U, V, past, seen), k)
    assert not (got_past[1] == V.shape[1] + 3).any()


def _quant_inputs(seed):
    """int8 codes with per-request scales (an all-zero request floors its
    scale at 1e-12) and the bf16 bits of the same windows."""
    U, Vw, cand, seen = _window_inputs(seed)
    Vw[7] = 0.0
    scale = np.maximum(np.abs(Vw).max(axis=(1, 2)) / 127.0, 1e-12).astype(np.float32)
    codes = np.clip(np.rint(Vw / scale[:, None, None]), -127, 127).astype(np.int8)
    bits = np.array(jnp.asarray(Vw).astype(jnp.bfloat16)).view(np.uint16)
    return U, Vw, cand, seen, codes, scale, bits


@pytest.mark.parametrize("k", [1, 10, 16])
@pytest.mark.parametrize("form", ["int8", "bf16"])
def test_serve_topk_window_quant_plain_matches_reference_kernel(form, k):
    U, Vw, cand, seen, codes, scale, bits = _quant_inputs(0)
    if form == "int8":
        ref_q, ref_scale = jnp.asarray(codes), jnp.asarray(scale)
        q, sc = torch.from_numpy(codes), torch.from_numpy(scale)
    else:
        ref_q = jnp.asarray(bits).view(jnp.bfloat16)
        ref_scale = jnp.ones(len(scale), jnp.float32)
        q = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
        sc = torch.ones(len(scale))
    expect = ref_ops.serve_topk_window_quant(jnp.asarray(U), ref_q, ref_scale,
                                             jnp.asarray(cand), jnp.asarray(seen), k,
                                             interpret=True)
    Ut, ct, st = _t(U, cand, seen)
    got = ref.serve_topk_window_quant_ref(Ut, q, sc, ct, st, k)
    _assert_topk(got, expect)
    # equal to the fp32 window form on the dequantized windows
    deq = q.float() * sc[:, None, None]
    for a, b in zip(got, ref.serve_topk_window_ref(Ut, deq, ct, st, k)):
        assert torch.equal(a, b)
    if form == "int8":
        assert scale[7] == np.float32(1e-12) and (codes[7] == 0).all()
        # the all-zero request scores 0.0 everywhere: lowest unseen ids win
        live = cand[7][(cand[7] >= 0) & (seen[7] == 0)][:k]
        np.testing.assert_array_equal(got[1][7, : len(live)].numpy(), live)


@pytest.mark.parametrize("k", [1, 10, 16])
def test_topk_peruser_plain_matches_reference_kernel(k):
    U, V, mask = _dense_inputs()
    expect = ref_ops.recommend_topk_peruser(jnp.asarray(U), jnp.asarray(V),
                                            jnp.asarray(mask), k, interpret=True)
    got = ref.topk_scores_peruser_ref(*_t(U, V, mask), k)
    _assert_topk(got, expect)
    idx = got[1].numpy()
    assert (idx[4] == -1).all()
    assert set(idx[5][idx[5] >= 0]) <= {11, 200, 299}
    # the zero user: every score 0.0, so the lowest unmasked ids win
    unmasked = np.flatnonzero(mask[0] == 0)[:k]
    np.testing.assert_array_equal(idx[0, : len(unmasked)], unmasked)


@pytest.mark.parametrize("B", [256, 100])
def test_dmf_fused_step_plain_matches_reference_kernel(B):
    rng = np.random.default_rng(B)
    u, p, q = (rng.normal(0, 0.5, (B, K)).astype(np.float32) for _ in range(3))
    p[:7] = 0.0
    r = (rng.random(B) < 0.25).astype(np.float32)
    conf = np.where(r > 0, 1.0, 1.0 / 3).astype(np.float32)
    hp = dict(theta=0.1, alpha=0.1, beta=0.1, gamma=0.01)
    expect = ref_ops.dmf_fused_step(*map(jnp.asarray, (u, p, q, r, conf)), **hp,
                                    interpret=True)
    got = ref.dmf_fused_step_ref(*_t(u, p, q, r, conf), hp["theta"], hp["alpha"],
                                 hp["beta"], hp["gamma"])
    for g, e in zip(got[:3], expect[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(got[3]), float(expect[3]), rtol=1e-5)


def test_grads_and_loss_matches_reference_and_fused_step():
    rng = np.random.default_rng(7)
    B = 64
    u, p, q = (rng.normal(0, 0.5, (B, K)).astype(np.float32) for _ in range(3))
    r = (rng.random(B) < 0.25).astype(np.float32)
    conf = np.where(r > 0, 1.0, 1.0 / 3).astype(np.float32)
    rcfg = ref_dmf.DMFConfig(n_users=4, n_items=4, beta=0.1, gamma=0.01)
    pcfg = dmf.DMFConfig(n_users=4, n_items=4, beta=0.1, gamma=0.01)
    expect = ref_dmf._grads_and_loss(*map(jnp.asarray, (u, p, q, r, conf)), rcfg)
    got = dmf._grads_and_loss(*_t(u, p, q, r, conf), pcfg)
    for g, e in zip(got[:3], expect[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(got[3]), float(expect[3]), rtol=1e-5)
    du, gp, dq, loss = ops.dmf_fused_step(*_t(u, p, q, r, conf), theta=pcfg.lr,
                                          alpha=pcfg.alpha, beta=pcfg.beta, gamma=pcfg.gamma)
    torch.testing.assert_close(du, -pcfg.lr * got[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(gp, got[1], rtol=0, atol=1e-6)
    torch.testing.assert_close(dq, -pcfg.lr * got[2], rtol=0, atol=1e-6)
    torch.testing.assert_close(loss, got[3], rtol=1e-6, atol=0)


def test_cpu_wrappers_run_the_plain_versions_and_launch_nothing():
    before = [kern.launches for kern in ops.KERNELS]
    U, Vw, cand, seen = _t(*_window_inputs(3))
    for a, b in zip(ops.serve_topk_window(U, Vw, cand, seen, 10),
                    ref.serve_topk_window_ref(U, Vw, cand, seen, 10)):
        assert torch.equal(a, b)
    U, V, mask = _t(*_dense_inputs(4))
    for a, b in zip(ops.recommend_topk_peruser(U, V, mask, 7),
                    ref.topk_scores_peruser_ref(U, V, mask, 7)):
        assert torch.equal(a, b)
    x = _t(*(np.random.default_rng(5).normal(size=(32, K)).astype(np.float32)
             for _ in range(3)))
    rc = _t(np.ones(32, np.float32), np.ones(32, np.float32))
    for a, b in zip(ops.dmf_fused_step(*x, *rc, theta=0.1, alpha=0.1, beta=0.1, gamma=0.01),
                    ref.dmf_fused_step_ref(*x, *rc, 0.1, 0.1, 0.1, 0.01)):
        assert torch.equal(a, b)
    for a, b in zip(ops.dmf_fused_step_dp(*x, *rc, x[0], theta=0.1, alpha=0.1, beta=0.1,
                                          gamma=0.01, clip=0.5),
                    ref.dmf_fused_step_dp_ref(*x, *rc, x[0], 0.1, 0.1, 0.1, 0.01, 0.5)):
        assert torch.equal(a, b)
    rid = torch.arange(32, dtype=torch.int32)
    assert torch.equal(ops.dp_clip_noise(x[0], rid, 3, clip=0.5, noise_std=0.2),
                       ref.dp_clip_noise_ref(x[0], rid, 3, 0.5, 0.2))
    assert torch.equal(ops.gauss_counter(3, rid, K), dp_noise.gauss_counter_ref(3, rid, K))
    U, V, cand, seen = _t(*_slab_inputs(3))
    for a, b in zip(ops.serve_topk(U, V, cand, seen, 10),
                    ref.serve_topk_ref(U, V, cand, seen, 10)):
        assert torch.equal(a, b)
    U, _, cand, seen, codes, scale, _ = _t(*_quant_inputs(3))
    for a, b in zip(ops.serve_topk_window_quant(U, codes, scale, cand, seen, 10),
                    ref.serve_topk_window_quant_ref(U, codes, scale, cand, seen, 10)):
        assert torch.equal(a, b)
    ids = torch.tensor([3, 0, 3, 7], dtype=torch.int64)
    user_bucket = torch.arange(U.shape[0], dtype=torch.int64)
    for a, b in zip(ops.serve_topk_tiled_quant(ids, U, codes, scale, user_bucket, cand, seen, 10),
                    ref.serve_topk_window_quant_ref(U[ids], codes[ids], scale[ids], cand[ids],
                                                    seen[ids], 10)):
        assert torch.equal(a, b)
    U, V, cand, seen = _t(*_slab_inputs(4))
    rows = ids[:, None]
    user_bucket = torch.arange(U.shape[0], dtype=torch.int64)
    for a, b in zip(ops.serve_topk_rows(ids, U, V, seen, user_bucket, cand, 10, Q=V),
                    ref.serve_topk_window_ref(U[ids], V[rows, cand[ids].clamp_min(0).long()] * 2,
                                              cand[ids], seen[rows, cand[ids].clamp_min(0).long()],
                                              10)):
        assert torch.equal(a, b)
    U, Vs, mask = x[0], x[1][:20].contiguous(), torch.zeros(32, 20, dtype=torch.bool)
    for a, b in zip(ops.recommend_topk(U, Vs, mask, 10), ref.topk_scores_ref(U, Vs, mask, 10)):
        assert torch.equal(a, b)
    for a, b in zip(ops.dmf_grads(*x, *rc, alpha=0.1, beta=0.1, gamma=0.01),
                    ref.dmf_grads_ref(*x, *rc, 0.1, 0.1, 0.01)):
        assert torch.equal(a, b)
    M = torch.eye(32) + x[2][:, :1]
    assert torch.equal(ops.gossip_mix_op(M, x[0]), ref.gossip_mix_ref(M, x[0]))
    assert [kern.launches for kern in ops.KERNELS] == before == [0] * len(ops.KERNELS)
    assert len(ops.KERNELS) == 13


@pytest.mark.parametrize("case", ["dtype", "shape", "k", "device"])
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    U, Vw, cand, seen = _t(*_window_inputs(0, Cw=128))
    if case == "dtype":
        with pytest.raises(TypeError):
            ops.serve_topk_window(U, Vw, cand.long(), seen, 5)
        with pytest.raises(TypeError):
            ops.recommend_topk_peruser(U.double(), Vw.double(), seen, 5)
        with pytest.raises(TypeError):
            ops.gauss_counter(0, cand[:, 0].long(), 10)
        with pytest.raises(TypeError):
            ops.dp_clip_noise(U.double(), cand[:, 0], 0, clip=1.0, noise_std=0.0)
    elif case == "shape":
        with pytest.raises(ValueError):
            ops.serve_topk_window(U, Vw[:, :64], cand, seen, 5)
        with pytest.raises(ValueError):
            ops.dmf_fused_step(U, U, U[:3], U[:, 0], U[:, 0], theta=0.1, alpha=0.1,
                               beta=0.1, gamma=0.1)
        with pytest.raises(ValueError):
            ops.dmf_fused_step_dp(U, U, U, U[:, 0], U[:, 0], U[:4], theta=0.1, alpha=0.1,
                                  beta=0.1, gamma=0.1, clip=1.0)
        with pytest.raises(ValueError):
            ops.dp_clip_noise(U, cand[:3, 0], 0, clip=1.0, noise_std=0.0)
    elif case == "k":
        with pytest.raises(ValueError):
            ops.serve_topk_window(U, Vw, cand, seen, 17)
        with pytest.raises(ValueError):
            ops.recommend_topk_peruser(U, Vw, seen, 0)
        with pytest.raises(ValueError):          # n_cols beyond the stream's KMAX
            ops.gauss_counter(0, cand[:, 0], dp_noise.KMAX + 1)
    else:
        # a tensor on neither the CPU nor a card never reaches the plain path
        with pytest.raises(ValueError):
            ops.serve_topk_window(U.to("meta"), Vw.to("meta"), cand.to("meta"),
                                  seen.to("meta"), 5)
        with pytest.raises(ValueError):
            ops.gauss_counter(0, cand[:, 0].to("meta"), 10)


@pytest.mark.parametrize("case", ["dtype", "shape", "k", "device"])
def test_tiled_wrappers_reject_what_the_kernels_do_not_take(case):
    U, V, cand, seen = _t(*_slab_inputs(0))
    _, _, _, seen_w, codes, scale, _ = _t(*_quant_inputs(0))
    if case == "dtype":
        with pytest.raises(TypeError):
            ops.serve_topk(U, V.double(), cand, seen, 5)
        with pytest.raises(TypeError):
            ops.serve_topk_window_quant(U, codes.float(), scale, cand, seen_w, 5)
        with pytest.raises(TypeError):
            ops.serve_topk_window_quant(U, codes, scale.double(), cand, seen_w, 5)
    elif case == "shape":
        with pytest.raises(ValueError):
            ops.serve_topk(U, V, cand, seen[:, :100], 5)
        with pytest.raises(ValueError):
            ops.serve_topk_window_quant(U, codes, scale[:3], cand, seen_w, 5)
    elif case == "k":
        with pytest.raises(ValueError):
            ops.serve_topk(U, V, cand, seen, 17)
        with pytest.raises(ValueError):
            ops.serve_topk_window_quant(U, codes, scale, cand, seen_w, 0)
    else:
        with pytest.raises(ValueError):
            ops.serve_topk(U.to("meta"), V.to("meta"), cand.to("meta"), seen.to("meta"), 5)
        with pytest.raises(ValueError):
            ops.serve_topk_window_quant(U, codes.to("meta"), scale, cand, seen_w, 5)


@pytest.mark.parametrize("R", [1, 37, 64, 128])
@pytest.mark.parametrize("Cw", [1, 33, 128, 129, 384, 1000, 5000])
@pytest.mark.parametrize("k", [1, 10, 16])
def test_serve_window_layout_fits_the_card_and_covers_every_request(R, Cw, k):
    """The host's choice of kernel 1's layout (shared by kernels 5 and 6),
    pinned on the CPU: one warp a request for Cw ≤ 128, four requests a
    block; ceil(Cw / 128) warps above, at most 16; every request covered,
    within 512 threads and the H100's 232,448 bytes of shared memory a
    block, lane lists long enough for k."""
    from repro_torch.kernels import serve_topk
    lay = serve_topk.window_layout(R, Cw, k)
    if Cw <= 128:
        assert (lay["warps"], lay["rpb"]) == (1, 4)
    else:
        assert lay["warps"] == min(16, -(-Cw // 128))
    assert lay["threads"] == 32 * lay["warps"] * lay["rpb"] <= 512
    assert lay["blocks"] * lay["rpb"] >= R > (lay["blocks"] - 1) * lay["rpb"]
    assert lay["smem_bytes"] <= 232_448
    assert lay["slots"] in (4, 8, 16)
    assert lay["slots"] >= min(k, -(-Cw // (32 * lay["warps"])))


def test_serve_window_layout_of_the_main_paths():
    """Serving (R=64, Cw=384): 3 warps a request, 4 candidates a lane;
    tiled (R=128, Cw=128): a warp a request, 4 requests a block."""
    from repro_torch.kernels import serve_topk
    assert {k: v for k, v in serve_topk.window_layout(64, 384, 10).items()
            if k != "smem_bytes"} == dict(warps=3, rpb=1, slots=4, blocks=64, threads=96)
    assert {k: v for k, v in serve_topk.window_layout(128, 128, 10).items()
            if k != "smem_bytes"} == dict(warps=1, rpb=4, slots=4, blocks=32, threads=128)


@pytest.mark.parametrize("k", [10, 16])
def test_serve_topk_window_per_request_shape_matches_reference_kernel(k):
    """One request (R=1) of the serving shape (Cw=384): the plain version
    against the reference's Pallas kernel, for a random user and an
    all-zero user (every score 0: the lowest unseen candidate ids)."""
    U, Vw, cand, seen = (x[:1] for x in _window_inputs(5, R=8, Cw=384))
    for u in (U, np.zeros_like(U)):
        expect = ref_ops.serve_topk_window(jnp.asarray(u), jnp.asarray(Vw), jnp.asarray(cand),
                                           jnp.asarray(seen), k, interpret=True)
        got = ref.serve_topk_window_ref(*_t(u, Vw, cand, seen), k)
        _assert_topk(got, expect)
    live = cand[0][(cand[0] >= 0) & (seen[0] == 0)][:k]
    np.testing.assert_array_equal(got[1][0, :len(live)].numpy(), live)
