"""The port's shared-V top-k (`ops.recommend_topk`, kernel 4), Eqs. 9-11
gradients (`ops.dmf_grads`, kernel 9) and walk mixing
(`ops.gossip_mix_op`, kernel 10) against the reference's, on the CPU.

The inputs are `tests/test_kernels.py`'s, drawn with numpy from the same
seeds; they go through the reference's `repro.kernels.ops` wrappers (Pallas
in interpret mode) and the port's wrappers on CPU tensors, which run the
plain versions. Tolerances: gradients within 2e-5 abs + 2e-5 rel, plus
the bound on two fp32 orders of the residual's dot (see `_grads_case`); the
mixing product within 1e-4 (2e-2 for bf16 inputs, upcast before the
product in both); top-k values within 1e-5 of the reference's kernel. Top-k
ids are held against the reference's dense oracle (`topk_scores_ref` with
`masked_topk_finalize`, `lax.top_k`'s lowest-id tie order): exactly on
tie-free inputs, and on tie-heavy ones wherever adjacent values differ by
more than 1e-6. Not against the Pallas kernel, whose cross-tile merge can
give an exact tie's slot to a higher id (ROADMAP.md §C). The host's launch
layouts of kernels 4 (`topk_scores.shared_layout`) and 9
(`dmf_update.grads_layout`) are pinned here too. The CUDA kernels are held
against the same plain versions on the card by `chip_smoke.py` and
`tests/test_torch_cuda.py`.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402
from repro_torch.kernels import dmf_update, ops, ref  # noqa: E402

GRAD_TOL = 2e-5
MIX_TOL, MIX_BF16_TOL = 1e-4, 2e-2
TOPK_TOL, TIE_GAP = 1e-5, 1e-6


def _both(*xs):
    """Each numpy array as (jnp array, torch tensor)."""
    return [(jnp.asarray(x), torch.from_numpy(np.ascontiguousarray(x))) for x in xs]


def _grads_case(rng, B, K, hp):
    """Each gradient within GRAD_TOL abs + rel, plus the bound on two fp32
    summation orders of the residual's K-term dot (2·K·2⁻²⁴·Σ|u·v|),
    carried through the residual's factor: c·|v| for gu, c·|u| for gp
    and gq. At the paper's K ≤ 15 the extra term is of GRAD_TOL's size;
    at K=128 two orders differ by up to 3.2e-5 on these inputs."""
    u, p, q = (rng.normal(size=(B, K)).astype(np.float32) for _ in range(3))
    r, c = (rng.random(B).astype(np.float32) for _ in range(2))
    (ju, tu), (jp, tp), (jq, tq), (jr, tr), (jc, tc) = _both(u, p, q, r, c)
    want = ref_ops.dmf_grads(ju, jp, jq, jr, jc, **hp)
    got = ops.dmf_grads(tu, tp, tq, tr, tc, **hp)
    v = p.astype(np.float64) + q
    dot_err = (2 * K * 2.0**-24 * c * np.abs(u * v).sum(-1))[:, None]
    for g, w, factor in zip(got, want, (np.abs(v), np.abs(u), np.abs(u))):
        assert g.dtype == torch.float32 and g.shape == (B, K)
        w = np.asarray(w)
        allowed = GRAD_TOL + GRAD_TOL * np.abs(w) + dot_err * factor
        assert (np.abs(g.numpy() - w) <= allowed).all(), float(np.abs(g.numpy() - w).max())


@pytest.mark.parametrize("B", [64, 256, 300, 1024])
@pytest.mark.parametrize("K", [5, 10, 15, 128])
def test_dmf_grads_matches_reference_kernel(B, K):
    _grads_case(np.random.default_rng(B * K), B, K, dict(alpha=0.1, beta=0.01, gamma=0.02))


def test_dmf_grads_matches_reference_kernel_at_the_micro_bench_shape():
    """`kernels_bench.py`'s shape (B=2048, K=16), where the card's kernel
    takes 64 blocks of 32 rows."""
    _grads_case(np.random.default_rng(0), 2048, 16, dict(alpha=0.1, beta=0.01, gamma=0.01))


@pytest.mark.parametrize("B", [1, 31, 32, 33, 64, 256, 300, 1024, 2047, 2048, 5000, 28_160])
@pytest.mark.parametrize("K", [1, 5, 10, 16, 128])
def test_dmf_grads_layout_covers_every_row_once(B, K):
    """The host's choice of kernel 9's layout, pinned on the CPU: blocks
    of at most one row a thread that together cover rows 0..B-1 once, no
    block without a row, and at least 32 blocks at the micro-bench's
    B=2048."""
    lay = dmf_update.grads_layout(B, K)
    rows, blocks = lay["rows"], lay["blocks"]
    assert 1 <= rows <= lay["threads"] == 128
    starts = np.arange(blocks) * rows
    covered = (starts[:, None] + np.arange(rows)[None, :]).ravel()
    covered = covered[covered < B]
    assert len(covered) == B and len(np.unique(covered)) == B
    assert (blocks - 1) * rows < B
    if B >= 2048:
        assert blocks >= 32


def test_dmf_grads_layout_of_the_main_paths():
    """The training minibatch (B=256, K=10): 8 blocks of 32 rows; the
    micro-bench (B=2048, K=16): 64 blocks of 32 (the forms of
    `chip_smoke.py` time 16, 64 and 128 rows against it)."""
    lay = dmf_update.grads_layout(256, 10)
    assert (lay["rows"], lay["threads"], lay["blocks"]) == (32, 128, 8)
    lay = dmf_update.grads_layout(2048, 16)
    assert (lay["rows"], lay["threads"], lay["blocks"]) == (32, 128, 64)


@settings(max_examples=10, deadline=None)
@given(st.integers(1, 400), st.integers(1, 40), st.integers(0, 99))
def test_dmf_grads_property_matches_reference_kernel(B, K, seed):
    _grads_case(np.random.default_rng(seed), B, K, dict(alpha=0.3, beta=0.2, gamma=0.1))


def test_dmf_grads_is_the_fused_step_without_lr_and_loss():
    """gp is the fused step's message; -θ·gu and -θ·gq its deltas."""
    rng = np.random.default_rng(3)
    x = [torch.from_numpy(rng.normal(0, 0.5, (300, 10)).astype(np.float32)) for _ in range(3)]
    x += [torch.from_numpy(rng.random(300).astype(np.float32)) for _ in range(2)]
    gu, gp, gq = ops.dmf_grads(*x, alpha=0.1, beta=0.1, gamma=0.01)
    du, gp3, dq, _ = ops.dmf_fused_step(*x, theta=0.1, alpha=0.1, beta=0.1, gamma=0.01)
    torch.testing.assert_close(gp, gp3, rtol=0, atol=1e-7)
    torch.testing.assert_close(-0.1 * gu, du, rtol=0, atol=1e-7)
    torch.testing.assert_close(-0.1 * gq, dq, rtol=0, atol=1e-7)


def test_dmf_grads_rejects_bad_arguments():
    u = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        ops.dmf_grads(u, u, torch.zeros(4, 2), torch.zeros(4), torch.zeros(4),
                      alpha=0.1, beta=0.1, gamma=0.1)
    with pytest.raises(TypeError):
        ops.dmf_grads(u.double(), u, u, torch.zeros(4), torch.zeros(4),
                      alpha=0.1, beta=0.1, gamma=0.1)


@pytest.mark.parametrize("I,F", [(128, 128), (200, 333), (512, 64), (77, 1000)])
def test_gossip_mix_matches_reference_kernel(I, F):
    rng = np.random.default_rng(I + F)
    (jM, tM), (jX, tX) = _both(rng.normal(size=(I, I)).astype(np.float32),
                               rng.normal(size=(I, F)).astype(np.float32))
    got = ops.gossip_mix_op(tM, tX)
    assert got.dtype == torch.float32 and got.shape == (I, F)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_ops.gossip_mix_op(jM, jX)),
                               rtol=MIX_TOL, atol=MIX_TOL)


def test_gossip_mix_bf16_inputs_upcast_like_the_reference():
    rng = np.random.default_rng(0)
    M = rng.normal(size=(64, 64)).astype(np.float32)
    X = rng.normal(size=(64, 32)).astype(np.float32)
    got = ops.gossip_mix_op(torch.from_numpy(M).bfloat16(), torch.from_numpy(X).bfloat16())
    want = ref_ops.gossip_mix_op(jnp.asarray(M, jnp.bfloat16), jnp.asarray(X, jnp.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MIX_BF16_TOL,
                               atol=MIX_BF16_TOL)
    # the same rounding to bf16 on both sides: the fp32 products agree closely
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MIX_TOL, atol=MIX_TOL)


def test_gossip_mix_on_a_walk_matrix_equals_the_neighbor_gather():
    """Y = M @ X on a real walk matrix equals Σ_s wgt[i, s]·X[idx[i, s]]."""
    from repro_torch.core import graph
    from repro_torch.data import synthetic_poi
    ds = synthetic_poi.foursquare_like(reduced=True)
    gcfg = graph.GraphConfig(n_neighbors=2, walk_length=3)
    M = graph.walk_propagation_matrix(graph.build_adjacency(ds.user_coords, ds.user_city, gcfg),
                                      gcfg)
    nbr = graph.neighbor_table_from_dense(M, device="cpu")
    X = torch.from_numpy(np.random.default_rng(1).normal(size=(ds.n_users, 40)).astype(np.float32))
    got = ops.gossip_mix_op(torch.from_numpy(M), X)
    gather = (nbr.wgt[:, :, None] * X[nbr.idx]).sum(1)
    torch.testing.assert_close(got, gather, rtol=1e-5, atol=1e-5)


def _topk_case(rng, I, J, K, p_mask=0.1):
    U = rng.normal(size=(I, K)).astype(np.float32)
    V = rng.normal(size=(J, K)).astype(np.float32)
    mask = rng.random((I, J)) < p_mask
    return U, V, mask


def _hold_topk(U, V, mask, k, tie_free: bool):
    (jU, tU), (jV, tV), (jm, tm) = _both(U, V, mask)
    vals, idx = ops.recommend_topk(tU, tV, tm, k)
    assert vals.dtype == torch.float32 and idx.dtype == torch.int32
    assert vals.shape == idx.shape == (U.shape[0], k)
    kv, _ = ref_ops.recommend_topk(jU, jV, jm, k)
    np.testing.assert_allclose(vals.numpy(), np.asarray(kv), rtol=TOPK_TOL, atol=TOPK_TOL)
    ov, oi = ref_ref.masked_topk_finalize(*ref_ref.topk_scores_ref(jU, jV, jm, k))
    ov, oi, got = np.asarray(ov), np.asarray(oi), idx.numpy()
    if tie_free:
        np.testing.assert_array_equal(got, oi)
        return
    # a slot's id is fixed wherever its value is apart from both neighbours
    gap = np.full(ov.shape, np.inf)
    gap[:, 1:] = np.abs(np.diff(ov, axis=1))
    gap[:, :-1] = np.minimum(gap[:, :-1], np.abs(np.diff(ov, axis=1)))
    apart = gap > TIE_GAP
    np.testing.assert_array_equal(got[apart], oi[apart])


@pytest.mark.parametrize("I,J,K,k", [
    (128, 256, 8, 5), (150, 500, 12, 10), (64, 1000, 15, 16), (256, 256, 5, 1),
])
def test_recommend_topk_matches_reference(I, J, K, k):
    U, V, mask = _topk_case(np.random.default_rng(I + J + k), I, J, K)
    _hold_topk(U, V, mask, k, tie_free=True)


def test_recommend_topk_ties_go_to_the_lowest_id():
    """Zero users and repeated item rows: exact ties everywhere. A zero
    user's slate is items 0..9 (none of them masked in those rows)."""
    rng = np.random.default_rng(5)
    U, V, mask = _topk_case(rng, 40, 600, 6, p_mask=0.3)
    U[:8] = 0.0                  # every score exactly 0
    mask[:8, :10] = False
    V[300:400] = V[7]            # repeated item vectors
    mask[9] = True               # all seen: dead slots
    mask[10, :] = True
    mask[10, [3, 599]] = False   # fewer unseen items than k
    _hold_topk(U, V, mask, 10, tie_free=False)
    got = ops.recommend_topk(*(torch.from_numpy(x) for x in (U, V, mask)), 10)
    assert (got[1][:8] == torch.arange(10, dtype=torch.int32)).all()   # all-zero scores
    assert (got[1][9] == -1).all() and (got[0][9] == ref.NEG_INF).all()
    assert got[1][10, :2].tolist() in ([3, 599], [599, 3]) and (got[1][10, 2:] == -1).all()


@settings(max_examples=8, deadline=None)
@given(st.integers(4, 100), st.integers(8, 300), st.integers(1, 8), st.integers(0, 99))
def test_recommend_topk_property_sorted_unmasked_and_equal(I, J, k, seed):
    rng = np.random.default_rng(seed)
    U, V, mask = _topk_case(rng, I, J, 6, p_mask=0.2)
    k = min(k, J)
    vals, idx = (x.numpy() for x in ops.recommend_topk(
        *(torch.from_numpy(x) for x in (U, V, mask)), k))
    assert (np.diff(vals, axis=1) <= 1e-6).all(), "values sorted desc"
    for i in range(I):
        valid = idx[i][idx[i] >= 0]
        assert (valid < J).all()
        assert not mask[i, valid].any(), "masked (train) item recommended"
    _hold_topk(U, V, mask, k, tie_free=False)


def test_recommend_topk_rejects_bad_arguments():
    U, V, m = torch.zeros(3, 4), torch.zeros(5, 4), torch.zeros(3, 5, dtype=torch.bool)
    with pytest.raises(ValueError):
        ops.recommend_topk(U, V, m, 0)
    with pytest.raises(ValueError):
        ops.recommend_topk(U, V, m, 17)
    with pytest.raises(ValueError):
        ops.recommend_topk(U, torch.zeros(5, 3), m, 2)
    with pytest.raises(TypeError):
        ops.recommend_topk(U.double(), V, m, 2)


def _few_items_per_lane(J, threads, cluster):
    """Items one lane of the few-users form scores: a user's 128-item
    chunks in contiguous shares over ``cluster`` blocks, warp w of a block
    streaming its share's chunks w, w + warps, ..., 4 items of each chunk
    a lane."""
    chunks, warps = -(-J // 128), threads // 32
    return max(1, 4 * -(-(-(-chunks // cluster)) // warps))


@pytest.mark.parametrize("R", [1, 2, 7, 131, 132, 133, 1100, 6524])
@pytest.mark.parametrize("J,K", [(1, 10), (31, 10), (3197, 10), (6000, 10), (3197, 12),
                                 (500, 64), (100, 400)])
@pytest.mark.parametrize("k", [1, 10, 16])
def test_recommend_topk_layout_fits_the_card_and_covers_every_row(R, J, K, k):
    """The host's choice of kernel 4's layout, pinned on the CPU: below a
    block an SM the few-users form (a block per user), at or above it the
    many-users form; shared memory within the H100's 232,448 bytes a block;
    every user and item covered; lane lists long enough for k."""
    from repro_torch.kernels import topk_scores
    lay = topk_scores.shared_layout(R, J, K, k)
    assert lay["many"] == (R >= 132)
    assert lay["smem_bytes"] <= 232_448
    assert lay["threads"] % 32 == 0 and 32 <= lay["threads"] <= 512
    assert lay["slots"] in (4, 8, 16)
    if lay["many"]:
        assert lay["threads"] == 512 and 1 <= lay["blocks"] <= 132
        tiles = -(-R // 2)                                 # 2 users a warp
        ranges = [(b * tiles // lay["blocks"], (b + 1) * tiles // lay["blocks"])
                  for b in range(lay["blocks"])]
        assert ranges[0][0] == 0 and ranges[-1][1] == tiles
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        j_tile = lay["tile"]
        assert j_tile % 4 == 0 and 4 * K * j_tile + 2048 == lay["smem_bytes"]
        assert -(-J // j_tile) * j_tile >= J
        per_lane = 4 * -(-J // 128)                        # 4 items a lane a pass
    else:
        assert lay["cluster"] in (1, 2, 3, 4) and lay["blocks"] == R * lay["cluster"]
        assert lay["cluster"] * lay["threads"] // 32 <= 16           # lists one merge takes
        assert 1 <= lay["tile"] <= 4                                 # ring stages a warp
        # a stage: the chunk's rows with 4 floats of alignment room, its mask window
        stage = 4 * (128 * K + 4) + 144
        assert stage * lay["tile"] * lay["threads"] // 32 + 2048 == lay["smem_bytes"]
        per_lane = _few_items_per_lane(J, lay["threads"], lay["cluster"])
    assert lay["slots"] >= min(k, per_lane)


def test_recommend_topk_layout_of_the_main_paths():
    """One DMF request (R=1) takes the few-users form on a cluster of 4
    blocks of 4 warps with 8-slot lists and a 2-chunk ring; the MF/BPR
    states (R=6,524) the many-users form on 132 blocks with V staged in
    one tile."""
    from repro_torch.kernels import topk_scores
    one = topk_scores.shared_layout(1, 3197, 10, 10)
    assert (one["many"], one["cluster"], one["threads"], one["blocks"], one["slots"],
            one["tile"]) == (False, 4, 128, 4, 8, 2)
    mf = topk_scores.shared_layout(6524, 3197, 10, 10)
    assert (mf["many"], mf["blocks"], mf["slots"], mf["tile"]) == (True, 132, 16, 3200)
    with pytest.raises(ValueError):           # a row too wide to stage 4 items
        topk_scores.shared_layout(6524, 100, 20_000, 10)


@pytest.mark.parametrize("k", [10, 16])
def test_recommend_topk_per_request_shape_matches_reference(k):
    """The per-request loop's shape (R=1, J=3,197, K=10): the plain version
    against the reference's Pallas kernel (values) and dense oracle (ids),
    for a trained-like user and an all-zero user (every score 0: the lowest
    unmasked ids)."""
    rng = np.random.default_rng(17 + k)
    U, V, mask = _topk_case(rng, 1, 3197, 10, p_mask=0.01)
    _hold_topk(U, V, mask, k, tie_free=True)
    zero = np.zeros_like(U)
    _hold_topk(zero, V, mask, k, tie_free=False)
    got = ops.recommend_topk(*(torch.from_numpy(x) for x in (zero, V, mask)), k)
    assert got[1][0].tolist() == np.flatnonzero(~mask[0])[:k].tolist()
    assert (got[0] == 0).all()
