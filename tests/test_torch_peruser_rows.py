"""Kernel 2 reading rows in place (`recommend_topk_peruser(..., Q=, rows=)`)
and its four callers, on the CPU.

The same numpy inputs, drawn from a fixed seed, go through the reference's
`repro.kernels.ops.recommend_topk_peruser` (Pallas in interpret mode) on
the materialized rows ``(U, P[rows] + Q[rows], mask[rows])`` and through
the port's wrapper on ``(U, P, mask, Q=Q, rows=rows)``, which on CPU
tensors runs the plain version on those rows. Tolerances as in
`tests/test_torch_kernels.py`: indices equal, values within 1e-6 abs +
1e-6 rel (the two frameworks sum over K in another order). The callers
(`dmf.evaluate` unchunked and chunked, the engine's dense dispatches) are
held bit for bit against the kernel on the materialized rows, as they
called it before. The CUDA kernel itself is held on the card by
`tests/test_torch_cuda.py` and `chip_smoke.py`.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.core import dmf, metrics  # noqa: E402
from repro_torch.kernels import ops, ref, topk_scores  # noqa: E402
from repro_torch.serving import engine  # noqa: E402


def _rows_inputs(seed, N, J, K):
    """U (N, K), P and Q (N, J, K), mask (N, J) int8, with a zero user, a
    row whose v = p + q is 0 on every third item, an all-masked row and a
    row with fewer unmasked items than 16."""
    rng = np.random.default_rng(seed)
    U = rng.normal(0, 1, (N, K)).astype(np.float32)
    U[0] = 0.0
    P = rng.normal(0, 1, (N, J, K)).astype(np.float32)
    Q = rng.normal(0, 1, (N, J, K)).astype(np.float32)
    P[1, ::3] = -Q[1, ::3]
    mask = (rng.random((N, J)) < 0.1).astype(np.int8)
    mask[2] = 1
    mask[3] = 1
    mask[3, rng.choice(J, 3, replace=False)] = 0
    return U, P, Q, mask


def _rows(seed, R, N):
    """R row ids of N, unsorted, with a repeat and (R > 2) the odd row 1."""
    rng = np.random.default_rng(seed + 1)
    rows = rng.integers(0, N, R).astype(np.int64)
    if R > 2:
        rows[1], rows[2] = rows[0], 1
    return rows


def _assert_topk(port, reference):
    (pv, pi), (rv, ri) = port, reference
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k", [1, 7, 16])
@pytest.mark.parametrize("K", [8, 10])
@pytest.mark.parametrize("J", [37, 300])
@pytest.mark.parametrize("R", [1, 5, 17])
def test_rows_and_q_forms_match_reference_kernel(R, J, K, k):
    N = R + 4
    U, P, Q, mask = _rows_inputs(R * J + K, N, J, K)
    rows = _rows(R + k, R, N)
    Ur = U[:R]
    expect = ref_ops.recommend_topk_peruser(jnp.asarray(Ur), jnp.asarray(P[rows] + Q[rows]),
                                            jnp.asarray(mask[rows]), k, interpret=True)
    Ut, Pt, Qt, mt, rt = (torch.from_numpy(np.ascontiguousarray(x))
                          for x in (Ur, P, Q, mask, rows))
    got = ops.recommend_topk_peruser(Ut, Pt, mt, k, Q=Qt, rows=rt)
    _assert_topk(got, expect)
    # V rows in place, and slices of P and Q at an odd start
    for a, b in zip(ops.recommend_topk_peruser(Ut, Pt + Qt, mt, k, rows=rt), got):
        assert torch.equal(a, b)
    s = 1
    sliced = ops.recommend_topk_peruser(torch.from_numpy(U[s:s + R]), Pt[s:s + R], mt[s:s + R],
                                        k, Q=Qt[s:s + R])
    for a, b in zip(sliced, ref.topk_scores_peruser_ref(torch.from_numpy(U[s:s + R]),
                                                        Pt[s:s + R] + Qt[s:s + R],
                                                        mt[s:s + R], k)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["q_shape", "q_dtype", "rows_dtype", "rows_int32",
                                  "rows_shape", "rows_2d", "rows_range", "rows_negative",
                                  "v_rows_shape"])
def test_rows_and_q_wrapper_rejects_what_the_kernel_does_not_take(case):
    U, P, Q, mask = (torch.from_numpy(x) for x in _rows_inputs(0, 6, 40, 10))
    rows = torch.tensor([5, 0, 3], dtype=torch.int64)
    U3 = U[:3]
    with pytest.raises((TypeError, ValueError, IndexError)) as err:
        if case == "q_shape":
            ops.recommend_topk_peruser(U3, P, mask, 5, Q=Q[:, :30], rows=rows)
        elif case == "q_dtype":
            ops.recommend_topk_peruser(U3, P, mask, 5, Q=Q.double(), rows=rows)
        elif case == "rows_dtype":
            ops.recommend_topk_peruser(U3, P, mask, 5, rows=rows.float())
        elif case == "rows_int32":       # ids are int64, as the engine's
            ops.recommend_topk_peruser(U3, P, mask, 5, rows=rows.int())
        elif case == "rows_shape":
            ops.recommend_topk_peruser(U3, P, mask, 5, rows=rows[:2])
        elif case == "rows_2d":
            ops.recommend_topk_peruser(U3, P, mask, 5, rows=rows[:, None])
        elif case == "rows_range":
            ops.recommend_topk_peruser(U3, P, mask, 5, rows=torch.tensor([5, 6, 0]))
        elif case == "rows_negative":
            ops.recommend_topk_peruser(U3, P, mask, 5, rows=torch.tensor([0, -1, 2]))
        else:              # without rows, V must hold one row a request
            ops.recommend_topk_peruser(U3, P, mask, 5)
    expected = {"q_dtype": TypeError, "rows_dtype": TypeError, "rows_int32": TypeError,
                "rows_range": IndexError, "rows_negative": IndexError}.get(case, ValueError)
    assert err.type is expected


def _state(seed, I, J, K):
    rng = np.random.default_rng(seed)
    U, P, Q = (torch.from_numpy(rng.normal(0, 0.3, s).astype(np.float32))
               for s in ((I, K), (I, J, K), (I, J, K)))
    P[:, ::5] = 0.0                      # untouched items: scores tie at 0 with Q = 0 there
    Q[:, ::5] = 0.0
    return dmf.DMFState(U=U, P=P, Q=Q)


def _interactions(seed, I, J, n):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, I, n), rng.integers(0, J, n)], axis=1).astype(np.int64)


@pytest.mark.parametrize("chunk", [None, 1, 3, 7, 64])
def test_evaluate_reads_p_and_q_in_place(chunk):
    """`evaluate` through P and Q, unchunked and in chunks that start at
    odd rows, gives the metrics of the kernel on materialized V = P + Q."""
    I, J, K = 23, 150, 10
    state = _state(3, I, J, K)
    train, test = _interactions(4, I, J, 200), _interactions(5, I, J, 60)
    got = dmf.evaluate(state, train, test, I, J, chunk_users=chunk, device="cpu")
    mask = torch.as_tensor(metrics.masks_from_interactions(I, J, train))
    _, idx = ops.recommend_topk_peruser(state.U, state.P + state.Q, mask, 10)
    want = metrics.evaluate_ranking_from_topk(
        idx.numpy(), metrics.masks_from_interactions(I, J, test), (5, 10))
    assert got == want


def test_engine_dense_dispatches_read_rows_in_place():
    """The dense dispatch (`_dispatch_rows` without pruning, on V with
    ``Q=None`` and on P and Q) gives the kernel's slates on the gathered
    rows bit for bit in both forms, for repeated and unsorted ids."""
    I, J, K = 19, 90, 10
    st = _state(6, I, J, K)
    V = st.P + st.Q
    seen = torch.as_tensor(np.random.default_rng(7).random((I, J)) < 0.2).to(torch.int8)
    uids = torch.tensor([4, 0, 17, 4, 9, 1, 18, 3], dtype=torch.int64)
    want = ops.recommend_topk_peruser(st.U[uids], V[uids], seen[uids], 10)
    for got in (engine._dispatch_rows(st.U, V, None, seen, None, None, uids, 10, False),
                engine._dispatch_rows(st.U, st.P, st.Q, seen, None, None, uids, 10, False)):
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_serving_engine_dense_recommend_equals_gathered_rows():
    """`ServingEngine.recommend` with ``prune=False`` and
    `serve_microbatch` serve the slates of the kernel on the gathered
    rows."""
    from repro_torch.serving import ServingConfig, ServingEngine
    from repro_torch.serving.candidates import CandidateIndex
    I, J, K = 12, 70, 10
    st = _state(8, I, J, K)
    seen = np.random.default_rng(9).random((I, J)) < 0.2
    seen[:, 0] = True                    # no cold user
    index = CandidateIndex(bucket_items=np.arange(J, dtype=np.int32)[None],
                           bucket_size=np.array([J], np.int32), city_size=np.array([J], np.int32),
                           user_bucket=np.zeros(I, np.int32), n_items=J)
    eng = ServingEngine(st, index, ServingConfig(microbatch=4, k=10, prune=False,
                                                 fallback=False), seen=seen, device="cpu")
    ids = np.array([3, 11, 0, 3, 7, 5])
    vals, idx = eng.recommend(ids)
    V = st.P + st.Q
    wv, wi = ops.recommend_topk_peruser(st.U[ids], V[ids], torch.as_tensor(seen[ids]), 10)
    np.testing.assert_array_equal(vals, wv.numpy())
    np.testing.assert_array_equal(idx, wi.numpy())
    mv, mi, _ = eng.serve_microbatch(ids[:4])
    np.testing.assert_array_equal(mv, wv.numpy()[:4])
    np.testing.assert_array_equal(mi, wi.numpy()[:4])


@pytest.mark.parametrize("R", [1, 7, 33, 64, 131, 132, 1024, 6524])
@pytest.mark.parametrize("J,K", [(1, 10), (129, 10), (3197, 10), (3197, 8), (500, 64)])
@pytest.mark.parametrize("k", [1, 10, 16])
@pytest.mark.parametrize("fused", [False, True])
def test_peruser_layout_fits_the_card_and_covers_every_item(R, J, K, k, fused):
    """The host's choice of kernel 2's layout, pinned on the CPU: the
    few-users form on a cluster of 2 or 4 blocks below a block an SM, the
    many-users form (a block of 4 warps a user) at or above it; at most 16
    warps' lists a user, shared memory within the H100's 232,448 bytes a
    block, lane lists long enough for k over the items a lane scores."""
    lay = topk_scores.peruser_layout(R, J, K, k, fused=fused)
    chunks = -(-J // 128)
    stage = 4 * (128 * K + 4) * (2 if fused else 1) + 144
    if R >= 132:              # 4 warps a user, fewer where a wide K leaves no room
        assert lay["cluster"] == 1
        assert lay["warps"] == min(4, (232_448 - 2048) // (lay["stages"] * stage))
    else:
        assert lay["cluster"] == min(2 if 4 * R >= 132 else 4, chunks)
    assert lay["cluster"] * lay["warps"] <= 16 and lay["threads"] == 32 * lay["warps"]
    assert lay["blocks"] == R * lay["cluster"] and 1 <= lay["stages"] <= 4
    assert lay["smem_bytes"] == lay["warps"] * lay["stages"] * stage + 2048 <= 232_448
    # the block with the most chunks, its warp with the most, 4 items a chunk a lane
    per_block = max((b + 1) * chunks // lay["cluster"] - b * chunks // lay["cluster"]
                    for b in range(lay["cluster"]))
    per_lane = 4 * -(-per_block // lay["warps"])
    assert lay["slots"] in (4, 8, 16) and lay["slots"] >= min(k, max(per_lane, 1))


def test_peruser_layout_of_the_main_paths():
    """Serving (R=64) takes a cluster of 2 blocks of 8 warps, 8-slot lists;
    evaluate (R=6,524) and its 1,024-user chunks a block of 4 warps a user
    with 16-slot lists, 5 blocks an SM on V and 2 through P and Q."""
    serving = topk_scores.peruser_layout(64, 3197, 10, 10)
    assert (serving["cluster"], serving["warps"], serving["slots"], serving["blocks"]) == (
        2, 8, 8, 128)
    for R in (1024, 6524):
        for fused, per_sm in ((False, 5), (True, 2)):
            lay = topk_scores.peruser_layout(R, 3197, 10, 10, fused=fused)
            assert (lay["cluster"], lay["warps"], lay["stages"], lay["slots"]) == (1, 4, 2, 16)
            assert 233_472 // (lay["smem_bytes"] + 1024) == per_sm   # 228 KB an SM
    with pytest.raises(ValueError):           # a 128-item chunk wider than shared memory
        topk_scores.peruser_layout(64, 3197, 500, 10)
