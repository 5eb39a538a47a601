"""Kernel 5 reading the serving engine's state in place
(`ops.serve_topk_rows`), and the engine's pruned dispatches through it, on
the CPU.

The same numpy inputs, drawn from a fixed seed, go through the reference's
`repro.kernels.ops.serve_topk` (Pallas in interpret mode) on the requests'
whole item slabs ``V[ids]`` and its `ops.serve_topk_window` on the
gathered windows, and through the port's in-place wrapper on the state
itself, which on CPU tensors runs its plain version
(`ref.serve_topk_rows_ref`: the gathers, then `ref.serve_topk_window_ref`).
Tolerances:

* the in-place plain version, with and without Q, against the route the
  engine took before (gather the windows of V, or of P and Q and add them,
  then the window kernel's plain version): equal, bit for bit, on repeated
  and unsorted ids, a bucket of padding only, an all-seen user, an
  all-zero user and k above the live candidates;
* against the reference's kernels: values within 1e-6 abs + 1e-6 rel (sums
  over K in another order, C2); ids equal where no two candidate scores of
  the request lie within that tolerance, and equal to the reference's jnp
  oracle (`repro.kernels.ref.serve_topk_ref`, `lax.top_k` on dense masked
  scores) everywhere;
* the engine's pruned `recommend` and `serve_microbatch` against the
  reference's engine as `tests/test_torch_serving.py` holds them.

The CUDA kernel itself is held on the card by `tests/test_torch_cuda.py`
and `chip_smoke.py`.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import dmf as ref_dmf  # noqa: E402
from repro.core import graph as ref_graph  # noqa: E402
from repro.data import synthetic_poi as ref_poi  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_kernels  # noqa: E402
from repro.serving import ServingConfig as RefServingConfig  # noqa: E402
from repro.serving import ServingEngine as RefServingEngine  # noqa: E402
from repro.serving import index_from_dataset as ref_index  # noqa: E402
from repro_torch.core import dmf  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.serving import ServingConfig, ServingEngine, index_from_dataset  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402

TOL = 1e-6


def _state(seed, I=90, J=700, K=10, Cw=160, n_buckets=7, R=33):
    """Numpy serving state: U (I, K) with an all-zero user (3); V and Q
    (I, J, K) with repeated rows (user 5); seen (I, J) with an all-seen
    user (2); bucket_items (n_buckets, Cw) ascending ids, bucket 0 full,
    bucket 1 padding only, bucket 2 three ids; user_bucket (I,) sending
    users 0-2 to buckets 0, 1, 0 and user 4 to bucket 2; R ids, unsorted,
    with repeats and odd ids."""
    rng = np.random.default_rng(seed)
    bucket_items = np.full((n_buckets, Cw), -1, np.int32)
    for b in range(n_buckets):
        n = (Cw, 0, 3)[b] if b < 3 else int(rng.integers(1, Cw + 1))
        bucket_items[b, :n] = np.sort(rng.choice(J, n, replace=False))
    user_bucket = rng.integers(0, n_buckets, I).astype(np.int64)
    user_bucket[:5] = (0, 1, 0, 0, 2)        # user 4: three unseen candidates
    U = rng.normal(0, 1, (I, K)).astype(np.float32)
    U[3] = 0.0
    V = rng.normal(0, 1, (I, J, K)).astype(np.float32)
    Q = rng.normal(0, 1, (I, J, K)).astype(np.float32)
    V[5, ::2] = V[5, -1]
    Q[5, ::2] = Q[5, -1]
    seen = (rng.random((I, J)) < 0.1).astype(np.int8)
    seen[2] = 1
    seen[4, bucket_items[2, :3]] = 0
    ids = rng.permutation(I)[:R].astype(np.int64)
    ids[:6] = (4, 0, 1, 2, 3, 5)
    ids[7] = ids[6]
    if R > 8:
        ids[8] = 81 % I
    return dict(ids=ids, U=U, V=V, Q=Q, seen=seen, user_bucket=user_bucket,
                bucket_items=bucket_items)


def _t(s):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in s.items()}


def _gathered_route(t, k, with_q):
    """The engine's pruned dispatch before it read the state in place: the
    gathers (and the add), then the window kernel (its plain version on
    the CPU)."""
    ids = t["ids"]
    cand = t["bucket_items"][t["user_bucket"][ids]]
    safe = cand.clamp_min(0).long()
    rows = ids[:, None]
    vw = t["V"][rows, safe] + t["Q"][rows, safe] if with_q else t["V"][rows, safe]
    return ops.serve_topk_window(t["U"][ids], vw, cand, t["seen"][rows, safe], k)


def _rows(t, k, with_q):
    return ops.serve_topk_rows(t["ids"], t["U"], t["V"], t["seen"], t["user_bucket"],
                               t["bucket_items"], k, Q=t["Q"] if with_q else None)


@pytest.mark.parametrize("K", [8, 10])
@pytest.mark.parametrize("k", [1, 10, 16])
@pytest.mark.parametrize("with_q", [False, True], ids=["V", "P+Q"])
def test_in_place_plain_equals_the_gather_then_window_route(with_q, k, K):
    t = _t(_state(k + K, K=K))
    got = _rows(t, k, with_q)
    for a, b in zip(got, _gathered_route(t, k, with_q)):
        assert torch.equal(a, b)
    vals, idx = got
    R = t["ids"].shape[0]
    assert vals.shape == idx.shape == (R, k) and idx.dtype == torch.int32
    # a bucket of padding only (row 2, user 1) and an all-seen user (row 3):
    # no candidate at all
    for r in (2, 3):
        assert (idx[r] == -1).all() and (vals[r] == ref.NEG_INF).all()
    # three unseen candidates (row 0, user 4): k above them leaves the rest dead
    assert int((idx[0] >= 0).sum()) == min(k, 3)
    assert (idx[0, 3:] == -1).all() and (vals[0, 3:] == ref.NEG_INF).all()
    # an all-zero user (row 4) scores every candidate 0: the lowest unseen ids
    live = [c for c in t["bucket_items"][0].tolist() if c >= 0 and not t["seen"][3, c]]
    np.testing.assert_array_equal(idx[4].numpy(), live[:k])
    assert (vals[4] == 0).all()
    # repeated ids give the same slate
    assert torch.equal(idx[6], idx[7]) and torch.equal(vals[6], vals[7])


@pytest.mark.parametrize("k", [1, 10, 16])
@pytest.mark.parametrize("with_q", [False, True], ids=["V", "P+Q"])
def test_in_place_plain_matches_the_reference_kernels(with_q, k):
    s = _state(200 + k)
    got = _rows(_t(s), k, with_q)
    ids = s["ids"]
    V = s["V"] + s["Q"] if with_q else s["V"]
    cand = s["bucket_items"][s["user_bucket"][ids]]
    safe = np.maximum(cand, 0)
    U, slab, seen = jnp.asarray(s["U"][ids]), jnp.asarray(V[ids]), jnp.asarray(s["seen"][ids])
    win = V[ids[:, None], safe]
    seen_w = s["seen"][ids[:, None], safe]
    slab_out = ref_ops.serve_topk(U, slab, jnp.asarray(cand), seen, k, interpret=True)
    window_out = ref_ops.serve_topk_window(U, jnp.asarray(win), jnp.asarray(cand),
                                           jnp.asarray(seen_w), k, interpret=True)
    _, oracle = ref_kernels.serve_topk_ref(U, slab, jnp.asarray(cand), seen, k)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(oracle))
    scores = np.where((cand >= 0) & (seen_w == 0), (s["U"][ids][:, None] * win).sum(-1), np.nan)
    for want_v, want_i in (slab_out, window_out):
        want_v, want_i = np.asarray(want_v), np.asarray(want_i)
        np.testing.assert_allclose(got[0].numpy(), want_v, rtol=TOL, atol=TOL)
        for r, slot in np.argwhere(got[1].numpy() != want_i):
            v = float(want_v[r, slot])
            near = np.abs(scores[r] - v) <= TOL + TOL * abs(v)
            assert near.sum() >= 2, (r, slot, got[1][r, slot], want_i[r, slot])


@pytest.mark.parametrize("with_q", [False, True], ids=["V", "P+Q"])
def test_an_id_past_the_slab_is_no_candidate(with_q):
    """An id ≥ J in a bucket row reads nothing and never enters a slate:
    the slates are those of the same bucket with that slot padded."""
    t = _t(_state(9, J=300))
    padded = {**t, "bucket_items": t["bucket_items"].clone()}
    t["bucket_items"] = t["bucket_items"].clone()
    last = int((t["bucket_items"][3] >= 0).sum()) - 1     # ids stay ascending
    t["bucket_items"][0, -1] = 300
    t["bucket_items"][3, last] = 10**6
    padded["bucket_items"][0, -1] = -1
    padded["bucket_items"][3, last] = -1
    for a, b in zip(_rows(t, 10, with_q), _rows(padded, 10, with_q)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["id range", "negative id", "bucket range", "negative bucket",
                                  "ids dtype", "bucket dtype", "V dtype", "Q shape",
                                  "seen shape", "user_bucket dtype", "k"])
def test_in_place_wrapper_refuses_what_the_kernel_does_not_take(case):
    t = _t(_state(3, I=20, J=50, Cw=24, R=8))
    args = dict(ids=t["ids"] % 20, U=t["U"], V=t["V"], seen=t["seen"],
                user_bucket=t["user_bucket"], bucket_items=t["bucket_items"], k=5, Q=t["Q"])
    err = {"id range": IndexError, "negative id": IndexError, "bucket range": IndexError,
           "negative bucket": IndexError, "ids dtype": TypeError, "bucket dtype": TypeError,
           "V dtype": TypeError, "user_bucket dtype": TypeError}.get(case, ValueError)
    if case in ("id range", "negative id"):
        args["ids"] = args["ids"].clone()
        args["ids"][3] = 20 if case == "id range" else -1
    elif case in ("bucket range", "negative bucket"):
        args["user_bucket"] = args["user_bucket"].clone()
        args["user_bucket"][args["ids"][2]] = 7 if case == "bucket range" else -1
    elif case == "ids dtype":
        args["ids"] = args["ids"].int()
    elif case == "bucket dtype":
        args["bucket_items"] = args["bucket_items"].long()
    elif case == "V dtype":
        args["V"] = args["V"].double()
    elif case == "Q shape":
        args["Q"] = args["Q"][:, :49]
    elif case == "seen shape":
        args["seen"] = args["seen"][:19]
    elif case == "user_bucket dtype":
        args["user_bucket"] = args["user_bucket"].int()
    else:
        args["k"] = 17
    before = ops.serve_topk_rows.launches
    with pytest.raises(err):
        ops.serve_topk_rows(**args)
    assert ops.serve_topk_rows.launches == before == 0


# --------------------------------------------------------------- the engine
MICROBATCH = 32
CFG = dict(dim=10, alpha=0.1, beta=0.1, gamma=0.01, lr=0.1, neg_samples=3, batch_size=128)


@pytest.fixture(scope="module")
def engines():
    ds = ref_poi.foursquare_like(reduced=True)
    gcfg = ref_graph.GraphConfig(n_neighbors=2, walk_length=3)
    ref_nbr = ref_graph.walk_neighbor_table(ref_graph.build_adjacency(
        ds.user_coords, ds.user_city, gcfg), gcfg)
    cfg = ref_dmf.DMFConfig(n_users=ds.n_users, n_items=ds.n_items, **CFG)
    st = ref_dmf.fit(cfg, ds.train, ref_nbr, epochs=2).state
    U, P, Q = (np.asarray(x) for x in (st.U, st.P, st.Q))
    ref_eng = RefServingEngine(
        ref_dmf.DMFState(U=jnp.asarray(U), P=jnp.asarray(P), Q=jnp.asarray(Q)), ref_index(ds),
        RefServingConfig(microbatch=MICROBATCH, k=10, interpret=True), train=ds.train)
    eng = ServingEngine(dmf.state_from_numpy(U, P, Q, device="cpu"), index_from_dataset(ds),
                        ServingConfig(microbatch=MICROBATCH, k=10), train=ds.train, device="cpu")
    ids = np.concatenate([np.random.default_rng(4).permutation(ds.n_users)[:3 * MICROBATCH - 7],
                          [-3, ds.n_users + 5]])
    return ref_eng, eng, ids


def _oracle_ids(ref_eng, rows):
    U, V, seen = (np.asarray(x) for x in (ref_eng.state.U, ref_eng.V, ref_eng.seen))
    cand = np.asarray(ref_eng._bucket_items)[np.asarray(ref_eng._user_bucket)[rows]]
    safe = np.maximum(cand, 0)
    _, idx = ref_kernels.serve_topk_window_ref(
        jnp.asarray(U[rows]), jnp.asarray(V[rows[:, None], safe]), jnp.asarray(cand),
        jnp.asarray(seen[rows[:, None], safe]), ref_eng.cfg.k)
    return np.asarray(idx)


def _spy(monkeypatch, eng):
    """Record each in-place call (on the engine's own U, P, Q and seen);
    refuse the window kernel, which the pruned dispatches no longer
    call."""
    calls = []
    in_place = engine_mod.ops.serve_topk_rows

    def spy(ids, U, V, seen, user_bucket, bucket_items, k, *, Q=None):
        calls.append(ids.clone())
        assert U is eng.state.U and seen is eng.seen
        assert user_bucket is eng._user_bucket and bucket_items is eng._bucket_items
        assert V is eng.state.P and Q is eng.state.Q
        return in_place(ids, U, V, seen, user_bucket, bucket_items, k, Q=Q)

    def refuse(*a, **kw):
        raise AssertionError("the pruned dispatches gather no windows")

    monkeypatch.setattr(engine_mod.ops, "serve_topk_rows", spy)
    monkeypatch.setattr(engine_mod.ops, "serve_topk_window", refuse)
    return calls


def test_engine_pruned_recommend_reads_the_state_in_place(engines, monkeypatch):
    ref_eng, eng, ids = engines
    calls = _spy(monkeypatch, eng)
    vals, idx, flags = eng.recommend(ids, return_flags=True)
    assert len(calls) == eng.stats.n_dispatches == 3
    rv, ri, rf = ref_eng.recommend(ids, return_flags=True)
    np.testing.assert_array_equal(flags, np.asarray(rf))
    np.testing.assert_array_equal(idx[flags], np.asarray(ri)[flags])
    np.testing.assert_array_equal(idx[~flags], _oracle_ids(ref_eng, ids[~flags]))
    np.testing.assert_allclose(vals, np.asarray(rv), rtol=TOL, atol=TOL)


def test_engine_serve_microbatch_reads_p_and_q_in_place(engines, monkeypatch):
    ref_eng, eng, ids = engines
    batch = ids[-MICROBATCH:]
    on_v = engine_mod._dispatch_rows(
        eng.state.U, eng.state.P + eng.state.Q, None, eng.seen, eng._bucket_items,
        eng._user_bucket, torch.as_tensor(np.clip(batch, 0, eng._n_users - 1)), 10, True)
    via_recommend = eng.recommend(batch)
    calls = _spy(monkeypatch, eng)
    got = eng.serve_microbatch(batch, return_flags=True)
    assert len(calls) == 1
    expect = ref_eng.serve_microbatch(batch, return_flags=True)
    np.testing.assert_array_equal(got[2], np.asarray(expect[2]))
    for a, b in zip(got[:2], expect[:2]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=TOL)
    flags = got[2]
    np.testing.assert_array_equal(got[1][~flags], _oracle_ids(ref_eng, batch[~flags]))
    # P and Q in place serve what V in place serves, bit for bit, and
    # `recommend` serves the same slates
    for a, b, c in zip(got[:2], on_v, via_recommend):
        np.testing.assert_array_equal(a[~flags], b.numpy()[~flags])
        np.testing.assert_array_equal(a, c)
