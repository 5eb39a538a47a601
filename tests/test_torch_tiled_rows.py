"""Kernel 6 reading the tiled store in place (`ops.serve_topk_tiled_quant`),
the tiled engine's int8/bf16 dispatch through it, and the noise stream's
wide and high-rid rows and launch layout, on the CPU.

The same numpy inputs, drawn from a fixed seed, go through the reference's
`repro.kernels.ops.serve_topk_window_quant` (Pallas in interpret mode) on
the windows gathered from a store, and through the port's in-place
wrapper on the store itself, which on CPU tensors runs its plain version
(`ref.serve_topk_tiled_quant_ref`: the gathers, then
`ref.serve_topk_window_quant_ref`). Tolerances:

* the in-place plain version against the pre-gathered plain version on
  the gathered windows (ids with repeats, buckets of padding only,
  all-seen users, shard views): equal, bit for bit;
* against the reference: slate ids equal to the reference's jnp oracle
  (`repro.kernels.ref.serve_topk_window_ref` on the dequantized windows;
  ROADMAP §C1: the reference's Pallas merge can break exact ties across
  tiles), values within 1e-6 abs + 1e-6 rel of its kernel (sums over K in
  another order);
* the tiled engine, int8 and bf16, against the reference's engine as
  `tests/test_torch_store.py` holds it;
* the noise stream's plain version against the reference's
  `gauss_counter` at 1 and 256 columns and rids at and above 2^23: hash
  words equal, draws within 1e-6 (one fp32 ulp of log and cos).

The CUDA kernels themselves are held on the card by
`tests/test_torch_cuda.py` and `chip_smoke.py`.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import dp_noise as ref_dp_noise  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_kernels  # noqa: E402
from repro.serving import ServingConfig as RefServingConfig  # noqa: E402
from repro.serving import candidates as ref_candidates  # noqa: E402
from repro.serving import store as ref_store  # noqa: E402
from repro_torch.kernels import dp_noise, ops, ref  # noqa: E402
from repro_torch.serving import (ServingConfig, SyntheticFactors, TiledFactorStore,  # noqa: E402
                                 TiledServingEngine, build_hierarchical_index,
                                 synthetic_world)
from repro_torch.serving import store as store_mod  # noqa: E402


def _store(seed, I=90, cap=40, K=8, n_items=700, n_buckets=6, R=33):
    """Numpy store tensors: U (I, K), V (I, cap, K) with a zero user, an
    all-zero window (int8 scale floored at 1e-12) and repeated rows; seen
    (I, cap) with an all-seen user; bucket_items (n_buckets, cap) ascending
    ids, one bucket full and one padding only; user_bucket (I,); R ids
    with repeats. Codes and scales as the store quantizes them, and the
    bf16 bits of V."""
    rng = np.random.default_rng(seed)
    bucket_items = np.full((n_buckets, cap), -1, np.int32)
    for b in range(n_buckets):
        n = (cap, 0)[b] if b < 2 else int(rng.integers(1, cap + 1))
        bucket_items[b, :n] = np.sort(rng.choice(n_items, n, replace=False))
    user_bucket = rng.integers(0, n_buckets, I).astype(np.int64)
    user_bucket[:3] = (0, 1, 0)
    U = rng.normal(0, 1, (I, K)).astype(np.float32)
    U[3] = 0.0
    V = rng.normal(0, 1, (I, cap, K)).astype(np.float32)
    V[4] = 0.0
    V[5, ::2] = V[5, -1]
    seen = (rng.random((I, cap)) < 0.1).astype(np.int8)
    seen[2] = 1
    ids = rng.integers(0, I, R).astype(np.int64)
    ids[:6] = np.arange(6)
    ids[7] = ids[6]
    scale = np.maximum(np.abs(V).max(axis=(1, 2)) / 127.0, 1e-12).astype(np.float32)
    codes = np.clip(np.rint(V / scale[:, None, None]), -127, 127).astype(np.int8)
    bits = np.array(jnp.asarray(V).astype(jnp.bfloat16)).view(np.uint16)
    return dict(ids=ids, U=U, V=V, codes=codes, scale=scale, bits=bits, seen=seen,
                user_bucket=user_bucket, bucket_items=bucket_items)


def _port_args(s, form):
    """(ids, U, Vq, scale, user_bucket, bucket_items, seen) as tensors."""
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in s.items()}
    if form == "int8":
        Vq, scale = t["codes"], t["scale"]
    else:
        Vq, scale = torch.from_numpy(s["bits"].view(np.int16)).view(torch.bfloat16), None
    return t["ids"], t["U"], Vq, scale, t["user_bucket"], t["bucket_items"], t["seen"]


def _gathered(ids, U, Vq, scale, user_bucket, bucket_items, seen):
    sc = torch.ones(ids.shape[0]) if scale is None else scale[ids]
    return U[ids], Vq[ids], sc, bucket_items[user_bucket[ids]], seen[ids]


@pytest.mark.parametrize("K", [8, 10])
@pytest.mark.parametrize("k", [1, 10, 16])
@pytest.mark.parametrize("form", ["int8", "bf16"])
def test_in_place_plain_equals_the_gathered_plain_version(form, k, K):
    args = _port_args(_store(k + K, K=K), form)
    got = ops.serve_topk_tiled_quant(*args, k)
    want = ref.serve_topk_window_quant_ref(*_gathered(*args), k)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[0].shape == (args[0].shape[0], k) and got[1].dtype == torch.int32
    vals, idx = got
    ids = args[0].numpy()
    # an all-seen user and a bucket of padding only: no candidate at all
    for r in np.flatnonzero((ids == 1) | (ids == 2)):
        assert (idx[r] == -1).all() and (vals[r] == ref.NEG_INF).all()
    # repeated ids give the same slate
    np.testing.assert_array_equal(idx[6].numpy(), idx[7].numpy())


@pytest.mark.parametrize("k", [1, 10, 16])
@pytest.mark.parametrize("form", ["int8", "bf16"])
def test_in_place_plain_matches_the_reference_kernel(form, k):
    s = _store(100 + k)
    args = _port_args(s, form)
    got = ops.serve_topk_tiled_quant(*args, k)
    ids = s["ids"]
    cand = s["bucket_items"][s["user_bucket"][ids]]
    if form == "int8":
        ref_q, ref_scale = jnp.asarray(s["codes"][ids]), jnp.asarray(s["scale"][ids])
        win = s["codes"][ids].astype(np.float32) * s["scale"][ids][:, None, None]
    else:
        ref_q = jnp.asarray(s["bits"][ids]).view(jnp.bfloat16)
        ref_scale = jnp.ones(len(ids), jnp.float32)
        win = np.asarray(ref_q.astype(jnp.float32))
    U, seen = jnp.asarray(s["U"][ids]), jnp.asarray(s["seen"][ids])
    expect = ref_ops.serve_topk_window_quant(U, ref_q, ref_scale, jnp.asarray(cand), seen, k,
                                             interpret=True)
    _, oracle_ids = ref_kernels.serve_topk_window_ref(U, jnp.asarray(win), jnp.asarray(cand),
                                                      seen, k)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(oracle_ids))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(expect[0]), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("form", ["int8", "bf16"])
def test_in_place_on_shard_views_equals_the_whole_store(form):
    """Row shards are views of the whole store (ids rebased): the in-place
    form on a shard gives the whole store's slates bit for bit."""
    s = _store(7, I=120, R=60)
    ids, U, Vq, scale, ub, bi, seen = _port_args(s, form)
    whole = ops.serve_topk_tiled_quant(ids, U, Vq, scale, ub, bi, seen, 10)
    for start, end in ((0, 40), (40, 80), (80, 120)):
        mine = (ids >= start) & (ids < end)
        part = ops.serve_topk_tiled_quant(
            ids[mine] - start, U[start:end], Vq[start:end],
            None if scale is None else scale[start:end], ub[start:end], bi, seen[start:end], 10)
        assert Vq[start:end].untyped_storage().data_ptr() == Vq.untyped_storage().data_ptr()
        for a, b in zip(part, whole):
            assert torch.equal(a, b[mine])


@pytest.mark.parametrize("case", ["ids dtype", "ids range", "negative id", "bucket range",
                                  "negative bucket", "scale shape", "codes dtype",
                                  "bucket dtype", "user_bucket shape", "k"])
def test_in_place_wrapper_refuses_what_the_kernel_does_not_take(case):
    ids, U, Vq, scale, ub, bi, seen = _port_args(_store(3), "int8")
    args = dict(ids=ids, U=U, Vq=Vq, scale=scale, user_bucket=ub, bucket_items=bi, seen=seen,
                k=5)
    err = {"ids range": IndexError, "negative id": IndexError, "bucket range": IndexError,
           "negative bucket": IndexError, "ids dtype": TypeError,
           "codes dtype": TypeError, "bucket dtype": TypeError}.get(case, ValueError)
    if case == "ids dtype":
        args["ids"] = ids.int()
    elif case == "ids range":
        args["ids"] = ids.clone()
        args["ids"][3] = U.shape[0]
    elif case == "negative id":
        args["ids"] = ids.clone()
        args["ids"][0] = -1
    elif case in ("bucket range", "negative bucket"):
        args["user_bucket"] = ub.clone()
        args["user_bucket"][ids[2]] = bi.shape[0] if case == "bucket range" else -1
    elif case == "scale shape":
        args["scale"] = scale[:5]
    elif case == "codes dtype":
        args["Vq"] = Vq.float()
    elif case == "bucket dtype":
        args["bucket_items"] = bi.long()
    elif case == "user_bucket shape":
        args["user_bucket"] = ub[:7]
    else:
        args["k"] = 17
    before = ops.serve_topk_tiled_quant.launches
    with pytest.raises(err):
        ops.serve_topk_tiled_quant(**args)
    assert ops.serve_topk_tiled_quant.launches == before == 0


# --------------------------------------------------------- the tiled engine
I, J, N_CITIES, K_STORE, CELL_CAP, MICROBATCH = 1500, 300, 5, 10, 32, 32


@pytest.fixture(scope="module")
def stores():
    ruc, ric, rucoord, ricoord = ref_store.synthetic_world(I, J, N_CITIES, seed=21)
    uc, ic, ucoord, icoord = synthetic_world(I, J, N_CITIES, seed=21)
    ref_hier = ref_candidates.build_hierarchical_index(ric, ruc, ricoord, rucoord,
                                                       cell_cap=CELL_CAP)
    hier = build_hierarchical_index(ic, uc, icoord, ucoord, cell_cap=CELL_CAP)
    ref_st = ref_store.TiledFactorStore.synthetic(
        ref_store.SyntheticFactors.create(I, J, K_STORE, seed=22), ref_hier.flat,
        seen_per_user=3, seed=23)
    st = TiledFactorStore.synthetic(SyntheticFactors.create(I, J, K_STORE, seed=22), hier.flat,
                                    seen_per_user=3, seed=23, device="cpu")
    return ref_st, st


def _requests():
    rng = np.random.default_rng(24)
    return np.concatenate([rng.integers(0, I, 3 * MICROBATCH - 5), [-2, I + 1]])


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_tiled_engine_quant_modes_match_the_reference_engine(stores, mode):
    ref_st, st = stores
    ids = _requests()
    ref_eng = ref_store.TiledServingEngine(
        ref_st, RefServingConfig(microbatch=MICROBATCH, k=10, interpret=True), mode=mode)
    eng = TiledServingEngine(st, ServingConfig(microbatch=MICROBATCH, k=10), mode=mode)
    vals, idx, flags = eng.recommend(ids, return_flags=True)
    rv, ri, rf = ref_eng.recommend(ids, return_flags=True)
    np.testing.assert_array_equal(flags, rf)
    np.testing.assert_array_equal(idx[flags], np.asarray(ri)[flags])
    live = ids[~flags]
    idx_ = ref_st.index
    cand = idx_.bucket_items[idx_.user_bucket[live]]
    if mode == "int8":
        win = ref_st.q_codes[live].astype(np.float32) * ref_st.q_scale[live][:, None, None]
    else:
        win = np.asarray(ref_st.slab_bf16[live]).astype(np.float32)
    _, oracle = ref_kernels.serve_topk_window_ref(
        jnp.asarray(ref_st.U[live]), jnp.asarray(win), jnp.asarray(cand),
        jnp.asarray(ref_st.seen[live]), 10)
    np.testing.assert_array_equal(idx[~flags], np.asarray(oracle))
    np.testing.assert_allclose(vals, np.asarray(rv), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_tiled_engine_quant_dispatch_reads_the_store_in_place(stores, mode, monkeypatch):
    """int8/bf16 dispatches call the in-place wrapper once a microbatch on
    the store's own tensors, never the pre-gathered one, and serve what the
    pre-gathered kernel serves on the gathered windows."""
    _, st = stores
    eng = TiledServingEngine(st, ServingConfig(microbatch=MICROBATCH, k=10), mode=mode)
    calls = []
    in_place = store_mod.ops.serve_topk_tiled_quant

    def spy(ids, U, Vq, scale, user_bucket, bucket_items, seen, k):
        calls.append(ids.clone())
        assert U is st.U and seen is st.seen
        assert Vq is (st.q_codes if mode == "int8" else st.slab_bf16)
        assert (scale is st.q_scale) if mode == "int8" else scale is None
        return in_place(ids, U, Vq, scale, user_bucket, bucket_items, seen, k)

    def refuse(*a, **kw):
        raise AssertionError("the quant modes gather no windows")

    monkeypatch.setattr(store_mod.ops, "serve_topk_tiled_quant", spy)
    monkeypatch.setattr(store_mod.ops, "serve_topk_window_quant", refuse)
    ids = np.random.default_rng(25).integers(0, I, 2 * MICROBATCH + 3)
    vals, idx, flags = eng.recommend(ids, return_flags=True)
    assert len(calls) == eng.stats.n_dispatches == 3
    args = (torch.from_numpy(ids), st.U, *((st.q_codes, st.q_scale) if mode == "int8"
                                           else (st.slab_bf16, None)),
            torch.as_tensor(st.index.user_bucket, dtype=torch.int64),
            torch.as_tensor(st.index.bucket_items), st.seen)
    want = ref.serve_topk_window_quant_ref(*_gathered(*args), 10)
    keep = ~flags
    np.testing.assert_array_equal(idx[keep], want[1].numpy()[keep])
    np.testing.assert_array_equal(vals[keep], want[0].numpy()[keep])


# ------------------------------------------------------------- noise stream
def _high_rids():
    return np.concatenate([np.arange((1 << 23) - 40, (1 << 23) + 40), (3 << 23) + np.arange(9),
                           [2**31 - 1]]).astype(np.int32)


@pytest.mark.parametrize("n_cols", [1, 256])
@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_gauss_counter_wide_and_high_rows_match_the_reference(seed, n_cols):
    rid = _high_rids()
    got = dp_noise.gauss_counter_ref(seed, torch.from_numpy(rid), n_cols)
    expect = np.asarray(ref_dp_noise.gauss_counter(seed, jnp.asarray(rid).reshape(-1, 1),
                                                   n_cols))
    assert got.shape == (len(rid), n_cols)
    np.testing.assert_allclose(got.numpy(), expect, rtol=0, atol=1e-6)
    assert torch.equal(ops.gauss_counter(seed, torch.from_numpy(rid), n_cols), got)
    # a column's draw does not depend on the block's width
    narrow = dp_noise.gauss_counter_ref(seed, torch.from_numpy(rid), 1)
    assert torch.equal(got[:, :1], narrow)


@pytest.mark.parametrize("n_cols", [1, 3, 8, 10, 16, 255, 256])
@pytest.mark.parametrize("N", [1, 2, 131, 28_160, 300_000])
def test_stream_layout_covers_every_element_once(N, n_cols):
    """Thread (x, y) of block b draws columns per·x .. per·x + per - 1 of
    row b·rows + y, over ceil(N / rows) blocks: every (row, column)
    exactly once, two columns a thread for even n_cols, blocks of whole
    rows within 256 threads."""
    lay = dp_noise.stream_layout(n_cols)
    per, rows = lay["per"], lay["rows"]
    assert per == (2 if n_cols % 2 == 0 else 1)
    assert lay["threads"] == n_cols // per * rows <= 256
    assert lay["threads"] <= dp_noise.STREAM_THREADS or rows == 1
    # rows: block b's rows b·rows + y, those below N, are 0..N-1 once
    blocks = -(-N // rows)
    every = (np.arange(blocks)[:, None] * rows + np.arange(rows)[None, :]).ravel()
    every = every[every < N]
    assert len(every) == N and len(np.unique(every)) == N
    assert (blocks - 1) * rows < N                   # no block without a row
    # columns: each row's threads cover 0..n_cols-1 once
    cols = (per * np.arange(n_cols // per)[:, None] + np.arange(per)[None, :]).ravel()
    np.testing.assert_array_equal(np.sort(cols), np.arange(n_cols))


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_in_place_on_shard_rows_of_a_store(stores, mode):
    """`TiledFactorStore.shard_rows` views (user buckets rebased): the
    in-place form on each shard equals the whole store's, bit for bit."""
    _, st = stores
    (st.quantize_int8 if mode == "int8" else st.quantize_bf16)()

    def args(s):
        Vq, scale = (s.q_codes, s.q_scale) if mode == "int8" else (s.slab_bf16, None)
        return (s.U, Vq, scale, torch.as_tensor(s.index.user_bucket, dtype=torch.int64),
                torch.as_tensor(s.index.bucket_items), s.seen)

    ids = torch.from_numpy(np.random.default_rng(26).integers(0, I, 200))
    whole = ops.serve_topk_tiled_quant(ids, *args(st), 10)
    shards = st.shard_rows(3)
    for start, sub in shards:
        mine = (ids >= start) & (ids < start + sub.n_users)
        part = ops.serve_topk_tiled_quant(ids[mine] - start, *args(sub), 10)
        for a, b in zip(part, whole):
            assert torch.equal(a, b[mine])
    assert sum(sub.n_users for _, sub in shards) == I
