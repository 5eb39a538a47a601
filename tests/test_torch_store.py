"""The tiled serving slice: the port's million-user store
(`repro_torch.serving.store`) and hierarchical index against the
reference's, on the CPU, at a small size (2,000 users, 400 POIs, 6
cities, K=8, cell cap 64).

The same numpy inputs go through both packages. The reference runs its
Pallas kernels in interpret mode (a few dispatches per mode); the port
runs its kernels' plain versions, which is what its wrappers run on CPU
tensors.

Tolerances:
* world, hierarchical index (every array), `SyntheticFactors` tables,
  store slabs, seen bits, item counts, int8 codes and scales, bf16 bits:
  equal, bit for bit;
* analytic score bounds: within 1e-12 relative (both are float32 sums
  carried to float64);
* served slates: fallback flags equal; slate ids equal the reference's
  jnp oracle (`repro.kernels.ref.serve_topk_window_ref`, on dequantized
  windows for int8 and bf16); values within 1e-6 abs + 1e-6 rel of the
  reference's kernels (sums over K in another order, about 1 ulp);
* the port's fp32 tiled engine against its own `ServingEngine` (pruned,
  same state): equal bit for bit, as are shard-local results against the
  unsharded store.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ref as ref_kernels  # noqa: E402
from repro.serving import ServingConfig as RefServingConfig  # noqa: E402
from repro.serving import candidates as ref_candidates  # noqa: E402
from repro.serving import store as ref_store  # noqa: E402
from repro_torch.core import dmf  # noqa: E402
from repro_torch.serving import (ServingConfig, ServingEngine, SyntheticFactors,  # noqa: E402
                                 TiledFactorStore, TiledServingEngine,
                                 build_hierarchical_index, store_from_numpy,
                                 synthetic_world)

I, J, N_CITIES, K = 2000, 400, 6, 8
CELL_CAP = 64
MICROBATCH = 64
N_REQ = 3 * MICROBATCH - 11          # three dispatches, a ragged tail


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


@pytest.fixture(scope="module")
def world():
    rw = ref_store.synthetic_world(I, J, N_CITIES, seed=5)
    pw = synthetic_world(I, J, N_CITIES, seed=5)
    uc, ic, ucoord, icoord = rw
    ref_hier = ref_candidates.build_hierarchical_index(ic, uc, icoord, ucoord,
                                                       cell_cap=CELL_CAP)
    hier = build_hierarchical_index(pw[1], pw[0], pw[3], pw[2], cell_cap=CELL_CAP)
    return dict(ref_world=rw, world=pw, ref_hier=ref_hier, hier=hier)


def _synthetic_stores(world, chunk_rows=None):
    kw = {} if chunk_rows is None else dict(chunk_rows=chunk_rows)
    ref_sf = ref_store.SyntheticFactors.create(I, J, K, seed=8)
    sf = SyntheticFactors.create(I, J, K, seed=8)
    ref_st = ref_store.TiledFactorStore.synthetic(ref_sf, world["ref_hier"].flat,
                                                  seen_per_user=3, seed=9, **kw)
    st = TiledFactorStore.synthetic(sf, world["hier"].flat, seen_per_user=3, seed=9,
                                    device="cpu", **kw)
    return ref_sf, sf, ref_st, st


def _numpy_state_and_seen():
    """U/P/Q with whole zero users (an all-zero int8 window, exact 0.0
    ties) and zero items, and a seen mask with cold users."""
    rng = np.random.default_rng(3)
    U = rng.normal(0, 0.5, (I, K)).astype(np.float32)
    P = rng.normal(0, 0.2, (I, J, K)).astype(np.float32)
    Q = rng.normal(0, 0.2, (I, J, K)).astype(np.float32)
    zero_users = rng.choice(I, 40, replace=False)
    P[zero_users] = 0.0
    Q[zero_users] = 0.0
    zero_items = rng.choice(J, J // 5, replace=False)
    P[:, zero_items] = 0.0
    Q[:, zero_items] = 0.0
    seen = rng.random((I, J)) < 0.02
    seen[rng.choice(I, 30, replace=False)] = False        # cold users
    return (U, P, Q), seen, zero_users


@pytest.fixture(scope="module")
def state_stores(world):
    (U, P, Q), seen, zero_users = _numpy_state_and_seen()
    from repro.core import dmf as ref_dmf
    ref_state = ref_dmf.DMFState(U=jnp.asarray(U), P=jnp.asarray(P), Q=jnp.asarray(Q))
    ref_st = ref_store.TiledFactorStore.from_state(ref_state, world["ref_hier"].flat, seen,
                                                   chunk_rows=700)
    state = dmf.state_from_numpy(U, P, Q, device="cpu")
    st = TiledFactorStore.from_state(state, world["hier"].flat, seen, chunk_rows=700)
    return dict(ref=ref_st, port=st, state=state, seen=seen, zero_users=zero_users)


@pytest.fixture(scope="module")
def stores(world, state_stores):
    _, _, ref_syn, syn = _synthetic_stores(world)
    return {"synthetic": (ref_syn, syn), "from_state": (state_stores["ref"],
                                                        state_stores["port"])}


# ----------------------------------------------------------- world and index
@pytest.mark.parametrize("n_users,n_items,n_cities,seed,cell_cap,max_depth",
                         [(I, J, N_CITIES, 5, CELL_CAP, 16), (1500, 800, 5, 7, 32, 3),
                          (300, 50, 9, 2, 128, 16)])
def test_world_and_hierarchical_index_equal_reference(n_users, n_items, n_cities, seed,
                                                      cell_cap, max_depth):
    rw = ref_store.synthetic_world(n_users, n_items, n_cities, seed=seed)
    pw = synthetic_world(n_users, n_items, n_cities, seed=seed)
    for a, b in zip(rw, pw):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    uc, ic, ucoord, icoord = pw
    ref_h = ref_candidates.build_hierarchical_index(ic, uc, icoord, ucoord, cell_cap=cell_cap,
                                                    max_depth=max_depth)
    h = build_hierarchical_index(ic, uc, icoord, ucoord, cell_cap=cell_cap,
                                 max_depth=max_depth)
    for name in ("cell_of_item", "cell_of_user", "cell_city", "cell_depth"):
        np.testing.assert_array_equal(getattr(h, name), getattr(ref_h, name), err_msg=name)
    for f in dataclasses.fields(h.flat):
        np.testing.assert_array_equal(getattr(h.flat, f.name), getattr(ref_h.flat, f.name),
                                      err_msg=f.name)
    assert h.stats() == ref_h.stats()
    assert (h.n_cells, h.max_depth) == (ref_h.n_cells, ref_h.max_depth)


# ------------------------------------------------------------------- store
@pytest.mark.parametrize("chunk_rows", [None, 700], ids=["one-chunk", "chunked"])
def test_synthetic_store_equals_reference(world, chunk_rows):
    ref_sf, sf, ref_st, st = _synthetic_stores(world, chunk_rows)
    for f in ("B1", "B2", "s_user", "U"):
        np.testing.assert_array_equal(getattr(sf, f), getattr(ref_sf, f), err_msg=f)
    np.testing.assert_array_equal(st.U.numpy(), ref_st.U)
    np.testing.assert_array_equal(st.slab.numpy(), ref_st.slab)
    np.testing.assert_array_equal(st.seen.numpy(), ref_st.seen)
    np.testing.assert_array_equal(st.item_counts, ref_st.item_counts)
    np.testing.assert_array_equal(st.cold, ref_st.cold)
    assert int(st.item_counts.sum()) == int(st.seen.sum())
    sample = np.arange(0, I, 97)
    np.testing.assert_array_equal(sf.dense_rows(sample, device="cpu").numpy(),
                                  ref_sf.dense_rows(sample))
    cand = world["hier"].flat.bucket_items[world["hier"].flat.user_bucket[sample]]
    np.testing.assert_array_equal(sf.item_rows(sample, cand, device="cpu").numpy(),
                                  ref_sf.item_rows(sample, cand))


def test_from_state_slabs_equal_reference(state_stores):
    ref_st, st = state_stores["ref"], state_stores["port"]
    np.testing.assert_array_equal(st.slab.numpy(), ref_st.slab)
    np.testing.assert_array_equal(st.seen.numpy(), ref_st.seen)
    np.testing.assert_array_equal(st.U.numpy(), ref_st.U)
    np.testing.assert_array_equal(st.cold, ref_st.cold)
    np.testing.assert_array_equal(st.item_counts, ref_st.item_counts)
    assert st.cold.sum() >= 30
    # the store copied U: it does not alias the state it was built from
    assert st.U.data_ptr() != state_stores["state"].U.data_ptr()


@pytest.mark.parametrize("kind", ["synthetic", "from_state"])
def test_quantization_equals_reference(stores, state_stores, kind):
    ref_st, st = stores[kind]
    ref_st.quantize_int8(chunk_rows=700)
    st.quantize_int8(chunk_rows=700)
    ref_st.quantize_bf16()
    st.quantize_bf16()
    np.testing.assert_array_equal(st.q_codes.numpy(), ref_st.q_codes)
    np.testing.assert_array_equal(st.q_scale.numpy(), ref_st.q_scale)
    np.testing.assert_array_equal(_bits(st.slab_bf16), np.asarray(ref_st.slab_bf16).view(np.uint16))
    assert st.nbytes() == {k: int(v) for k, v in ref_st.nbytes().items()}
    users = np.arange(0, I, 3)
    for name in ("int8_score_bound", "bf16_score_bound"):
        got, want = getattr(st, name)(users), getattr(ref_st, name)(users)
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    if kind == "from_state":
        z = state_stores["zero_users"]
        assert (st.q_scale[z] == np.float32(1e-12)).all() and (st.q_codes[z] == 0).all()


# ------------------------------------------------------------------ serving
def _requests():
    rng = np.random.default_rng(11)
    return np.concatenate([rng.integers(0, I, N_REQ - 2), [-4, I + 3]])


def _oracle_ids(ref_st, mode, rows, k):
    """The reference's jnp oracle on the windows the mode serves."""
    idx = ref_st.index
    cand = idx.bucket_items[idx.user_bucket[rows]]
    if mode == "fp32":
        win = ref_st.slab[rows]
    elif mode == "int8":
        win = ref_st.q_codes[rows].astype(np.float32) * ref_st.q_scale[rows][:, None, None]
    else:
        win = np.asarray(ref_st.slab_bf16[rows]).astype(np.float32)
    _, ids = ref_kernels.serve_topk_window_ref(
        jnp.asarray(ref_st.U[rows]), jnp.asarray(win), jnp.asarray(cand),
        jnp.asarray(ref_st.seen[rows]), k)
    return np.asarray(ids)


@pytest.mark.parametrize("mode", ["fp32", "int8", "bf16"])
@pytest.mark.parametrize("kind", ["synthetic", "from_state"])
def test_tiled_engine_matches_reference(stores, kind, mode):
    ref_st, st = stores[kind]
    ids = _requests()
    ref_eng = ref_store.TiledServingEngine(
        ref_st, RefServingConfig(microbatch=MICROBATCH, k=10, interpret=True), mode=mode)
    eng = TiledServingEngine(st, ServingConfig(microbatch=MICROBATCH, k=10), mode=mode)
    vals, idx, flags = eng.recommend(ids, return_flags=True)
    rv, ri, rf = ref_eng.recommend(ids, return_flags=True)
    np.testing.assert_array_equal(flags, rf)
    assert flags[-2:].all()
    np.testing.assert_array_equal(idx[flags], np.asarray(ri)[flags])
    np.testing.assert_array_equal(idx[~flags], _oracle_ids(ref_st, mode, ids[~flags], 10))
    np.testing.assert_allclose(vals, np.asarray(rv), rtol=1e-6, atol=1e-6)
    for name in ("n_requests", "n_dispatches", "n_fallbacks"):
        assert getattr(eng.stats, name) == getattr(ref_eng.stats, name), name
    assert eng.requests_per_sec > 0


def test_tiled_fp32_equals_serving_engine_bitwise(world, state_stores):
    st = state_stores["port"]
    eng = ServingEngine(state_stores["state"], world["hier"].flat,
                        ServingConfig(microbatch=32), seen=state_stores["seen"], device="cpu")
    tiled = TiledServingEngine(st, ServingConfig(microbatch=32))
    ids = np.concatenate([np.arange(I), [-1, I + 7]])
    v1, i1, f1 = eng.recommend(ids, return_flags=True)
    v2, i2, f2 = tiled.recommend(ids, return_flags=True)
    np.testing.assert_array_equal(f1, f2)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(v1, v2)
    assert f1.sum() >= 30 + 2


@pytest.mark.parametrize("mode", ["fp32", "int8", "bf16"])
def test_shard_rows_views_and_parity(stores, mode):
    _, st = stores["from_state"]
    full = TiledServingEngine(st, ServingConfig(microbatch=MICROBATCH), mode=mode)
    vf, iff, ff = full.recommend(np.arange(I), return_flags=True)
    shards = st.shard_rows(3)
    assert [s for s, _ in shards] == [0, 667, 1334]
    for s, sub in shards:
        for name in ("U", "slab", "seen", "q_codes", "q_scale", "slab_bf16"):
            t, whole = getattr(sub, name), getattr(st, name)
            if t is None:
                continue
            assert t.untyped_storage().data_ptr() == whole.untyped_storage().data_ptr(), name
        se = TiledServingEngine(sub, ServingConfig(microbatch=MICROBATCH), mode=mode)
        vs, is_, fs = se.recommend(np.arange(sub.n_users), return_flags=True)
        np.testing.assert_array_equal(fs, ff[s: s + sub.n_users])
        np.testing.assert_array_equal(is_, iff[s: s + sub.n_users])
        np.testing.assert_array_equal(vs, vf[s: s + sub.n_users])


def test_store_from_numpy_carries_the_reference_store(stores):
    ref_st, st = stores["synthetic"]
    ref_st.quantize_int8()
    ref_st.quantize_bf16()
    carried = store_from_numpy(
        ref_st.U, ref_st.slab, ref_st.seen, ref_st.index, ref_st.cold, ref_st.item_counts,
        q_codes=ref_st.q_codes, q_scale=ref_st.q_scale,
        slab_bf16_bits=np.asarray(ref_st.slab_bf16).view(np.uint16), device="cpu")
    assert carried.slab_bf16.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(carried.slab_bf16),
                                  np.asarray(ref_st.slab_bf16).view(np.uint16))
    np.testing.assert_array_equal(carried.q_codes.numpy(), ref_st.q_codes)
    np.testing.assert_array_equal(carried.slab.numpy(), ref_st.slab)
    ids = _requests()
    for mode in ("fp32", "int8", "bf16"):
        cfg = ServingConfig(microbatch=MICROBATCH)
        a = TiledServingEngine(carried, cfg, mode=mode).recommend(ids)
        b = TiledServingEngine(st, cfg, mode=mode).recommend(ids)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
