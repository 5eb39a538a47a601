"""The LM stack's layers in the port against the reference, on the CPU:
`models/layers.py`, `attention.py`, `ssm.py` and `moe.py` of
`repro_torch` against `repro.models`.

Inputs are numpy draws from a seed; parameters are the reference's own
initialisers' draws carried across as float32 (zero- and one-initialised
leaves randomised first, so that a bias, a norm scale or the cross gate is
held to something). Compute is fp32; the tolerance is 1e-5 abs + 1e-5 rel
unless a case says otherwise (the two packages sum einsums and cumsums in
other orders). The MoE expert ids and the capacity-drop masks are equal
exactly.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models import attention as ref_attn  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models.config import LayerSpec as RefLayerSpec  # noqa: E402
from repro.models.config import ModelConfig as RefModelConfig  # noqa: E402
from repro_torch import device as device_lib  # noqa: E402
from repro_torch.models import attention, layers, moe, ssm  # noqa: E402
from repro_torch.models.config import LayerSpec, ModelConfig  # noqa: E402

device_lib.settle_cpu()
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _cfgs(**kw):
    """The same configuration in both packages."""
    period = kw.pop("period", ("attn", False))
    ref = RefModelConfig(name="t", period=(RefLayerSpec(kind=period[0], moe=period[1]),),
                         compute_dtype="float32", **kw)
    port = ModelConfig(name="t", period=(LayerSpec(kind=period[0], moe=period[1]),),
                       compute_dtype="float32", **kw)
    return ref, port


def _randomized(tree, seed):
    """The reference's parameter draws as numpy float32, with every leaf
    that is all zeros or all ones replaced by random values."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in tree.items():
        a = np.asarray(v, np.float32)
        if a.size and (np.all(a == 0) or np.all(a == 1)):
            a = (a + rng.normal(0, 0.3, a.shape)).astype(np.float32)
        out[k] = a
    return out


def _jnp(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _carry(module, tree):
    for name, arr in tree.items():
        getattr(module, name).copy_(torch.as_tensor(np.array(arr)))
    return module


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(tol or TOL))


# --------------------------------------------------------------- layers
def test_rms_norm_rope_mlp_embeddings():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 4, 32)).astype(np.float32)
    scale = rng.normal(1, 0.3, 32).astype(np.float32)
    _close(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5),
           ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5))
    # RoPE: split halves, float64 frequencies cast to fp32, fp32 angles
    np.testing.assert_array_equal(layers.rope_freqs(64, 5e6), ref_layers.rope_freqs(64, 5e6))
    pos = np.arange(3, 10)[None, :]
    for theta in (1e4, 5e5):
        _close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
               ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    p, _ = ref_layers.init_mlp(jax.random.PRNGKey(0), 32, 48)
    p = _randomized(p, 1)
    port = _carry(layers.MLP(32, 48, device="cpu"), p)
    h = rng.normal(size=(2, 5, 32)).astype(np.float32)
    _close(layers.mlp(port, torch.from_numpy(h), torch.float32),
           ref_layers.mlp(p, jnp.asarray(h), jnp.float32))
    # the initialisers' shapes and scales
    g = torch.Generator().manual_seed(0)
    assert layers.init_embedding(512, 64, generator=g).shape == (512, 64)
    head = layers.init_lm_head(64, 512, generator=g)
    assert head.shape == (64, 512) and abs(float(head.std()) - 0.02) < 2e-3
    assert torch.equal(layers.init_rms_norm(8), torch.ones(8))


# ------------------------------------------------------------ attention
def _qkv(seed, B, Sq, Sk, H, KV, hd, vd=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, Sk, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, Sk, KV, vd or hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("case", [
    # (Sq, Sk, H, KV, kw): nk > 1 with G > 1; q_offset; a window; ragged Sq
    # (padded to q_chunk); non-causal; the dense shortcut
    dict(Sq=64, Sk=64, H=4, KV=2, causal=True),
    dict(Sq=96, Sk=128, H=8, KV=1, causal=True, q_offset=32),
    dict(Sq=96, Sk=96, H=4, KV=2, causal=True, window=24),
    dict(Sq=40, Sk=64, H=4, KV=4, causal=False),
    dict(Sq=50, Sk=64, H=4, KV=2, causal=True, q_offset=14),
    dict(Sq=24, Sk=32, H=4, KV=2, causal=True, q_offset=8, window=12, dense=True),
], ids=["G2-nk2", "G8-offset", "window", "noncausal-ragged", "ragged-offset", "dense-shortcut"])
def test_blockwise_attention_matches_reference(case):
    case = dict(case)
    dense = case.pop("dense", False)
    Sq, Sk, H, KV = (case.pop(n) for n in ("Sq", "Sk", "H", "KV"))
    q, k, v = _qkv(Sq + Sk, 2, Sq, Sk, H, KV, 16, 8)
    chunks = dict(q_chunk=32, kv_chunk=32)
    # the dense shortcut exactly when Sk <= kv_chunk and Sq <= q_chunk (:69-70)
    assert dense == (Sk <= 32 and Sq <= 32)
    got = attention.blockwise_attention(*map(torch.from_numpy, (q, k, v)), **chunks, **case)
    want = ref_attn.blockwise_attention(*map(jnp.asarray, (q, k, v)), **chunks, **case)
    assert got.shape == (2, Sq, H, 8)
    _close(got, want)


def test_triangular_attention_matches_reference_and_dispatch():
    q, k, v = _qkv(5, 2, 128, 128, 4, 2, 16)
    got = attention.triangular_attention(*map(torch.from_numpy, (q, k, v)), q_chunk=32)
    _close(got, ref_attn.triangular_attention(*map(jnp.asarray, (q, k, v)), q_chunk=32))
    via = attention.blockwise_attention(*map(torch.from_numpy, (q, k, v)), q_chunk=32,
                                        kv_chunk=32, triangular=True)
    np.testing.assert_array_equal(via.numpy(), got.numpy())


def test_decode_attend_length_mask_matches_reference():
    rng = np.random.default_rng(1)
    B, S, H, KV, hd = 2, 16, 8, 2, 16
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    for length in (1, 9, 16):
        got = attention.decode_attend(*map(torch.from_numpy, (q, k, v)), length)
        _close(got, ref_attn.decode_attend(*map(jnp.asarray, (q, k, v)), jnp.asarray(length)))
    # entries past the length do not matter
    k2, v2 = k.copy(), v.copy()
    k2[:, 9:], v2[:, 9:] = 999.0, -999.0
    np.testing.assert_array_equal(
        attention.decode_attend(*map(torch.from_numpy, (q, k2, v2)), 9).numpy(),
        attention.decode_attend(*map(torch.from_numpy, (q, k, v)), 9).numpy())


def _gqa_cfgs(**kw):
    return _cfgs(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                 vocab_size=64, **kw)


def test_gqa_projections_with_bias_match_reference():
    ref_cfg, cfg = _gqa_cfgs(qkv_bias=True)
    p, _ = ref_attn.init_gqa(jax.random.PRNGKey(0), ref_cfg)
    p = _randomized(p, 2)
    assert set(p) == {"wq", "wk", "wv", "wo", "bq", "bk", "bv"}
    port = _carry(attention.GQAAttention(cfg, device="cpu"), p)
    x = np.random.default_rng(2).normal(0, 0.5, (2, 9, 64)).astype(np.float32)
    pos = np.arange(9)[None, :] + 5
    got = attention.gqa_qkv(port, torch.from_numpy(x), torch.from_numpy(pos), cfg, torch.float32)
    want = ref_attn.gqa_qkv(p, jnp.asarray(x), jnp.asarray(pos), ref_cfg, jnp.float32)
    for g, w in zip(got, want):
        _close(g, w)
    _close(attention.gqa_out(port, got[0], torch.float32),
           ref_attn.gqa_out(p, want[0], jnp.float32))


@pytest.mark.parametrize("q_lora", [0, 24], ids=["no-qlora", "qlora"])
def test_mla_full_and_absorbed_decode_match_reference(q_lora):
    """MLA's score scale is 1/sqrt(head_dim + rope_head_dim) in both paths."""
    ref_cfg, cfg = _cfgs(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
                         d_ff=128, vocab_size=64, attn_type="mla", kv_lora_rank=32,
                         rope_head_dim=8, v_head_dim=16, q_lora_rank=q_lora)
    p, _ = ref_attn.init_mla(jax.random.PRNGKey(0), ref_cfg)
    p = _randomized(p, 3)
    assert ("w_dq" in p) == bool(q_lora)
    port = _carry(attention.MLAAttention(cfg, device="cpu"), p)
    B, S = 2, 12
    x = np.random.default_rng(3).normal(0, 0.5, (B, S, 64)).astype(np.float32)
    positions = np.arange(S)[None, :]
    out, (ckv, kr) = attention.mla_attend_full(port, torch.from_numpy(x),
                                               torch.from_numpy(positions), cfg,
                                               torch.float32, kv_chunk=64)
    r_out, (r_ckv, r_kr) = ref_attn.mla_attend_full(p, jnp.asarray(x), jnp.asarray(positions),
                                                   ref_cfg, jnp.float32, kv_chunk=64)
    for g, w in ((out, r_out), (ckv, r_ckv), (kr, r_kr)):
        _close(g, w)
    last = np.full((B, 1), S - 1)
    dec = attention.mla_decode(port, torch.from_numpy(x[:, -1:]), ckv, kr, S,
                               torch.from_numpy(last), cfg, torch.float32)
    r_dec = ref_attn.mla_decode(p, jnp.asarray(x[:, -1:]), r_ckv, r_kr, jnp.asarray(S),
                                jnp.asarray(last), ref_cfg, jnp.float32)
    _close(dec, r_dec)
    # the absorbed decode is the expanded attention's last row (reference's bar)
    _close(dec[:, 0], out[:, -1], rtol=2e-3, atol=2e-3)


def test_cross_attention_with_a_nonzero_gate_matches_reference():
    ref_cfg, cfg = _cfgs(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
                         d_ff=64, vocab_size=64, n_image_tokens=8, period=("cross", False))
    p, _ = ref_attn.init_cross_attn(jax.random.PRNGKey(0), ref_cfg)
    assert float(p["gate"]) == 0.0
    p = _randomized(p, 4)
    assert abs(float(p["gate"])) > 0           # a zero gate would hold nothing
    port = _carry(attention.CrossAttention(cfg, device="cpu"), p)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 6, 32)).astype(np.float32)
    media = rng.normal(size=(2, 8, 32)).astype(np.float32)
    got = attention.cross_attend(port, torch.from_numpy(x), torch.from_numpy(media), cfg,
                                 torch.float32)
    want = ref_attn.cross_attend(p, jnp.asarray(x), jnp.asarray(media), ref_cfg, jnp.float32)
    assert float(np.abs(np.asarray(want)).max()) > 1e-4
    _close(got, want)


# ------------------------------------------------------------------ SSD
def _ssd_inputs(seed, B=2, L=64, H=4, P=8, G=2, N=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, H, P)).astype(np.float32)
    dt = (0.5 * np.abs(rng.normal(size=(B, L, H)))).astype(np.float32)
    A = (-np.abs(rng.normal(size=(H,)))).astype(np.float32)
    Bm = rng.normal(size=(B, L, G, N)).astype(np.float32)
    Cm = rng.normal(size=(B, L, G, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def test_segsum_is_minus_inf_above_the_diagonal():
    x = np.random.default_rng(0).normal(size=(3, 8)).astype(np.float32)
    got = ssm._segsum(torch.from_numpy(x))
    _close(np.where(np.isinf(got.numpy()), 0, got.numpy()),
           np.where(np.isinf(np.asarray(ref_ssm._segsum(jnp.asarray(x)))), 0,
                    np.asarray(ref_ssm._segsum(jnp.asarray(x)))))
    upper = np.triu(np.ones((8, 8), bool), 1)
    assert np.all(np.isneginf(got.numpy()[:, upper]))
    assert np.all(torch.exp(got).numpy()[:, upper] == 0.0)   # exact zeros


@pytest.mark.parametrize("chunk,init", [(8, False), (16, False), (64, False), (8, True)],
                         ids=["8-chunks", "4-chunks", "1-chunk", "init-state"])
def test_ssd_chunked_matches_reference(chunk, init):
    args = _ssd_inputs(chunk + init)
    s0 = (np.random.default_rng(1).normal(size=(2, 4, 8, 16)).astype(np.float32)
          if init else None)
    y, s = ssm.ssd_chunked(*map(torch.from_numpy, args), chunk=chunk,
                           init_state=None if s0 is None else torch.from_numpy(s0))
    ry, rs = ref_ssm.ssd_chunked(*map(jnp.asarray, args), chunk=chunk,
                                 init_state=None if s0 is None else jnp.asarray(s0))
    _close(y, ry, rtol=1e-5, atol=2e-5)
    _close(s, rs, rtol=1e-5, atol=2e-5)


def _mamba_cfgs(chunk=16):
    return _cfgs(n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, head_dim=32, d_ff=0,
                 vocab_size=64, ssm_d_state=16, ssm_head_dim=32, ssm_n_groups=2,
                 ssm_chunk=chunk, period=("mamba", False))


def test_mamba_forward_then_decode_matches_reference():
    """dt is softplus in fp32 (`ssm.py:169`); the decode conv window shifts
    by one (:215); the conv tail is left-padded when L < W-1 (:160-161)."""
    ref_cfg, cfg = _mamba_cfgs()
    p, _ = ref_ssm.init_mamba(jax.random.PRNGKey(0), ref_cfg)
    p = _randomized(p, 5)
    port = _carry(ssm.Mamba(cfg, device="cpu"), p)
    rng = np.random.default_rng(5)
    x = rng.normal(0, 0.5, (2, 34, 64)).astype(np.float32)
    y, cache = ssm.mamba_forward(port, torch.from_numpy(x[:, :32]), cfg, torch.float32)
    ry, rcache = ref_ssm.mamba_forward(p, jnp.asarray(x[:, :32]), ref_cfg, jnp.float32)
    _close(y, ry)
    _close(cache.conv, rcache.conv)
    _close(cache.state, rcache.state)
    for t in (32, 33):
        y1, cache = ssm.mamba_decode(port, torch.from_numpy(x[:, t:t + 1]), cache, cfg,
                                     torch.float32)
        ry1, rcache = ref_ssm.mamba_decode(p, jnp.asarray(x[:, t:t + 1]), rcache, ref_cfg,
                                           jnp.float32)
        _close(y1, ry1)
        _close(cache.conv, rcache.conv)
        _close(cache.state, rcache.state)
    # L < W-1: the tail is left-padded with zeros
    y2, short = ssm.mamba_forward(port, torch.from_numpy(x[:, :2]), cfg, torch.float32)
    ry2, rshort = ref_ssm.mamba_forward(p, jnp.asarray(x[:, :2]), ref_cfg, jnp.float32)
    assert short.conv.shape == (2, cfg.ssm_conv_width - 1, ssm.conv_dim(cfg))
    _close(short.conv, rshort.conv)
    _close(y2, ry2)
    empty = ssm.init_ssm_cache(cfg, 3, torch.float32)
    ref_empty = ref_ssm.init_ssm_cache(ref_cfg, 3, jnp.float32)
    assert empty.conv.shape == ref_empty.conv.shape and empty.state.shape == ref_empty.state.shape


def test_mamba_initialiser_constants_match_reference():
    ref_cfg, cfg = _mamba_cfgs()
    p, _ = ref_ssm.init_mamba(jax.random.PRNGKey(0), ref_cfg)
    port = ssm.Mamba(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    for name in ("A_log", "D", "dt_bias", "norm", "conv_b"):
        _close(getattr(port, name), p[name], rtol=1e-6, atol=1e-7)
    for name, v in p.items():
        assert tuple(getattr(port, name).shape) == v.shape, name


# ------------------------------------------------------------------ MoE
def _moe_cfgs(E=8, k=2, shared=1, **kw):
    return _cfgs(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=0,
                 vocab_size=64, n_routed_experts=E, n_shared_experts=shared, moe_top_k=k,
                 moe_d_ff=32, period=("attn", True), **kw)


def _ref_dispatch(idx, w, n_experts, first, capacity):
    """The reference's grouping, `_grouped_expert_ffn` (`moe.py:93-107`),
    written out with its own jnp ops: per expert the window's token ids,
    weights and valid mask."""
    T, k = idx.shape
    eid = idx.reshape(-1)
    tok = jnp.repeat(jnp.arange(T), k)
    ww = w.reshape(-1)
    order = jnp.argsort(eid)
    eid_s, tok_s, w_s = eid[order], tok[order], ww[order]
    starts = jnp.searchsorted(eid_s, first + jnp.arange(n_experts))
    out = []
    for e in range(n_experts):
        es = jax.lax.dynamic_slice(eid_s, (starts[e],), (capacity,))
        ts = jax.lax.dynamic_slice(tok_s, (starts[e],), (capacity,))
        ws = jax.lax.dynamic_slice(w_s, (starts[e],), (capacity,))
        out.append((np.asarray(ts), np.asarray(ws), np.asarray(es == first + e)))
    return [np.stack(a) for a in zip(*out)]


@pytest.mark.parametrize("case", [
    dict(E=8, k=2, T=24, cf=1.25),                  # the published capacity factor
    dict(E=4, k=2, T=40, cf=0.5, drops=True),       # heavy dropping
    dict(E=4, k=2, T=40, cf=1.9, clamped=True),     # a window clamped to N - capacity
    dict(E=16, k=4, T=3, cf=1.25),                  # a decode batch: the capacity clamp
    dict(E=2, k=1, T=8, cf=1e-9, drops=True),       # one slot an expert
], ids=["published", "heavy-drops", "clamped-window", "decode-batch", "one-slot"])
def test_routing_and_capacity_drops_equal_reference(case):
    """Capacity dropping (`moe.py:77-117`): `lax.top_k` takes the lowest id
    among ties; `jnp.argsort` is stable and `repeat(arange(T), k)` fixes
    the token order; `lax.dynamic_slice` clamps a window's start to
    [0, N - capacity]; `moe_capacity` clamps at decode batch sizes; the
    scatter-add goes through `core/scatter.py::scatter_add_rows_`. Ids,
    windows and masks equal exactly; weights and outputs within
    tolerance."""
    ref_cfg, cfg = _moe_cfgs(E=case["E"], k=case["k"], shared=0, capacity_factor=case["cf"])
    p, _ = ref_moe.init_moe(jax.random.PRNGKey(case["T"]), ref_cfg)
    p = _randomized(p, 6)
    port = _carry(moe.MoE(cfg, device="cpu"), p)
    x2d = np.random.default_rng(case["T"]).normal(size=(case["T"], 64)).astype(np.float32)
    w, idx, aux = moe._route(port, torch.from_numpy(x2d), cfg)
    rw, ridx, raux = ref_moe._route(_jnp(p), jnp.asarray(x2d), ref_cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    _close(w, rw)
    _close(aux, raux)
    cap = moe.moe_capacity(cfg, case["T"])
    assert cap == ref_moe.moe_capacity(ref_cfg, case["T"])
    ts, ws, valid = moe.dispatch(idx, w, case["E"], 0, cap)
    rts, rws, rvalid = _ref_dispatch(ridx, rw, case["E"], 0, cap)
    np.testing.assert_array_equal(ts.numpy(), rts)
    np.testing.assert_array_equal(valid.numpy(), rvalid)
    _close(ws, rws)
    n_routes = case["T"] * case["k"]
    if case.get("clamped"):   # a window starts before its expert's first route
        starts = np.searchsorted(np.sort(np.asarray(ridx).reshape(-1)), np.arange(case["E"]))
        assert (starts > n_routes - cap).any()
    kept = int(valid.sum())
    assert kept <= n_routes
    if case.get("drops"):
        assert kept < n_routes
    y = moe._grouped_expert_ffn(port.wi, port.wg, port.wo, torch.from_numpy(x2d), w, idx, 0,
                                cap, torch.float32)
    ry = ref_moe._grouped_expert_ffn(*(jnp.asarray(p[n]) for n in ("wi", "wg", "wo")),
                                     jnp.asarray(x2d), rw, ridx,
                                     jnp.zeros((), jnp.int32), cap, jnp.float32)
    _close(y, ry)


def test_router_ties_take_the_lowest_expert_id():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    vals, idx = moe.top_k_lowest_ties(probs, 2)
    rvals, ridx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(idx.numpy(), [[1, 2], [0, 1]])


def test_moe_ffn_local_with_shared_experts_matches_reference():
    ref_cfg, cfg = _moe_cfgs(E=8, k=2, shared=1)
    p, _ = ref_moe.init_moe(jax.random.PRNGKey(7), ref_cfg)
    p = _randomized(p, 7)
    assert "shared_wi" in p
    port = _carry(moe.MoE(cfg, device="cpu"), p)
    x = np.random.default_rng(7).normal(size=(2, 16, 64)).astype(np.float32)
    y, aux = moe.moe_ffn_local(port, torch.from_numpy(x), cfg, torch.float32)
    ry, raux = ref_moe.moe_ffn_local(_jnp(p), jnp.asarray(x), ref_cfg, jnp.float32)
    _close(y, ry)
    _close(aux, raux)
    assert float(aux) >= 0.99
