"""The LM stack's serving path in the port against the reference, on the
CPU: `models/transformer.py` (`forward`, `prefill`, `init_cache`,
`decode_step`, `abstract_params`, the carry-over `params_from_numpy` /
`init_cache_from_numpy`), `utils/tree.py` and `launch/serve.py`
(`make_prefill_step`, `make_decode_step`, `cache_from_prefill`) of
`repro_torch` against `repro`.

Every config of `ARCH_IDS` and `yi-34b-swa` runs at `reduced()` width
(fp32 compute): the reference's `init_params` draws the weights, the
zero- and one-initialised leaves (norm scales, qkv biases, the cross gate,
`conv_b`, `D`) are randomised, and the same numpy tree goes to both
packages. `forward`, the prefill's logits and caches, and 4 decode steps'
logits and caches agree within 1e-5 abs + 1e-5 rel (einsums summed in
other orders); MoE configs route and drop alike (the ids and masks are
held exactly in `tests/test_torch_lm_layers.py`).
"""
import dataclasses
import functools

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import registry as ref_registry  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import config as ref_mc  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.models.config import LayerSpec as RefLayerSpec  # noqa: E402
from repro.utils import tree as ref_tree  # noqa: E402
from repro_torch import device as device_lib  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import config as mc  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.config import LayerSpec  # noqa: E402
from repro_torch.utils import tree  # noqa: E402

device_lib.settle_cpu()
TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = registry.ARCH_IDS + ["yi-34b-swa"]
PREFILL, STEPS = 8, 4


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=err_msg, **TOL)


def _randomized(params, seed):
    """The reference's parameter tree as numpy float32, every all-zero or
    all-one leaf replaced by random values around it."""
    rng = np.random.default_rng(seed)

    def one(a):
        a = np.asarray(a, np.float32)
        if np.all(a == 0) or np.all(a == 1):
            a = (a + rng.normal(0, 0.3, a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map(one, jax.device_get(params))


def _configs(arch, **kw):
    ref = ref_mc.reduced(ref_registry.get_config(arch), **kw)
    port = mc.reduced(registry.get_config(arch), **kw)
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    return ref, port


def _inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
    tokens = rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32)
    media = (rng.normal(0, 0.5, (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
             if cfg.n_image_tokens else None)
    return tokens, media


def _ref_splice(cfg, cache, B, seq_len):
    """The reference test's splice (`tests/test_models_smoke.py:118-129`)."""
    sized = ref_tf.init_cache(cfg, B, seq_len)
    for pos_key, c in cache.items():
        for k, v in c.items():
            buf = sized[pos_key][k]
            if k in ("mk", "mv", "conv", "state"):
                sized[pos_key][k] = v.astype(buf.dtype)
            else:
                sized[pos_key][k] = jax.lax.dynamic_update_slice(
                    buf, v.astype(buf.dtype), (0,) * buf.ndim)
    return sized


def _close_cache(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for pos in want:
        assert set(got[pos]) == set(want[pos]), (what, pos)
        for name in want[pos]:
            assert tuple(got[pos][name].shape) == tuple(want[pos][name].shape), (what, pos, name)
            _close(got[pos][name], want[pos][name], f"{what} {pos}/{name}")


@functools.cache
def _ref_decode(ref_cfg):
    return jax.jit(lambda p, c, t, pos: ref_tf.decode_step(p, c, t, pos, ref_cfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_path_matches_reference(arch):
    """forward, prefill (logits and caches) and 4 decode steps (logits and
    caches), through `make_prefill_step` / `make_decode_step` on the CPU.
    Where trouble was likely: musicgen's codebook embeddings are summed in
    fp32, then cast (`transformer.py:121-128`), its logits
    ``einsum("bsd,qdv->bsqv")``; the vision config's cross gate and its
    norm scales run randomised (a zero gate would hold nothing), and
    qwen's qkv biases likewise."""
    ref_cfg, cfg = _configs(arch)
    ref_params, _ = ref_tf.init_params(ref_cfg, jax.random.PRNGKey(1))
    tree_np = _randomized(ref_params, 1)
    ref_params = jax.tree_util.tree_map(jnp.asarray, tree_np)
    model = transformer.params_from_numpy(tree_np, cfg, device="cpu")
    B, S = 2, PREFILL + STEPS
    tokens, media = _inputs(cfg, B, S, 2)
    tmedia = None if media is None else torch.from_numpy(media)
    jmedia = None if media is None else jnp.asarray(media)

    with torch.no_grad():
        h, aux, _ = transformer.forward(model, torch.from_numpy(tokens), media=tmedia)
    rh, raux, _ = jax.jit(lambda p, t, m: ref_tf.forward(p, t, ref_cfg, media=m))(
        ref_params, jnp.asarray(tokens), jmedia)
    _close(h, rh, "forward hidden")
    _close(aux, raux, "forward aux")

    batch = {"tokens": torch.from_numpy(tokens[:, :PREFILL])}
    ref_batch = {"tokens": jnp.asarray(tokens[:, :PREFILL])}
    if media is not None:
        batch["media"], ref_batch["media"] = tmedia, jmedia
    logits, pcache = serve.make_prefill_step(cfg, device="cpu")(model, batch)
    rlogits, rpcache = ref_serve.make_prefill_step(ref_cfg, None)(ref_params, ref_batch)
    _close(logits, rlogits, "prefill logits")
    _close_cache(pcache, rpcache, "prefill cache")

    cache = serve.cache_from_prefill(cfg, pcache, S, device="cpu")
    rcache = _ref_splice(ref_cfg, rpcache, B, S)
    _close_cache(cache, rcache, "spliced cache")
    step, rstep = serve.make_decode_step(cfg, device="cpu"), _ref_decode(ref_cfg)
    for t in range(PREFILL, S):
        tok = tokens[:, t:t + 1]
        logits, out = step(model, cache, torch.from_numpy(tok), t)
        assert out is cache                          # written in place
        rlogits, rcache = rstep(ref_params, rcache, jnp.asarray(tok), jnp.asarray(t, jnp.int32))
        _close(logits, rlogits, f"decode logits at {t}")
        _close_cache(cache, rcache, f"decode cache at {t}")
    vshape = (B, 1, cfg.n_codebooks, cfg.vocab_size) if cfg.n_codebooks else (B, 1, cfg.vocab_size)
    assert logits.shape == vshape and torch.isfinite(logits).all()


def test_sliding_window_ring_past_its_wrap():
    """The ring (`transformer.py:322-331`): slot pos % buf, eff_len =
    min(pos+1, buf); `init_cache` keeps min(seq_len, window) slots (:266).
    20 positions through a window of 8 wrap twice; every step's logits and
    ring equal the reference's, and the last is the banded forward's."""
    ref_cfg, cfg = _configs("yi-34b", attn_chunk=512)
    ref_cfg = dataclasses.replace(ref_cfg, period=(RefLayerSpec(kind="attn", sliding_window=8),))
    cfg = dataclasses.replace(cfg, period=(LayerSpec(kind="attn", sliding_window=8),))
    tree_np = _randomized(ref_tf.init_params(ref_cfg, jax.random.PRNGKey(0))[0], 3)
    ref_params = jax.tree_util.tree_map(jnp.asarray, tree_np)
    model = transformer.params_from_numpy(tree_np, cfg, device="cpu")
    B, S = 1, 20
    tokens, _ = _inputs(cfg, B, S, 0)
    cache = transformer.init_cache(cfg, B, S, device="cpu")
    rcache = ref_tf.init_cache(ref_cfg, B, S)
    assert cache["0"]["k"].shape[2] == 8 == rcache["0"]["k"].shape[2]
    rstep = _ref_decode(ref_cfg)
    with torch.no_grad():
        for t in range(S):
            tok = torch.from_numpy(tokens[:, t:t + 1])
            logits, cache = transformer.decode_step(model, cache, tok, t)
            rlogits, rcache = rstep(ref_params, rcache, jnp.asarray(tokens[:, t:t + 1]),
                                    jnp.asarray(t, jnp.int32))
            _close(logits, rlogits, f"ring logits at {t}")
            _close_cache(cache, rcache, f"ring at {t}")
        h, _, _ = transformer.forward(model, torch.from_numpy(tokens))
        full = transformer.logits_of(model, h[:, -1:])
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=5e-3, atol=5e-4)


def test_vision_cache_splice_and_decode():
    """`test_vlm_cross_cache_decode`: prefill's cross caches are projections
    of the projected media (`transformer.py:156-160`, `media_proj` in
    `forward` only, :193-194), spliced into a longer cache, then decoded."""
    ref_cfg, cfg = _configs("llama-3.2-vision-90b")
    tree_np = _randomized(ref_tf.init_params(ref_cfg, jax.random.PRNGKey(3))[0], 4)
    ref_params = jax.tree_util.tree_map(jnp.asarray, tree_np)
    model = transformer.params_from_numpy(tree_np, cfg, device="cpu")
    B, S = 1, 10
    tokens, media = _inputs(cfg, B, S, 1)
    logits, pcache = serve.make_prefill_step(cfg, device="cpu")(
        model, {"tokens": torch.from_numpy(tokens), "media": torch.from_numpy(media)})
    rlogits, rpcache = ref_tf.prefill(ref_params, jnp.asarray(tokens), ref_cfg,
                                      media=jnp.asarray(media))
    _close(logits, rlogits)
    proj = torch.einsum("bmd,de->bme", torch.from_numpy(media), model.media_proj.detach())
    mk = torch.einsum("bmd,dhk->bmhk", proj, model.periods[1][0].attn.wk.detach())
    _close(pcache["0"]["mk"][1], mk)
    cache = serve.cache_from_prefill(cfg, pcache, S + 4, device="cpu")
    rcache = _ref_splice(ref_cfg, rpcache, B, S + 4)
    _close_cache(cache, rcache, "spliced")
    logits, cache = serve.make_decode_step(cfg, device="cpu")(
        model, cache, torch.from_numpy(tokens[:, -1:]), S)
    rlogits, rcache = ref_tf.decode_step(ref_params, rcache, jnp.asarray(tokens[:, -1:]),
                                         jnp.asarray(S, jnp.int32), ref_cfg)
    _close(logits, rlogits)
    _close_cache(cache, rcache, "after decode")


def test_reference_cache_carries_over():
    """`init_cache_from_numpy`: a reference cache carried across decodes
    as the reference does from it."""
    ref_cfg, cfg = _configs("jamba-1.5-large-398b")
    tree_np = _randomized(ref_tf.init_params(ref_cfg, jax.random.PRNGKey(5))[0], 5)
    ref_params = jax.tree_util.tree_map(jnp.asarray, tree_np)
    model = transformer.params_from_numpy(tree_np, cfg, device="cpu")
    tokens, _ = _inputs(cfg, 2, 7, 5)
    _, rpcache = ref_tf.prefill(ref_params, jnp.asarray(tokens[:, :6]), ref_cfg)
    rcache = _ref_splice(ref_cfg, rpcache, 2, 9)
    cache = transformer.init_cache_from_numpy(jax.device_get(rcache), device="cpu")
    _close_cache(cache, rcache, "carried")
    with torch.no_grad():
        logits, cache = transformer.decode_step(model, cache, torch.from_numpy(tokens[:, 6:7]), 6)
    rlogits, rcache = ref_tf.decode_step(ref_params, rcache, jnp.asarray(tokens[:, 6:7]),
                                         jnp.asarray(6, jnp.int32), ref_cfg)
    _close(logits, rlogits)
    _close_cache(cache, rcache, "decoded")
    bad = jax.device_get(rcache)
    bad["0"]["conv"] = bad["0"]["conv"].astype(np.float64)
    with pytest.raises(ValueError, match="float32"):
        transformer.init_cache_from_numpy(bad, device="cpu")


def test_carry_over_round_trip_and_refusals():
    """The carry-over undoes the stacking over periods (and
    `params_to_numpy` redoes it, bit for bit); it refuses a missing leaf,
    an extra leaf, a wrong shape and a dtype other than float32."""
    ref_cfg, cfg = _configs("deepseek-v2-lite-16b")
    tree_np = jax.device_get(ref_tf.init_params(ref_cfg, jax.random.PRNGKey(0))[0])
    model = transformer.params_from_numpy(tree_np, cfg, device="cpu")
    assert model.periods[1][0].moe.wi.shape == tree_np["blocks"]["0"]["moe"]["wi"].shape[1:]
    np.testing.assert_array_equal(model.periods[1][0].moe.wi.detach().numpy(),
                                  tree_np["blocks"]["0"]["moe"]["wi"][1])
    back = transformer.params_to_numpy(model)
    assert ([p for p, _ in tree.tree_paths(back)]
            == [p for p, _ in ref_tree.tree_paths(tree_np)])
    for (path, got), (_, want) in zip(tree.tree_paths(back), ref_tree.tree_paths(tree_np)):
        np.testing.assert_array_equal(got, want, err_msg=path)
    missing = jax.tree_util.tree_map(lambda a: a, tree_np)
    del missing["blocks"]["0"]["moe"]["shared_wo"]
    with pytest.raises(ValueError, match="missing.*shared_wo"):
        transformer.params_from_numpy(missing, cfg, device="cpu")
    extra = jax.tree_util.tree_map(lambda a: a, tree_np)
    extra["blocks"]["0"]["attn"]["bq"] = np.zeros((4, 64), np.float32)
    with pytest.raises(ValueError, match="extra.*bq"):
        transformer.params_from_numpy(extra, cfg, device="cpu")
    shape = jax.tree_util.tree_map(lambda a: a, tree_np)
    shape["blocks"]["0"]["attn"]["wq"] = shape["blocks"]["0"]["attn"]["wq"][:1]
    with pytest.raises(ValueError, match="shape"):
        transformer.params_from_numpy(shape, cfg, device="cpu")
    dtype = jax.tree_util.tree_map(lambda a: a, tree_np)
    dtype["embed"] = dtype["embed"].astype(np.float64)
    with pytest.raises(ValueError, match="float32"):
        transformer.params_from_numpy(dtype, cfg, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_reference_at_full_width(arch):
    """The meta-device model has the reference's leaves, shapes and bytes
    at the published widths; nothing is allocated."""
    ref_shapes, _ = ref_tf.abstract_params(ref_registry.get_config(arch))
    meta = transformer.abstract_params(registry.get_config(arch))
    assert all(p.device.type == "meta" for p in meta.parameters())
    want = {path: tuple(leaf.shape) for path, leaf in ref_tree.tree_paths(ref_shapes)}
    got = {path: shape for path, (shape, _) in transformer._reference_paths(meta).items()}
    assert got == want
    assert tree.tree_bytes(meta) == ref_tree.tree_bytes(ref_shapes)
    assert tree.tree_size(meta) == ref_tree.tree_size(ref_shapes)


def test_tree_utilities_match_reference():
    rng = np.random.default_rng(0)
    t = {"b": {"y": rng.normal(size=(3, 2)).astype(np.float32), "x": np.arange(4, dtype=np.int32)},
         "a": [rng.normal(size=5).astype(np.float32)]}
    tt = tree.tree_map(torch.from_numpy, t)
    jt = jax.tree_util.tree_map(jnp.asarray, t)
    assert [p for p, _ in tree.tree_paths(tt)] == [p for p, _ in ref_tree.tree_paths(jt)]
    assert tree.tree_size(tt) == ref_tree.tree_size(jt)
    assert tree.tree_bytes(tt) == ref_tree.tree_bytes(jt)
    _close(tree.global_norm(tree.tree_cast(tt, torch.float32)),
           ref_tree.global_norm(ref_tree.tree_cast(jt, jnp.float32)))
    doubled = tree.tree_add(tt, tree.tree_scale(tt, 1))
    np.testing.assert_array_equal(doubled["b"]["y"].numpy(), 2 * t["b"]["y"])
    assert float(tree.tree_zeros_like(tt)["a"][0].abs().sum()) == 0.0
    assert tree.tree_cast(tt, torch.float16)["b"]["x"].dtype == torch.int32


def test_steps_refuse_another_model():
    cfg = mc.reduced(registry.get_config("qwen1.5-4b"))
    other = mc.reduced(registry.get_config("minitron-4b"))
    model = transformer.init_params(cfg, seed=0, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="minitron"):
        serve.make_prefill_step(other, device="cpu")(model, {"tokens": tokens})
    meta = transformer.abstract_params(cfg)
    with pytest.raises(ValueError, match="meta"):
        serve.make_prefill_step(cfg, device="cpu")(meta, {"tokens": tokens})
    cache = transformer.init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="minitron"):
        serve.make_decode_step(other, device="cpu")(model, cache, tokens[:, :1], 0)
