"""Composable decoder stack covering all assigned architecture families —
port of `src/repro/models/transformer.py`: `init_params` (:66),
`abstract_params` (:105), `_embed`, `_apply_layer`, `forward`, `_lm_head`,
`prefill`, `init_cache`, `decode_step` (:121-374). `loss_fn` (:224)
belongs to training.

The model is ``n_periods`` repeated periods; within a period, layers
follow ``cfg.period``:

    layer = x + mixer(norm(x));  x = x + ffn(norm(x))      (ffn optional)

mixers: GQA self-attention (with qkv bias, with a sliding-window ring
buffer), MLA self-attention (with and without q-LoRA), Mamba2-SSD, gated
cross-attention (VLM image layers); ffns: dense SwiGLU or MoE. Audio
models sum one embedding table a codebook and have one head a codebook.

PyTorch's idiom: one `nn.Module` a layer kind, a `Transformer` holding an
`nn.ModuleList` of periods (each an `nn.ModuleList` of `Layer`s). The
reference stacks each period-position's parameters over periods
(``blocks/<pos>/<leaf>[p]``); `params_from_numpy` undoes that stacking.
Caches keep the reference's layout, ``{pos: {"k","v"} | {"ckv","kr"} |
{"mk","mv"} | {"conv","state"}}`` stacked over periods on axis 0;
`decode_step` writes its new entries into the cache tensors passed in (the
reference donates the cache) and returns the same dict.

Two entry points serve (`launch/serve.py`): ``prefill`` (forward returning
last-position logits and caches) and ``decode_step`` (one token against a
cache).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch import device as device_lib
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.utils import tree as tree_lib

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.compute_dtype]


# ---------------------------------------------------------------------------
# modules (init)
# ---------------------------------------------------------------------------
class Layer(nn.Module):
    """`_init_layer` (:40-63): ``ln1``; the mixer (``attn``: GQA, MLA or
    cross; or ``mamba``); then ``ln2`` with ``moe`` or ``mlp`` where the
    layer has an FFN."""

    def __init__(self, spec: LayerSpec, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.ln1 = L.init_rms_norm(cfg.d_model, device)
        if spec.kind == "attn":
            self.attn = (attn_lib.MLAAttention(cfg, **kw) if cfg.attn_type == "mla"
                         else attn_lib.GQAAttention(cfg, **kw))
        elif spec.kind == "cross":
            self.attn = attn_lib.CrossAttention(cfg, **kw)
        elif spec.kind == "mamba":
            self.mamba = ssm_lib.Mamba(cfg, **kw)
        else:
            raise ValueError(spec.kind)
        if cfg.d_ff or spec.moe:
            self.ln2 = L.init_rms_norm(cfg.d_model, device)
            if spec.moe:
                self.moe = moe_lib.MoE(cfg, **kw)
            else:
                self.mlp = L.MLP(cfg.d_model, cfg.d_ff, **kw)


class Transformer(nn.Module):
    """The parameter tree of `init_params` (:66-102) as modules:
    ``periods[p][pos]`` is period p's layer at position pos; ``embed``
    (vocab, d) or (n_q, vocab, d); ``lm_head`` (d, vocab) or (n_q, d,
    vocab), absent when tied; ``media_proj`` (d, d) for vision models;
    ``final_norm``. All float32 (``param_dtype``).

    ``device`` is resolved by `repro_torch.device.resolve` (cuda unless the
    caller asks for cpu) or is ``"meta"`` (shapes only). Without a
    ``generator`` the storage is left uninitialised: `init_params` draws
    it, `params_from_numpy` fills it."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = torch.device("meta") if str(device) == "meta" else device_lib.resolve(device)
        kw = dict(generator=generator, device=dev)
        self.cfg = cfg
        self.periods = nn.ModuleList(
            nn.ModuleList(Layer(spec, cfg, **kw) for spec in cfg.period)
            for _ in range(cfg.n_periods))
        if cfg.n_codebooks:  # audio: one table and one head a codebook
            self.embed = L.normal((cfg.n_codebooks, cfg.vocab_size, cfg.d_model), 0.02,
                                  generator, dev)
            self.lm_head = L.normal((cfg.n_codebooks, cfg.d_model, cfg.vocab_size), 0.02,
                                    generator, dev)
        else:
            self.embed = L.init_embedding(cfg.vocab_size, cfg.d_model, **kw)
            if not cfg.tie_embeddings:
                self.lm_head = L.init_lm_head(cfg.d_model, cfg.vocab_size, **kw)
        if cfg.n_image_tokens:  # vlm projector stub: identity-sized projection
            self.media_proj = L.normal((cfg.d_model, cfg.d_model), 0.02, generator, dev)
        self.final_norm = L.init_rms_norm(cfg.d_model, dev)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Transformer:
    """A model drawn on ``device`` from a `torch.Generator` seeded with
    ``seed``, at the reference's distributions and scales (0.02; output
    projections 0.02/sqrt(2·n_layers); zero biases and gate; ones for the
    norms; Mamba's ``A_log``/``dt_bias``/``D``). Not bit-equal to
    `jax.random`: parity with the reference goes through `params_from_numpy`."""
    dev = device_lib.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return Transformer(cfg, device=dev, generator=gen)


def abstract_params(cfg: ModelConfig) -> Transformer:
    """The model on the meta device: shapes and bytes, nothing allocated
    (`tree.tree_bytes(abstract_params(cfg))`). The reference also returns
    the logical-axis specs, which belong to the sharding slice."""
    return Transformer(cfg, device="meta")


def _reference_paths(model: Transformer) -> dict[str, tuple[tuple[int, ...], list]]:
    """The reference tree's '/'-joined leaf paths, each with its stacked
    shape and the port parameters it fills, in period order."""
    out: dict[str, tuple[tuple[int, ...], list]] = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "periods":
            path = "/".join(["blocks", parts[2], *parts[3:]])
            shape, params = out.setdefault(path, ((model.cfg.n_periods, *p.shape), []))
            params.append(p)
        else:
            out[name] = (tuple(p.shape), [p])
    return out


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> Transformer:
    """The port's model from the reference's parameter tree as numpy
    float32 arrays (as ``jax.device_get(init_params(cfg, key)[0])`` gives
    it): ``blocks/<pos>/<leaf>[p]`` goes to period p's layer at position
    pos. Raises ValueError on a missing leaf, an extra leaf, a wrong shape
    or a dtype other than float32, before anything is allocated."""
    given = {path: np.asarray(leaf) for path, leaf in tree_lib.tree_paths(tree)}
    want = _reference_paths(abstract_params(cfg))
    missing, extra = sorted(set(want) - set(given)), sorted(set(given) - set(want))
    if missing or extra:
        raise ValueError(f"{cfg.name}: parameter tree mismatch: missing {missing}, extra {extra}")
    for path, (shape, _) in want.items():
        arr = given[path]
        if arr.dtype != np.float32:
            raise ValueError(f"{cfg.name}: {path} is {arr.dtype}, not float32")
        if tuple(arr.shape) != shape:
            raise ValueError(f"{cfg.name}: {path} has shape {tuple(arr.shape)}, want {shape}")
    model = Transformer(cfg, device=device)
    with torch.no_grad():
        for path, (_, params) in _reference_paths(model).items():
            src = torch.from_numpy(np.require(given[path], requirements=["C", "W"]))
            if path.startswith("blocks/"):
                src = src.to(model.device)
                for p, param in enumerate(params):
                    param.copy_(src[p])
            else:
                params[0].copy_(src)
    return model


def params_to_numpy(model: Transformer) -> dict:
    """The inverse of `params_from_numpy`: the model's parameters as the
    reference's tree of numpy float32 arrays, stacked over periods."""
    out: dict = {}
    for path, (_, params) in _reference_paths(model).items():
        arrs = [p.detach().cpu().numpy() for p in params]
        node = out
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = np.stack(arrs) if path.startswith("blocks/") else arrs[0]
    return out


def init_cache_from_numpy(tree: dict, device="cuda") -> dict:
    """A cache in the port from the reference's cache (``{pos: {leaf:
    array}}``, stacked over periods) as numpy float32 arrays. Raises
    ValueError on any other dtype."""
    dev = device_lib.resolve(device)
    out: dict = {}
    for pos, leaves in tree.items():
        out[pos] = {}
        for name, arr in leaves.items():
            arr = np.asarray(arr)
            if arr.dtype != np.float32:
                raise ValueError(f"cache {pos}/{name} is {arr.dtype}, not float32")
            out[pos][name] = torch.from_numpy(np.require(arr, requirements=["C", "W"])).to(dev)
    return out


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------
def _embed(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig, dtype) -> torch.Tensor:
    if cfg.n_codebooks:
        # tokens (B, S, n_q): codebook embeddings summed in float32, then cast
        embs = [params.embed[q][tokens[..., q]] for q in range(cfg.n_codebooks)]
        return sum(embs).to(dtype)
    return params.embed[tokens].to(dtype)


def _ffn(lp: Layer, spec: LayerSpec, x, cfg: ModelConfig, dtype):
    """The layer's FFN residual, x + ffn(norm(x)), and the router's aux."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if hasattr(lp, "mlp") or hasattr(lp, "moe"):
        h = L.rms_norm(x, lp.ln2, cfg.norm_eps)
        if spec.moe:
            y, aux = moe_lib.moe_ffn_local(lp.moe, h, cfg, dtype)
        else:
            y = L.mlp(lp.mlp, h, dtype)
        x = x + y
    return x, aux


def _apply_layer(lp: Layer, spec: LayerSpec, x, positions, media, cfg: ModelConfig, dtype,
                 collect_cache: bool):
    cache_out = {}
    h = L.rms_norm(x, lp.ln1, cfg.norm_eps)
    if spec.kind == "attn":
        if cfg.attn_type == "mla":
            o, (ckv, kr) = attn_lib.mla_attend_full(lp.attn, h, positions, cfg, dtype,
                                                    cfg.attn_chunk)
            if collect_cache:
                cache_out = {"ckv": ckv, "kr": kr}
        else:
            q, k, v = attn_lib.gqa_qkv(lp.attn, h, positions, cfg, dtype)
            o = attn_lib.blockwise_attention(
                q, k, v, causal=True, kv_chunk=cfg.attn_chunk,
                q_chunk=min(cfg.attn_chunk, 1024),
                triangular=cfg.triangular_attention,
                window=spec.sliding_window,
            )
            o = attn_lib.gqa_out(lp.attn, o, dtype)
            if collect_cache:
                cache_out = {"k": k, "v": v}
    elif spec.kind == "cross":
        o = attn_lib.cross_attend(lp.attn, h, media, cfg, dtype)
        if collect_cache:
            mk = torch.einsum("bmd,dhk->bmhk", media, lp.attn.wk.to(dtype))
            mv = torch.einsum("bmd,dhk->bmhk", media, lp.attn.wv.to(dtype))
            cache_out = {"mk": mk, "mv": mv}
    else:  # mamba
        o, ssm_cache = ssm_lib.mamba_forward(lp.mamba, h, cfg, dtype)
        if collect_cache:
            cache_out = {"conv": ssm_cache.conv, "state": ssm_cache.state}
    x = x + o
    x, aux = _ffn(lp, spec, x, cfg, dtype)
    return x, aux, cache_out


def forward(params: Transformer, tokens: torch.Tensor, *, media: torch.Tensor | None = None,
            return_cache: bool = False):
    """Full-sequence forward. Returns (hidden (B,S,D), aux, cache|None); the
    cache's leaves are stacked over periods on axis 0. ``media`` is
    projected by ``media_proj`` here (prefill's cross caches are
    projections of the projected media)."""
    cfg = params.cfg
    dtype = _dtype(cfg)
    x = _embed(params, tokens, cfg, dtype)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    if media is not None and hasattr(params, "media_proj"):
        media = torch.einsum("bmd,de->bme", media.to(dtype), params.media_proj.to(dtype))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches: dict = {}
    for p, period in enumerate(params.periods):
        for pos, spec in enumerate(cfg.period):
            x, a, c = _apply_layer(period[pos], spec, x, positions, media, cfg, dtype,
                                   return_cache)
            aux = aux + a
            for name, leaf in c.items():
                stacked = caches.setdefault(str(pos), {})
                if name not in stacked:   # one buffer a leaf, stacked over periods
                    stacked[name] = torch.empty((cfg.n_periods, *leaf.shape), dtype=leaf.dtype,
                                                device=leaf.device)
                stacked[name][p] = leaf
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return x, aux / cfg.n_layers, (caches if return_cache else None)


def _lm_head(params: Transformer, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params.embed.T
    return params.lm_head


def logits_of(params: Transformer, h: torch.Tensor) -> torch.Tensor:
    """Logits of hidden states h (B, S, D) in h's dtype: (B, S, vocab), or
    (B, S, n_q, vocab) with codebooks (``einsum("bsd,qdv->bsqv")``)."""
    head = _lm_head(params, params.cfg).to(h.dtype)
    if params.cfg.n_codebooks:
        return torch.einsum("bsd,qdv->bsqv", h, head)
    return torch.einsum("bsd,dv->bsv", h, head)


def prefill(params: Transformer, tokens: torch.Tensor, *, media: torch.Tensor | None = None):
    """Forward with caches; returns (last-position logits, cache)."""
    h, _, cache = forward(params, tokens, media=media, return_cache=True)
    return logits_of(params, h[:, -1:]), cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype=None, device="cuda") -> dict:
    """Empty fixed-size decode cache (leaves stacked over periods); a
    sliding-window layer keeps min(seq_len, window) slots (a ring)."""
    dev = device_lib.resolve(device)
    dtype = dtype or _dtype(cfg)
    np_, cache = cfg.n_periods, {}
    z = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=dev)
    for pos, spec in enumerate(cfg.period):
        if spec.kind == "attn":
            S_eff = min(seq_len, spec.sliding_window) if spec.sliding_window else seq_len
            if cfg.attn_type == "mla":
                c = {"ckv": z(np_, batch, S_eff, cfg.kv_lora_rank),
                     "kr": z(np_, batch, S_eff, cfg.rope_head_dim)}
            else:
                c = {"k": z(np_, batch, S_eff, cfg.n_kv_heads, cfg.head_dim),
                     "v": z(np_, batch, S_eff, cfg.n_kv_heads, cfg.v_head_dim)}
        elif spec.kind == "cross":
            c = {"mk": z(np_, batch, cfg.n_image_tokens, cfg.n_kv_heads, cfg.head_dim),
                 "mv": z(np_, batch, cfg.n_image_tokens, cfg.n_kv_heads, cfg.v_head_dim)}
        else:
            c = {"conv": z(np_, batch, cfg.ssm_conv_width - 1, ssm_lib.conv_dim(cfg)),
                 "state": z(np_, batch, cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_d_state,
                            dt=torch.float32)}
        cache[str(pos)] = c
    return cache


def decode_step(params: Transformer, cache: dict, tokens: torch.Tensor, pos):
    """One decode step: tokens (B, 1) (or (B, 1, n_q)); ``pos`` (an int or a
    0-d tensor) the absolute position being written. Attends over pos+1
    cache entries (a sliding-window layer over its ring: slot pos % buf,
    min(pos+1, buf) entries). Writes the step's entries into ``cache`` in
    place; returns (logits, cache)."""
    cfg = params.cfg
    dtype = _dtype(cfg)
    pos = int(pos)
    x = _embed(params, tokens, cfg, dtype)
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    length = pos + 1
    for p, period in enumerate(params.periods):
        for lpos, spec in enumerate(cfg.period):
            lp, c = period[lpos], cache[str(lpos)]
            h = L.rms_norm(x, lp.ln1, cfg.norm_eps)
            if spec.kind == "attn":
                if cfg.attn_type == "mla":
                    ckv_new, kr_new = attn_lib.mla_compress(lp.attn, h, positions, cfg, dtype)
                    c["ckv"][p, :, pos] = ckv_new[:, 0]
                    c["kr"][p, :, pos] = kr_new[:, 0]
                    o = attn_lib.mla_decode(lp.attn, h, c["ckv"][p], c["kr"][p], length,
                                            positions, cfg, dtype)
                else:
                    q, k, v = attn_lib.gqa_qkv(lp.attn, h, positions, cfg, dtype)
                    buf = c["k"].shape[2]
                    if spec.sliding_window and spec.sliding_window <= buf:
                        # ring buffer: slot = pos mod window; every slot valid
                        # once wrapped (each entry lies within the window)
                        slot, eff_len = pos % buf, min(length, buf)
                    else:
                        slot, eff_len = pos, length
                    c["k"][p, :, slot] = k[:, 0]
                    c["v"][p, :, slot] = v[:, 0]
                    o = attn_lib.decode_attend(q[:, 0], c["k"][p], c["v"][p], eff_len)[:, None]
                    o = attn_lib.gqa_out(lp.attn, o, dtype)
            elif spec.kind == "cross":
                q = torch.einsum("bsd,dhk->bshk", h, lp.attn.wq.to(dtype))[:, 0]
                o = attn_lib.decode_attend(q, c["mk"][p], c["mv"][p], c["mk"].shape[2])[:, None]
                o = attn_lib.gqa_out(lp.attn, o, dtype)
                o = torch.tanh(lp.attn.gate).to(dtype) * o
            else:
                o, ssm_c = ssm_lib.mamba_decode(
                    lp.mamba, h, ssm_lib.SSMCache(conv=c["conv"][p], state=c["state"][p]),
                    cfg, dtype)
                c["conv"][p] = ssm_c.conv
                c["state"][p] = ssm_c.state
            x = x + o
            x, _ = _ffn(lp, spec, x, cfg, dtype)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return logits_of(params, x), cache
